"""Models that consume the loader's batches."""
