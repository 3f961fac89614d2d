"""Dataset writing and metadata."""
