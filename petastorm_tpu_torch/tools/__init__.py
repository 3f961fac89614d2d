"""Command-line store tools."""
