"""Command-line store tools and the environment doctor."""
