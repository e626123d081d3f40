"""Image data transforms."""
