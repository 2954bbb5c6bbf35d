"""The predict entry point and its results."""
