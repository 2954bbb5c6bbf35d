"""Modules and model assembly of the detect path."""
