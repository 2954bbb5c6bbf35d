"""Optimizer construction for the training step."""
