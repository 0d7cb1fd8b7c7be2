"""Utilities: evaluation metrics."""
