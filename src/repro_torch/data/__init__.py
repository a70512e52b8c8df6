"""Synthetic camera streams with ground truth."""
