"""Synthetic camera streams with ground truth (``camera``), and the host
data pipeline of training (``pipeline``)."""
