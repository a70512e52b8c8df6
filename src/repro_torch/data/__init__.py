"""Synthetic camera streams with ground truth (``camera``), and the host
data pipeline (``pipeline``): training batches, prefetch, straggler
hedging and camera batches."""
