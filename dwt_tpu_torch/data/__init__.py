"""Data: the in-memory dataset, the target-view transforms and batching."""
