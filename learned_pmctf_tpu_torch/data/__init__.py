"""Datasets and the input pipeline (numpy and PIL, thread-prefetched)."""
