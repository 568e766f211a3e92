"""Parallelism of the PyTorch port (plain attention only, so far)."""
