"""Synthetic datasets and query workloads (numpy)."""
