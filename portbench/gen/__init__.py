"""Frozen copies of the data and window generators."""
