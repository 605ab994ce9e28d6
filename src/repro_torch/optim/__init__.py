"""Optimizer: AdamW with float32 master weights, int8 gradient
compression."""
