"""Monotone-curve encode of (n, d) points into Z64 addresses."""
