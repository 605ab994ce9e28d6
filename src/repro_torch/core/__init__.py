"""Curves, index construction, CPU engine and device serving (torch)."""
