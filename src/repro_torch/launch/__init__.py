"""Launchers: the training entry point, its mesh and FT supervisor."""
