"""Checkpoints: one .npy per leaf + manifest, the reference's format."""
