"""Atomic step-addressed checkpoints in the JAX package's file format."""
from .checkpoint import latest_step, restore, restore_latest, save

__all__ = ["save", "restore", "restore_latest", "latest_step"]
