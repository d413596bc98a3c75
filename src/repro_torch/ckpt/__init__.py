"""Async, atomic checkpointing of the port, in the reference's on-disk format."""
from .checkpoint import CheckpointManager, latest_step, restore_pytree, save_pytree

__all__ = ["CheckpointManager", "latest_step", "restore_pytree", "save_pytree"]
