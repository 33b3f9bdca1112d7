"""Checkpoints of the port (``repro.ckpt``' counterpart, same files and keys)."""
from .manager import CheckpointManager

__all__ = ["CheckpointManager"]
