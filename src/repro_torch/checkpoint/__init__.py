"""Checkpointing of the port."""
from .manager import CheckpointManager  # noqa: F401
