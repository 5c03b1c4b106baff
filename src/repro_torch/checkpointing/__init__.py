"""Checkpoint / restart of the LM trainer (``ckpt.py``)."""
from .ckpt import CheckpointManager, save_checkpoint, restore_checkpoint, latest_step  # noqa: F401
