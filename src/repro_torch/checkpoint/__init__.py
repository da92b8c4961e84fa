"""Checkpoints of the port: npz shards, a JSON index with CRC32s, an atomic
commit (``checkpointer``), and resume / restart on top (``manager``)."""
from .checkpointer import (AsyncCheckpointer, committed_steps, is_valid,
                           read_extra, restore, save, valid_steps)
from .manager import CheckpointManager

__all__ = ["AsyncCheckpointer", "CheckpointManager", "committed_steps",
           "is_valid", "read_extra", "restore", "save", "valid_steps"]
