"""CheckpointManager: resume / restart on top of the checkpointer (port of
``repro.checkpoint.manager``).

Train loops use only this class:
    mgr = CheckpointManager(dir, keep_n=3, interval=100)
    state, start_step = mgr.restore_or_init(init_fn)
    ...
    mgr.maybe_save(step, state)     # async, every ``interval`` steps
    mgr.finalize(step, state)       # synchronous flush at exit

The serving pool (``launch/batcher.py`` snapshots) uses the synchronous
``save_now`` / ``read_extra`` pair: a snapshot must be durable before the
segment that follows it, and it carries a JSON sidecar (queue and per-row
metadata) beside the device state.

``latest_step`` only returns a checkpoint that passes the integrity
manifest (``checkpointer.is_valid``): a crash during a save can leave a
committed but truncated directory, which is skipped and removed here so
that it never shadows an older restorable step.
"""
from __future__ import annotations

import os
import shutil
from typing import Any, Callable, Optional

from .checkpointer import (AsyncCheckpointer, committed_steps, is_valid,
                           read_extra, restore, save)


class CheckpointManager:
    def __init__(self, directory: str, *, keep_n: int = 3,
                 interval: int = 100):
        self.directory = directory
        self.interval = interval
        self.async_ckpt = AsyncCheckpointer(directory, keep_n=keep_n)

    def latest_step(self) -> Optional[int]:
        """Newest restorable step; corrupt or truncated committed
        directories are skipped and removed (they would fail restore)."""
        latest = None
        for step in committed_steps(self.directory):
            if is_valid(self.directory, step):
                latest = step
            else:
                shutil.rmtree(
                    os.path.join(self.directory, f"step_{step:08d}"),
                    ignore_errors=True)
        return latest

    def restore_or_init(self, init_fn: Callable[[], Any],
                        shardings: Any = None) -> tuple[Any, int]:
        """Resume from the latest committed checkpoint, else a fresh
        ``init_fn()``; returns ``(state, step)``.  Re-sharding onto the
        *current* mesh happens here (``shardings``: the elastic restart)."""
        step = self.latest_step()
        template = init_fn()
        if step is None:
            return template, 0
        return restore(self.directory, step, template, shardings), step

    def maybe_save(self, step: int, state: Any):
        if self.interval and step % self.interval == 0 and step > 0:
            self.async_ckpt.save_async(step, state)

    def save_now(self, step: int, state: Any,
                 extra: Optional[dict] = None) -> str:
        """Synchronous save (serving snapshots: durability before the next
        segment matters more than hiding the write)."""
        self.async_ckpt.wait()
        return save(self.directory, step, state, extra=extra)

    def read_extra(self, step: int, name: str) -> bytes:
        return read_extra(self.directory, step, name)

    def finalize(self, step: int, state: Any):
        self.async_ckpt.wait()
        self.async_ckpt.save_async(step, state)
        self.async_ckpt.wait()
