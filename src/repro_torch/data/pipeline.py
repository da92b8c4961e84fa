"""Sharded, prefetched host data pipeline (port of
``repro.data.pipeline``).

* per-host sharding: each process draws only its slice of the global batch
  (deterministic in (seed, step, host));
* background prefetch so the input pipeline never stalls the step;
* device placement: :func:`torch_placer` (one device), and
  :func:`device_placer` (the reference's name: DTensors placed by the
  batch specs on a mesh) over :func:`mesh_placer` (the same by DTensor
  placements).
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, Optional

import numpy as np
import torch


def _process_index_count() -> tuple[int, int]:
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        return torch.distributed.get_rank(), torch.distributed.get_world_size()
    return 0, 1


class HostShardedSource:
    """Wrap a (seed, step)-deterministic generator factory into a per-host
    sharded source: global batch B -> this host's B/num_hosts rows."""

    def __init__(self, make_gen: Callable[[int, int], Iterator[dict]],
                 global_batch: int, *, process_index: Optional[int] = None,
                 process_count: Optional[int] = None, start_step: int = 0):
        pi, pc = _process_index_count()
        self.pi = pi if process_index is None else process_index
        self.pc = pc if process_count is None else process_count
        if global_batch % self.pc:
            raise ValueError(f"global batch {global_batch} does not split "
                             f"over {self.pc} hosts")
        self.local_batch = global_batch // self.pc
        self.gen = make_gen(self.local_batch, start_step * self.pc + self.pi)
        self.step = start_step

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        batch = next(self.gen)
        self.step += 1
        return batch


class Prefetcher:
    """Background-thread double buffering (depth configurable)."""

    def __init__(self, source: Iterator[dict], depth: int = 2,
                 place: Optional[Callable[[dict], dict]] = None):
        self.source = source
        self.place = place or (lambda x: x)
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._worker, daemon=True)
        self.thread.start()

    def _worker(self):
        try:
            for item in self.source:
                if self._stop.is_set():
                    return
                self.q.put(self.place(item))
        except Exception as e:  # surface errors to the consumer
            self.q.put(e)

    def __iter__(self):
        return self

    def __next__(self):
        item = self.q.get()
        if isinstance(item, Exception):
            raise item
        return item

    def close(self):
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass


def torch_placer(device) -> Callable[[dict], dict]:
    """A callable moving a host numpy batch onto ``device``: integer
    arrays as int64 (token ids), float arrays as float32."""
    dev = torch.device(device)

    def place(batch: dict) -> dict:
        out = {}
        for k, v in batch.items():
            a = np.asarray(v)
            dtype = torch.int64 if a.dtype.kind in "iu" else torch.float32
            out[k] = torch.from_numpy(a).to(device=dev, dtype=dtype)
        return out
    return place


def mesh_placer(mesh, batch_placements: dict) -> Callable[[dict], dict]:
    """A callable placing a host numpy batch on ``mesh`` as DTensors with
    ``batch_placements`` (key -> placements, ``launch/steps.py:
    batch_struct``).  Every rank holds the whole global batch (the same
    rows the meshless run draws, so losses compare) and keeps its own
    slice, without communication.  The rank's own card is named here: a
    prefetch thread does not inherit the caller's current CUDA device."""
    from torch.distributed.tensor import distribute_tensor
    dev = torch.device(mesh.device_type)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    place_local = torch_placer(dev)

    def place(batch: dict) -> dict:
        return {k: distribute_tensor(v, mesh, batch_placements[k],
                                     src_data_rank=None)
                for k, v in place_local(batch).items()}
    return place


def device_placer(mesh, batch_specs: dict) -> Callable[[dict], dict]:
    """The reference's name: a callable placing a host numpy batch on
    ``mesh`` by ``batch_specs`` (key -> ``sharding.P``, as
    ``launch/steps.py:batch_struct`` fits them); :func:`mesh_placer` with
    the specs' placements."""
    from repro_torch.distributed.sharding import to_placements
    return mesh_placer(mesh, {k: to_placements(s, mesh)
                              for k, s in batch_specs.items()})
