"""Fault-tolerant checkpointing (port of ``repro.checkpoint.checkpointer``;
no dependencies beyond numpy: npz shards and a JSON index).

Layout:   <dir>/step_<N>/
              index.json          leaf paths, shapes, dtypes and CRC32s
              shard_0.npz         every leaf, as a host array
              <extra files>       opaque sidecar payloads (e.g. batcher meta)
              _COMMITTED          written last: a manifest of byte sizes

Guarantees, the reference's:
* atomicity - every file is staged to ``<name>.tmp``, fsynced and
  ``os.replace``d; the whole step directory is staged as ``step_<N>.tmp``
  and renamed into place only after ``_COMMITTED`` lands and the directory
  is fsynced, so a crash at any point never leaves a half-written
  directory that restore would pick up;
* integrity - ``_COMMITTED`` carries the byte size of every file
  (truncation shows without a full read) and ``index.json`` a CRC32 per
  leaf, checked on restore; :func:`is_valid` checks the manifest,
  :func:`valid_steps` keeps the intact steps (a legacy ``_COMMITTED``
  holding just ``"ok"`` falls back to existence checks);
* async - :class:`AsyncCheckpointer` writes on a thread, one save in
  flight at a time.

Trees are the port's (``repro_torch.tree``): nested dicts, lists, tuples,
dataclasses and ``nn.Module`` parameters with tensors or ``None`` at the
leaves, each leaf named by its path (``params/layers.0.attn.q_w``,
``caches/layers/3/s``).  numpy has no bfloat16, so a bf16 tensor is stored
as its uint16 bits with ``"dtype": "bfloat16"`` in the index, and read back
bit for bit.  :func:`restore` puts each leaf on the template leaf's device
and dtype; a module of the template is filled in place.

On a mesh the leaves are DTensors.  A save gathers each leaf to its full
array in the caller's thread (a collective: never on the writer's thread),
as the reference saves process-gathered arrays; rank 0 writes, and a
barrier follows (for an async save, in :meth:`AsyncCheckpointer.wait`).
``restore(..., shardings)`` places each leaf by ``{path: NamedSharding}``
(``distributed/sharding.py``), onto the same mesh or another one: the
elastic-reshard path; without ``shardings`` a DTensor template leaf keeps
its own placements.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import zlib
from typing import Any, Optional

import numpy as np
import torch
from torch import nn

from repro_torch import tree as tr
from repro_torch.distributed import sharding as shd

# torch dtypes numpy cannot hold, stored as same-width unsigned bits.
_BITS = {torch.bfloat16: np.uint16}


def _flatten(tree) -> list:
    return [(tr.path_str(p), leaf) for p, leaf in tr.leaves_with_path(tree)]


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().to("cpu").contiguous()
    bits = _BITS.get(t.dtype)
    if bits is not None:
        return t.view(torch.int16).numpy().view(bits)
    return t.numpy()


def _from_numpy(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    dtype = getattr(torch, dtype_name)
    if dtype in _BITS:
        return torch.from_numpy(arr.view(np.int16).copy()).view(dtype)
    return torch.from_numpy(np.array(arr))


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _write_atomic(path: str, data) -> None:
    """tmp + fsync + ``os.replace``: the file is either absent or complete,
    never truncated, even across a crash mid-write.  ``data`` is bytes or
    a function that writes to the open file."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        if callable(data):
            data(f)
        else:
            f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _distributed(tree) -> bool:
    """The tree holds DTensors: its save gathers and rank 0 writes."""
    return any(shd.is_dtensor(t) for _, t in tr.leaves_with_path(tree))


def _writes() -> bool:
    return not torch.distributed.is_initialized() \
        or torch.distributed.get_rank() == 0


def save(directory: str, step: int, tree: Any,
         extra: Optional[dict] = None) -> str:
    """Synchronous checkpoint write.  ``extra`` maps file names to
    ``str``/``bytes`` sidecar payloads saved in the same atomic commit (read
    back with :func:`read_extra`), e.g. the serving batcher's JSON.  A
    tree of DTensors is gathered, written by rank 0, then every rank
    meets at a barrier."""
    final = os.path.join(directory, f"step_{step:08d}")
    if _distributed(tree):
        host = _host_copy(tree)
        if _writes():
            _write(directory, step, host, extra)
        torch.distributed.barrier()
        return final
    return _write(directory, step, tree, extra)


def _write(directory: str, step: int, tree: Any,
           extra: Optional[dict] = None) -> str:
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)

    arrays, meta = {}, {}
    for i, (p, leaf) in enumerate(_flatten(tree)):
        arr = _to_numpy(leaf)
        key = f"leaf_{i}"
        arrays[key] = arr
        meta[key] = {"path": p, "shape": list(arr.shape),
                     "dtype": _dtype_name(leaf),
                     "crc": zlib.crc32(np.ascontiguousarray(arr))}
    _write_atomic(os.path.join(tmp, "shard_0.npz"),
                  lambda f: np.savez(f, **arrays))
    _write_atomic(os.path.join(tmp, "index.json"),
                  json.dumps({"step": step, "leaves": meta}).encode())
    for name, payload in (extra or {}).items():
        if isinstance(payload, str):
            payload = payload.encode()
        _write_atomic(os.path.join(tmp, name), payload)
    # The manifest of byte sizes goes into the commit sentinel: a reader
    # detects a truncated file without parsing it.
    manifest = {name: os.path.getsize(os.path.join(tmp, name))
                for name in os.listdir(tmp)}
    _write_atomic(os.path.join(tmp, "_COMMITTED"),
                  json.dumps({"files": manifest}).encode())
    _fsync_dir(tmp)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    _fsync_dir(directory)
    return final


def committed_steps(directory: str) -> list[int]:
    if not os.path.isdir(directory):
        return []
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(directory, name, "_COMMITTED")):
                steps.append(int(name.split("_")[1]))
    return sorted(steps)


def is_valid(directory: str, step: int) -> bool:
    """True iff the committed step directory passes its manifest (every
    file present at its recorded size).  A legacy sentinel holding the bare
    ``"ok"`` falls back to checking that the index and shard exist."""
    d = os.path.join(directory, f"step_{step:08d}")
    sentinel = os.path.join(d, "_COMMITTED")
    if not os.path.exists(sentinel):
        return False
    try:
        with open(sentinel, "rb") as f:
            manifest = json.loads(f.read()).get("files", {})
    except (ValueError, OSError, AttributeError):
        return (os.path.exists(os.path.join(d, "index.json"))
                and os.path.exists(os.path.join(d, "shard_0.npz")))
    for name, size in manifest.items():
        if name == "_COMMITTED":
            continue
        p = os.path.join(d, name)
        if not os.path.exists(p) or os.path.getsize(p) != size:
            return False
    return True


def valid_steps(directory: str) -> list[int]:
    """Committed steps that also pass :func:`is_valid` (restorable)."""
    return [s for s in committed_steps(directory) if is_valid(directory, s)]


def read_extra(directory: str, step: int, name: str) -> bytes:
    """Read back a sidecar file written by ``save(..., extra=...)``."""
    with open(os.path.join(directory, f"step_{step:08d}", name), "rb") as f:
        return f.read()


def restore(directory: str, step: int, target_tree: Any,
            shardings: Optional[dict] = None) -> Any:
    """Restore into the structure of ``target_tree``: each leaf takes the
    template leaf's dtype and device, and with ``shardings`` (``{leaf
    path: NamedSharding}``) its placement on a mesh: the elastic-reshard
    path.  Raises ``IOError`` on a CRC mismatch, ``KeyError`` on a leaf
    the checkpoint lacks and ``ValueError`` on a shape mismatch."""
    d = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(d, "index.json")) as f:
        index = json.load(f)
    by_path = {}
    with np.load(os.path.join(d, "shard_0.npz")) as data:
        for key, m in index["leaves"].items():
            arr = data[key]
            if zlib.crc32(np.ascontiguousarray(arr)) != m["crc"]:
                raise IOError(f"checkpoint corruption at {m['path']}")
            by_path[m["path"]] = (arr, m["dtype"])

    def leaf(path, t):
        p = tr.path_str(path)
        if p not in by_path:
            raise KeyError(f"checkpoint missing leaf {p}")
        arr, dtype_name = by_path[p]
        if tuple(arr.shape) != tuple(t.shape):
            raise ValueError(f"shape mismatch at {p}: "
                             f"{tuple(arr.shape)} vs {tuple(t.shape)}")
        out = _from_numpy(arr, dtype_name).to(device=t.device,
                                               dtype=t.dtype)
        if shardings is not None:
            return shd.place_leaf(out, shardings[p])
        if shd.is_dtensor(t):
            return shd.place_leaf(out, shd.NamedSharding(
                t.device_mesh, _spec_of(t)))
        return out
    return _fill(target_tree, tr.map_with_path(leaf, target_tree))


def _spec_of(t) -> shd.P:
    """The spec of a DTensor's placements (Shard / Replicate only)."""
    names = t.device_mesh.mesh_dim_names
    dims: list = [[] for _ in range(t.ndim)]
    for name, pl in zip(names, t.placements):
        if pl.is_shard():
            dims[pl.dim].append(name)
    return shd.P(*(None if not d else d[0] if len(d) == 1 else tuple(d)
                   for d in dims))


@torch.no_grad()
def _fill(template, restored):
    """``restored`` (``tr.map_with_path``'s output) with each module of
    ``template`` filled in place and kept in its place in the tree (a
    parameter placed on another layout is replaced)."""
    if isinstance(template, nn.Module):
        for name, p in template.named_parameters():
            new = restored[name]
            if shd.is_dtensor(new) and not (
                    shd.is_dtensor(p) and p.device_mesh == new.device_mesh
                    and p.placements == new.placements):
                shd.set_parameter(template, name, new)
            else:
                p.copy_(new)
        return template
    if isinstance(template, dict):
        return {k: _fill(template[k], v) for k, v in restored.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(_fill(t, r) for t, r in zip(template, restored))
    return restored


def _host_copy(tree: Any) -> Any:
    """Every tensor leaf copied to host memory (a fresh copy even of a CPU
    tensor), so that later in-place updates cannot reach what is saved; a
    DTensor leaf is gathered to its full array first (a collective)."""
    def host(_, t):
        if shd.is_dtensor(t):
            t = t.full_tensor()
        return t.detach().to("cpu", copy=True)
    return tr.map_with_path(host, tree)


class AsyncCheckpointer:
    """Saves on one writer thread, one save in flight at a time."""

    def __init__(self, directory: str, keep_n: int = 3):
        self.directory = directory
        self.keep_n = keep_n
        self._pending: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None
        self._barrier = False

    def save_async(self, step: int, tree: Any,
                   extra: Optional[dict] = None):
        self.wait()
        # The port's AdamW updates in place: copy every leaf to host memory
        # before returning, so that the next step cannot overwrite what the
        # thread is writing.  DTensors are gathered here, in the caller's
        # thread; only rank 0 writes.
        self._barrier = _distributed(tree)
        host_tree = _host_copy(tree)
        if not _writes():
            return

        def work():
            try:
                _write(self.directory, step, host_tree, extra=extra)
                self._gc()
            except Exception as e:       # raised again by wait()
                self._error = e
        self._pending = threading.Thread(target=work, daemon=True)
        self._pending.start()

    def wait(self):
        """Join the writer; after a save of DTensors every rank meets at a
        barrier, so no rank reads the step before it is committed."""
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        if self._barrier:
            self._barrier = False
            torch.distributed.barrier()
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        steps = committed_steps(self.directory)
        for s in steps[:-self.keep_n]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)
