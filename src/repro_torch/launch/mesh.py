"""Production meshes (port of ``repro.launch.mesh``), as
``torch.distributed`` DeviceMeshes: one process per device, started by
``torchrun``.

Single pod: (data=16, model=16) - 256 devices.
Multi-pod:  (pod=2, data=16, model=16) - 512 devices; the 'pod' axis is
kept outermost so cross-pod collectives are pure data-parallel gradient
reductions.

Defined as functions (never module-level) so importing this module starts
no process group.  The backend follows the device: NCCL for ``cuda``, gloo
for ``cpu``; there is no switch from one to the other.
"""
from __future__ import annotations

import math
import os

import torch
import torch.distributed as dist

_BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def _device_type(device) -> str:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device found; pass device='cpu' for a gloo mesh "
                "on the CPU")
        return "cuda"
    return torch.device(device).type


def _init_group(device_type: str, world: int) -> None:
    """Start the default process group from torchrun's environment, or a
    one-rank group on a local port when a one-device mesh runs without
    torchrun."""
    backend = _BACKENDS[device_type]
    kw = {}
    if device_type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", 0))
        torch.cuda.set_device(local)
        kw["device_id"] = torch.device("cuda", local)
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, **kw)
        return
    if world != 1:
        raise ValueError(
            f"a mesh of {world} devices needs {world} processes: start "
            f"them with torchrun --nproc-per-node {world}")
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1, **kw)


def compat_mesh(shape, axes, device=None):
    """A DeviceMesh of ``shape`` with axis names ``axes`` over every rank
    of the default process group, started here if none is up.  Raises
    ``ValueError`` when ``prod(shape)`` is not the world size: the devices
    must exist."""
    from torch.distributed.device_mesh import init_device_mesh
    device_type = _device_type(device)
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} vs axes {tuple(axes)}")
    if not dist.is_initialized():
        _init_group(device_type, math.prod(shape))
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"mesh {shape} needs {math.prod(shape)} devices, "
                         f"the world has {world}")
    return init_device_mesh(device_type, shape, mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device=None):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return compat_mesh(shape, axes, device)


def make_smoke_mesh(data: int = 1, model: int = 1, device=None):
    """A (data, model) mesh over the ranks that exist (tests, the card)."""
    return compat_mesh((data, model), ("data", "model"), device)


def mesh_from_flag(flag: str, cfg, device=None, *, continuous: bool = False,
                   speculative: bool = False):
    """The CLIs' ``--mesh d,m``: None for ``1,1`` (the meshless path), a
    (data, model) mesh otherwise.  Every family serves and trains on a
    mesh, in every serving mode (``continuous``, the request pool, and
    ``speculative`` are accepted as the CLIs pass them: neither changes the
    mesh); a mesh whose size is not the world size raises
    ``ValueError``."""
    del continuous, speculative
    data, model = (int(x) for x in flag.split(","))
    if (data, model) == (1, 1):
        return None
    check_mesh_family(cfg)
    return make_smoke_mesh(data, model, device)


_MESH_FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm",
                  "encoder")


def check_mesh_family(cfg) -> None:
    """Every family of the reference runs on a mesh (MLA included)."""
    if cfg.family not in _MESH_FAMILIES:
        raise NotImplementedError(
            f"{cfg.name} (family={cfg.family}) has no mesh path")


def is_main_rank() -> bool:
    """Rank 0 of the default group, or the only process."""
    return not dist.is_initialized() or dist.get_rank() == 0
