"""Elastic scaling: mesh reconstruction after node loss and state
resharding (port of ``repro.distributed.elastic``).

On a real fleet the launcher detects failed hosts (heartbeat timeout) and
restarts the job on the surviving set; this module picks the largest
runnable mesh over the surviving ranks and reshards the checkpointed
state onto it.  The tests run the same code in spawned gloo process
groups of different world sizes.
"""
from __future__ import annotations

from typing import Optional, Sequence

from .sharding import param_shardings, shard_tree


def viable_mesh_shapes(n_devices: int,
                       prefer_model: int = 16) -> list[tuple[int, int]]:
    """(data, model) candidates for a degraded device count, largest first.

    Keeps the model axis as close to ``prefer_model`` as divisibility
    allows - TP degree changes force weight-gather layout changes, so we
    shrink the data axis first (the cheap direction).
    """
    shapes = []
    model = prefer_model
    while model >= 1:
        if n_devices % model == 0:
            shapes.append((n_devices // model, model))
        model //= 2
    return shapes


def make_degraded_mesh(ranks: Optional[Sequence[int]] = None,
                       prefer_model: int = 16, device=None):
    """A ("data", "model") DeviceMesh over the largest power-of-two prefix
    of the surviving ``ranks`` (default: every rank of the world), shaped
    by :func:`viable_mesh_shapes`.  Every rank of the world calls it (the
    sub-groups are made collectively); the ranks outside the prefix idle
    (``mesh.get_coordinate()`` is None for them)."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.launch.mesh import _device_type
    ranks = list(range(dist.get_world_size())) if ranks is None \
        else list(ranks)
    # Largest power-of-two prefix: collectives want regular topology.
    n = 1
    while n * 2 <= len(ranks):
        n *= 2
    data, model = viable_mesh_shapes(n, prefer_model)[0]
    grid = torch.tensor(ranks[:n], dtype=torch.int64).reshape(data, model)
    return DeviceMesh(_device_type(device), grid,
                      mesh_dim_names=("data", "model"))


def reshard_state(state, mesh):
    """Re-place a (host-restored or differently-sharded) state tree onto a
    new mesh using the standard param rules: a DTensor leaf is gathered
    from its old placement, a plain leaf is the whole host array."""
    return shard_tree(state, param_shardings(state, mesh))
