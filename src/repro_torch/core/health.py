"""State-health sentinel: cheap per-row checks over the decode state (port
of ``repro.core.health``).

The LLN ``(s, z, c_k)`` recurrence is a running sum, so one non-finite
value (a poisoned activation, an overflowed feature, a bad cache write)
stays for good and corrupts every token the row emits after it.  The
serving pool therefore checks state health per row and quarantines only
the poisoned slot (``launch/batcher.py``).

Checks (each a per-row bool, all OR-ed into ``unhealthy``):

* ``nonfinite`` - any NaN/Inf in any float leaf of the row;
* ``magnitude`` - any float leaf with ``|x| > max_abs`` (running sums
  exploding long before they reach Inf);
* ``calib``     - per-row ``alpha``/``beta`` outside ``(0, max_calib]``.

The port's caches are per-layer lists of states whose rows lie on axis 0,
so the row axis is 0 for every leaf.  A free (evicted) slot is all zeros
with ``alpha = beta = 1`` and is healthy by construction.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.distributed.sharding import (any_over_mesh, is_dtensor,
                                              local_rows)
from repro_torch.tree import float_leaf, leaves_with_path

_CALIB_NAMES = ("alpha", "beta")


@dataclasses.dataclass(frozen=True)
class HealthConfig:
    """Sentinel thresholds.  ``max_abs`` bounds every float state leaf
    (LLN ``s``/``z``/``c_k``, KV rows, diag tails, SSM states);
    ``max_calib`` bounds the per-row moment-matching constants.  Both are
    generous: the sentinel catches corruption, not healthy numerics.

    ``check_drift``: a row whose ``|conc_drift|`` (log key mass per
    committed token, ``core/metrics.py:streaming_concentration_tree``)
    exceeds ``max_conc_drift`` is quarantined like a corrupted row.  Off
    by default (``launch/serve.py --drift`` turns it on)."""
    max_abs: float = 1e6
    max_calib: float = 1e3
    check_nonfinite: bool = True
    check_magnitude: bool = True
    check_calib: bool = True
    check_drift: bool = False
    max_conc_drift: float = 20.0


def _rows(bad: torch.Tensor) -> torch.Tensor:
    """OR over every axis but the row axis 0 -> (B,) bool."""
    return bad.reshape(bad.shape[0], -1).any(dim=1)


def row_health(tree, *, config: HealthConfig = HealthConfig()) -> dict:
    """Per-row health flags of a decode-state tree (an ``AttentionState``,
    or a model's cache tree of per-layer states), rows on axis 0.  Integer
    leaves and 0-d leaves are skipped.  Returns ``{"unhealthy",
    "nonfinite", "magnitude", "calib"}``, each a (B,) bool tensor
    (``unhealthy`` the OR of the enabled checks).

    DTensor leaves (a pool on a mesh) are checked on each rank's shard:
    its rows' flags land at their global rows and are OR-ed over the mesh,
    so every rank gets the same vectors without gathering a state."""
    nonfinite = magnitude = calib = None
    mesh = None

    def acc(cur, new):
        return new if cur is None else cur | new

    for path, leaf in leaves_with_path(tree):
        if not float_leaf(leaf) or leaf.ndim == 0:
            continue
        rows, n = None, leaf.shape[0]
        if is_dtensor(leaf):
            mesh, rows = leaf.device_mesh, local_rows(leaf)
            leaf = leaf.to_local()

        def lift(bad, rows=rows, n=n):
            flags = _rows(bad)
            if rows is None:
                return flags
            out = torch.zeros(n, dtype=torch.bool, device=flags.device)
            out[rows] = flags
            return out
        if path[-1] in _CALIB_NAMES:
            if config.check_calib:
                bad = (~torch.isfinite(leaf) | (leaf <= 0.0)
                       | (leaf > config.max_calib))
                calib = acc(calib, lift(bad))
            continue
        if config.check_nonfinite:
            nonfinite = acc(nonfinite, lift(~torch.isfinite(leaf)))
        if config.check_magnitude:
            magnitude = acc(magnitude,
                            lift(torch.abs(leaf) > config.max_abs))

    if nonfinite is None and magnitude is None and calib is None:
        raise ValueError("state tree has no float leaves with a row axis")
    some = next(f for f in (nonfinite, magnitude, calib) if f is not None)
    zero = torch.zeros_like(some)
    flags = {"nonfinite": nonfinite if nonfinite is not None else zero,
             "magnitude": magnitude if magnitude is not None else zero,
             "calib": calib if calib is not None else zero}
    if mesh is not None:
        pooled = any_over_mesh(torch.stack(list(flags.values())), mesh)
        flags = dict(zip(flags, pooled))
    flags["unhealthy"] = (flags["nonfinite"] | flags["magnitude"]
                          | flags["calib"])
    return flags


def unhealthy_rows(tree, *, config: HealthConfig = HealthConfig()
                   ) -> torch.Tensor:
    """(B,) bool: rows whose state fails any enabled health check."""
    return row_health(tree, config=config)["unhealthy"]


__all__ = ["HealthConfig", "row_health", "unhealthy_rows"]
