"""The Mamba2 mixer on a DTensor mesh: the causal conv, the SSD scan (the
hand-written kernel under ``use_kernel``, row 11) and the decode
recurrences run on each rank's local shard under ``local_map``, as
``local_attention.py`` runs attention.

The projections around the mixer stay DTensor products.  The placements
follow the reference's constraints (``repro/models/ssm.py:97-99, 162``):
rows over the batch's mesh dims, the heads over 'model' when the rules
put heads there and the SSM heads divide it (zamba2-7b's 112 over 16),
whole on every rank of 'model' otherwise (mamba2-130m's 24).  x is
convolved piece by piece, as the reference does, so a head-split x is
never gathered for training or prefill; B and C (the groups) are whole
on every rank, and their gradient is a partial sum over 'model' where the
ranks read them for different heads.  The mixer's weights (the conv, dt
bias, A and the skip, replicated by the parameter rules) come in whole:
each rank takes its heads' slice, and their gradient is a partial sum
over every mesh dim that splits the activations.

Decode takes the conv input with whole columns on every rank (the new
conv window is whole, as ``cache_shardings`` places it) and the state at
its heads' split; the serving setup places the caches back.
"""
from __future__ import annotations

from . import sharding as shd


def _heads_split(x, h: int) -> bool:
    """The SSM heads split over 'model' (the rules' ``heads`` there, and
    H divisible by it)."""
    mesh = x.device_mesh
    names = mesh.mesh_dim_names
    rules = shd._ACTIVE or {}
    if rules.get("heads") != "model" or "model" not in names:
        return False
    m = mesh.shape[names.index("model")]
    row_dims = {i for i, p in enumerate(x.placements) if p.is_shard(0)}
    return m > 1 and h % m == 0 and names.index("model") not in row_dims


class _Layout:
    """The placements of the mixer's tensors on ``x``'s mesh: its rows
    (the mesh dims where ``x`` is split on dim 0) and, when ``split``, the
    heads over 'model'."""

    def __init__(self, x, h: int):
        self.mesh = x.device_mesh
        self.names = self.mesh.mesh_dim_names
        self.rows = tuple(i for i, p in enumerate(x.placements)
                          if p.is_shard(0))
        self.split = _heads_split(x, h)
        self.rank = (self.mesh.get_local_rank(self.names.index("model"))
                     if self.split else 0)

    def pl(self, head_dim=None, partial=False) -> tuple:
        """Rows Shard(0), the heads Shard(head_dim) on 'model' when split,
        Replicate elsewhere; ``partial``: Partial() on every dim that
        splits the activations (a replicated input's gradient)."""
        from torch.distributed.tensor import Partial, Replicate, Shard
        out = []
        for i, name in enumerate(self.names):
            on_heads = self.split and name == "model"
            if partial and (i in self.rows or on_heads):
                out.append(Partial())
            elif i in self.rows:
                out.append(Shard(0))
            elif on_heads and head_dim is not None:
                out.append(Shard(head_dim))
            else:
                out.append(Replicate())
        return tuple(out)


def _whole(t, lay: _Layout):
    """A (replicated) weight as a DTensor whole on every rank."""
    from torch.distributed.tensor import Replicate
    return shd.redistributed(t, (Replicate(),) * lay.mesh.ndim)


def mix(xs, b_proj, c_proj, dt, w, cfg, *, state0=None,
        return_state: bool = False):
    """``models/ssm.py:_mix`` on DTensors: (y (B, L, di) fp32, the final
    state (B, H, S, P) or None)."""
    from torch.distributed.tensor.experimental import local_map
    from repro_torch.models import ssm
    if state0 is not None:
        raise NotImplementedError("a carried SSM state0 on a mesh")
    h = dt.shape[-1]
    lay = _Layout(xs, h)
    from torch.distributed.tensor import Partial, Replicate
    act = lay.pl(head_dim=2)
    rows = lay.pl()
    # B / C: every rank of 'model' reads them for its own heads.
    grad_bc = tuple(Partial() if lay.split and name == "model" else p
                    for name, p in zip(lay.names, rows))
    wpl = tuple((Replicate(),) * lay.mesh.ndim for _ in w)
    wgrad = tuple(lay.pl(partial=True) for _ in w)

    def local(xl, bl, cl, dl, *wl):
        h0 = lay.rank * dl.shape[-1]
        return ssm._mix(xl, bl, cl, dl, wl, cfg, h0,
                        return_state=return_state)

    outs = (act, lay.pl(head_dim=1) if return_state else None)
    fn = local_map(
        local, out_placements=outs,
        in_placements=(act, rows, rows, act) + wpl,
        in_grad_placements=(act, grad_bc, grad_bc, act) + wgrad,
        device_mesh=lay.mesh, redistribute_inputs=True)
    return fn(xs, b_proj, c_proj, dt, *(_whole(t, lay) for t in w))


def whole_columns(pieces):
    """DTensors (B, N, C) with their columns whole on every rank (the rows
    keep their split): the conv window's x, B and C pieces before they are
    concatenated."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for t in pieces:
        pl = tuple(p if p == Shard(0) else Replicate() for p in t.placements)
        out.append(shd.redistributed(t, pl))
    return tuple(out)


def decode_mix(fn, conv_in, dt, state0, conv0, w, cfg, **kw):
    """A decode mixer of ``models/ssm.py`` (``_decode_chunk_mix`` or
    ``_decode_step_mix``) on DTensors: conv_in and the conv window whole
    on 'model', dt and the state split with the heads.  Returns (y, new
    state, new conv window)."""
    from torch.distributed.tensor import DTensor, Replicate
    from torch.distributed.tensor.experimental import local_map
    h = dt.shape[-1]
    lay = _Layout(conv_in, h)
    rows = lay.pl()
    extras = []
    for name in ("row_mask", "commit_len"):
        t = kw.get(name)
        if t is not None and not shd.is_dtensor(t):
            t = DTensor.from_local(t, lay.mesh,
                                   (Replicate(),) * lay.mesh.ndim,
                                   run_check=False)
        extras.append(t)
    rep = (Replicate(),) * lay.mesh.ndim

    def local(cl, dl, sl, wl_conv, rm, cm, *wl):
        h0 = lay.rank * dl.shape[-1]
        more = {} if not kw else {"row_mask": rm, "commit_len": cm}
        return fn(cl, dl, sl, wl_conv, wl, cfg, h0, **more)

    in_pl = (rows, lay.pl(head_dim=2), lay.pl(head_dim=1), rows,
             None if extras[0] is None else rows,
             None if extras[1] is None else rows) + tuple(rep for _ in w)
    return local_map(
        local,
        out_placements=(lay.pl(head_dim=2), lay.pl(head_dim=1), rows),
        in_placements=in_pl, device_mesh=lay.mesh,
        redistribute_inputs=True)(conv_in, dt, state0, conv0, *extras,
                                  *(_whole(t, lay) for t in w))
