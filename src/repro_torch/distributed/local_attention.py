"""Attention on a DTensor mesh: the hand-written kernels, their plain twins
and the engine's scans run on each rank's local shard under ``local_map``
(the reference's ``shard_map``; GSPMD partitions the same code for free).

``core/attention.py:multi_head_attention`` and ``AttentionEngine.prefill``
/ ``decode`` come here when their q is a DTensor.  The placements are the
ones the reference's ``constrain`` calls ask for at the call site (q by
``act_batch`` / ``attn_seq`` / ``heads``, k and v by ``act_batch`` /
``kv_heads``, fitted to the mesh), read off the inputs:

* heads over 'model' (``tp_heads``): each rank runs its H/m query heads.
  When the G kv heads do not divide 'model' (MQA, or chatglm3-6b's G = 2
  on model = 4) k/v arrive replicated and each rank takes the kv heads of
  *its* query heads; their gradient is then a partial sum over 'model';
* the sequence over 'model' (``context`` with ``softmax``): each rank runs
  its slice of query rows against the whole K/V, its row offset in the
  causal mask;
* 'model' unused (``context`` with an LLN impl): every rank of a 'model'
  group runs the same attention.

Statistics pooled over a sharded axis are pooled over the mesh before the
kernel call: the ``batch`` calibration's q/k mean squares are summed over
the batch's mesh axes, and the per-head vector is assembled over 'model'
when the heads are split, so a rank's alpha/beta are the meshless ones.
The stabilization maxima reduce over the sequence and feature dims of one
row and head, which no rule splits under an LLN impl.

The decode state comes in at the layout these kernels want (``local_map``
redistributes a cache placed by ``launch/steps.py:cache_shardings``, e.g.
a feature dim sharded because the heads do not divide 'model') and goes
out at that layout; the serving setup places it back.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from .sharding import is_dtensor


class _SumOver(torch.autograd.Function):
    """All-reduce (sum) over process groups.  Its adjoint is the same
    all-reduce where each rank's outputs depend on the pooled value in
    their own way (the gradient is the sum of every rank's), and the
    identity where every rank of the groups goes on to compute the same
    replicated result (each already holds the whole gradient)."""

    @staticmethod
    def forward(ctx, x, groups, replicated):
        ctx.groups, ctx.replicated = groups, replicated
        y = x.clone()
        for g in groups:
            dist.all_reduce(y, group=g)
        return y

    @staticmethod
    def backward(ctx, gy):
        if ctx.replicated:
            return gy, None, None
        gy = gy.contiguous().clone()
        for g in ctx.groups:
            dist.all_reduce(gy, group=g)
        return gy, None, None


def sum_over(x: torch.Tensor, groups, replicated: bool = False
             ) -> torch.Tensor:
    """``x`` summed over ``groups`` (see :class:`_SumOver` for
    ``replicated``)."""
    return _SumOver.apply(x, tuple(groups), replicated) if groups else x


@dataclasses.dataclass(frozen=True)
class Layout:
    """Where q, k and v of one attention call live on the mesh.
    ``batch``: the mesh dims sharding the batch; ``role``: what 'model'
    shards in q (``heads``, ``seq`` or None); ``kv_split``: k/v's heads
    are split over 'model' too; ``rank``: this rank's coordinate on the
    model axis."""
    mesh: object
    batch: tuple
    role: Optional[str]
    kv_split: bool
    rank: int

    def groups(self, names) -> list:
        return [self.mesh.get_group(n) for n in names
                if self.mesh.shape[self.mesh.mesh_dim_names.index(n)] > 1]

    @property
    def batch_groups(self) -> list:
        return self.groups(self.batch)

    @property
    def model_groups(self) -> list:
        return self.groups(("model",)) if self.role == "heads" else []


def layout_of(q, k) -> Layout:
    return _layout(q.device_mesh, tuple(q.placements), tuple(k.placements))


def _layout(mesh, q_pl: tuple, k_pl: tuple) -> Layout:
    from torch.distributed.tensor import Shard
    names = mesh.mesh_dim_names
    batch, role, kv_split = [], None, False
    for i, name in enumerate(names):
        pq, pk = q_pl[i], k_pl[i]
        if pq == Shard(0):
            batch.append(name)
        elif name == "model" and pq == Shard(2):
            role = "heads"
        elif name == "model" and pq == Shard(1):
            role = "seq"
        elif not pq.is_replicate():
            raise NotImplementedError(
                f"attention with q placed {q_pl} on {names}")
        if name == "model" and pk == Shard(2):
            kv_split = True
    rank = mesh.get_local_rank(names.index("model")) \
        if "model" in names else 0
    if kv_split and role != "heads":
        raise NotImplementedError("kv heads split over 'model' while the "
                                  "query heads are not")
    return Layout(mesh=mesh, batch=tuple(batch), role=role,
                  kv_split=kv_split, rank=rank)


def _grad_placements(t, lay: Layout):
    """k/v's gradient placements: a partial sum over 'model' where every
    model rank reads the whole (replicated) k/v for a different share of
    the queries."""
    from torch.distributed.tensor import Partial
    if lay.role is None or lay.kv_split:
        return tuple(t.placements)
    i = lay.mesh.mesh_dim_names.index("model")
    out = list(t.placements)
    out[i] = Partial()
    return tuple(out)


def _kv_range(lay: Layout, h_loc: int, h: int, g: int,
              g_loc: int) -> tuple[int, int]:
    """The kv heads [g_lo, g_hi) this rank's query heads read, of k/v's
    ``g_loc`` local heads (G in all)."""
    if lay.role != "heads" or lay.kv_split:
        return 0, g_loc
    r = h // g
    h0 = lay.rank * h_loc
    g_lo, g_hi = h0 // r, (h0 + h_loc - 1) // r + 1
    if h_loc % (g_hi - g_lo) or any(
            (h0 + j) // r - g_lo != j // (h_loc // (g_hi - g_lo))
            for j in range(h_loc)):
        raise NotImplementedError(
            f"{h_loc} query heads per rank do not map evenly onto kv heads "
            f"(H = {h}, G = {g})")
    return g_lo, g_hi


def _pooler(lay: Layout, h: int, g: int, per_row: bool):
    """``batch_alpha_beta``'s pool hook: the mean squares summed over the
    batch's mesh axes (batch calibration) and, with the heads split, the
    (H,) / (G,) vectors assembled over 'model'."""
    bsz = 1
    for name in lay.batch:
        bsz *= lay.mesh.shape[lay.mesh.mesh_dim_names.index(name)]

    def place(x, total, split):
        if lay.role != "heads" or not split:
            return x
        loc = x.shape[-1]
        x = F.pad(x, (lay.rank * loc, total - (lay.rank + 1) * loc))
        return sum_over(x, lay.model_groups)

    def pool(msq, msk):
        if not per_row and lay.batch_groups:
            msq = sum_over(msq, lay.batch_groups) / bsz
            msk = sum_over(msk, lay.batch_groups) / bsz
        return place(msq, h, True), place(msk, g, lay.kv_split)
    return pool


def _calibration(ql, kl, cfg, lay: Layout, h: int, g: int, g_lo: int,
                 g_hi: int, per_row: bool, n=None):
    """This rank's (alpha, beta): the meshless calibration's, sliced to
    its query heads and the kv heads they read."""
    from repro_torch.core.attention import batch_alpha_beta
    if cfg.fixed_ab:
        return batch_alpha_beta(ql, kl[:, :, g_lo:g_hi], cfg,
                                per_row=per_row, n=n)
    alpha, beta = batch_alpha_beta(ql, kl, cfg, per_row=per_row, n=n,
                                   pool=_pooler(lay, h, g, per_row))
    h_loc = ql.shape[2]
    if lay.role == "heads":
        alpha = alpha[..., lay.rank * h_loc:(lay.rank + 1) * h_loc]
        if lay.kv_split:
            g_loc = kl.shape[2]
            beta = beta[..., lay.rank * g_loc:(lay.rank + 1) * g_loc]
        else:
            beta = beta[..., g_lo:g_hi]
    return alpha, beta


def _row_offset(lay: Layout, b_loc: int) -> int:
    """The first global batch row of this rank's rows (the batch split
    over ``lay.batch``'s mesh dims, the outer first)."""
    names = lay.mesh.mesh_dim_names
    idx = 0
    for name in lay.batch:
        i = names.index(name)
        idx = idx * lay.mesh.shape[i] + lay.mesh.get_local_rank(i)
    return idx * b_loc


def _given(t, lay: Layout, b_loc: int, lo: int, hi: int, heads: int):
    """A given alpha or beta (a float, or a tensor whose last dim is its
    heads, with a leading (B,) for per-row constants; whole on every rank)
    cut to this rank's rows and to heads [lo, hi)."""
    if t is None or not torch.is_tensor(t) or t.ndim == 0:
        return t
    if is_dtensor(t):
        t = t.full_tensor()
    if t.shape[-1] == heads:
        t = t[..., lo:hi]
    if t.ndim == 2:
        r0 = _row_offset(lay, b_loc)
        t = t[r0:r0 + b_loc]
    return t


def _local_constants(alpha, beta, lay: Layout, h: int, g: int, h_loc: int,
                     b_loc: int, g_lo: int, g_hi: int):
    """This rank's share of given (alpha, beta): alpha by its query heads,
    beta by its kv heads (G of them; [g_lo, g_hi) of k's local heads) or
    its query heads (a per-head beta, pooled to the groups by the
    core)."""
    q_lo = lay.rank * h_loc if lay.role == "heads" else 0
    q_hi = q_lo + h_loc
    if lay.kv_split:
        g_lo, g_hi = lay.rank * g_hi, (lay.rank + 1) * g_hi
    a = _given(alpha, lay, b_loc, q_lo, q_hi, h)
    if torch.is_tensor(beta) and beta.ndim and beta.shape[-1] == h \
            and h != g:
        b = _given(beta, lay, b_loc, q_lo, q_hi, h)
    else:
        b = _given(beta, lay, b_loc, g_lo, g_hi, g)
    return a, b


def _key_mask(mask, k):
    """A (B, N) key mask placed like k's rows (whole on its other mesh
    dims), as a DTensor on k's mesh."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    pl = tuple(Shard(0) if p == Shard(0) else Replicate()
               for p in k.placements)
    if is_dtensor(mask):
        return mask if tuple(mask.placements) == pl else mask.redistribute(
            mask.device_mesh, pl)
    mesh = k.device_mesh
    whole = DTensor.from_local(mask, mesh, (Replicate(),) * mesh.ndim,
                               run_check=False)
    return whole.redistribute(mesh, pl)


def multi_head_attention(q, k, v, cfg, *, mask=None, alpha=None, beta=None,
                         prefix_len: int = 0):
    """``core/attention.py:multi_head_attention`` on DTensor q/k/v, under
    ``local_map``.  ``mask`` (B, N) is split like k's rows;
    ``prefix_len`` reaches the softmax only; a given ``alpha`` / ``beta``
    is cut to the rank's heads (and rows, when per row)."""
    from torch.distributed.tensor.experimental import local_map
    from repro_torch.core import attention as ca
    lay = layout_of(q, k)
    h, g = q.shape[2], k.shape[2]
    given = alpha is not None and beta is not None

    def local(ql, kl, vl, ml):
        g_lo, g_hi = _kv_range(lay, ql.shape[2], h, g, kl.shape[2])
        if lay.role == "seq":
            return ca.flash_softmax(
                ql, kl, vl, causal=cfg.causal,
                chunk=min(cfg.softmax_chunk, kl.shape[1]), mask=ml,
                prefix_len=prefix_len, q_start=lay.rank * ql.shape[1])
        a = b = None
        if cfg.impl != "softmax":
            if given:
                a, b = _local_constants(alpha, beta, lay, h, g, ql.shape[2],
                                        ql.shape[0], g_lo, g_hi)
            else:
                a, b = _calibration(ql, kl, cfg, lay, h, g, g_lo, g_hi,
                                    per_row=False)
        return ca.multi_head_attention(ql, kl[:, :, g_lo:g_hi],
                                       vl[:, :, g_lo:g_hi], cfg, mask=ml,
                                       alpha=a, beta=b,
                                       prefix_len=prefix_len)

    m_pl = None
    if mask is not None:
        mask = _key_mask(mask, k)
        m_pl = tuple(mask.placements)
    return local_map(
        local, out_placements=(tuple(q.placements),),
        in_placements=(tuple(q.placements), tuple(k.placements),
                       tuple(v.placements), m_pl),
        in_grad_placements=(tuple(q.placements), _grad_placements(k, lay),
                            _grad_placements(v, lay), m_pl),
        device_mesh=lay.mesh)(q, k, v, mask)


def flash_softmax(q, k, v, *, causal: bool = True, chunk: int = 1024,
                  mask=None, scale=None, prefix_len: int = 0, q_start=None):
    """``core/attention.py:flash_softmax`` on DTensor q/k/v under
    ``local_map`` (cross-attention over an encoder's keys, a decoder's
    memory): each rank its query heads, or its query rows with their
    absolute positions."""
    from torch.distributed.tensor.experimental import local_map
    from repro_torch.core import attention as ca
    lay = layout_of(q, k)
    h, g = q.shape[2], k.shape[2]
    base = k.shape[1] - q.shape[1] if q_start is None else q_start

    def local(ql, kl, vl, ml):
        g_lo, g_hi = _kv_range(lay, ql.shape[2], h, g, kl.shape[2])
        start = base
        if lay.role == "seq":
            start = base + lay.rank * ql.shape[1]
        return ca.flash_softmax(ql, kl[:, :, g_lo:g_hi], vl[:, :, g_lo:g_hi],
                                causal=causal, chunk=chunk, mask=ml,
                                scale=scale, prefix_len=prefix_len,
                                q_start=start)

    m_pl = None
    if mask is not None:
        mask = _key_mask(mask, k)
        m_pl = tuple(mask.placements)
    return local_map(
        local, out_placements=(tuple(q.placements),),
        in_placements=(tuple(q.placements), tuple(k.placements),
                       tuple(v.placements), m_pl),
        in_grad_placements=(tuple(q.placements), _grad_placements(k, lay),
                            _grad_placements(v, lay), m_pl),
        device_mesh=lay.mesh)(q, k, v, mask)


# ---------------------------------------------------------------------------
# The serving engine.
# ---------------------------------------------------------------------------

# The state's fields per impl, and which dim of each holds the (query or
# kv) heads.
_HEAD_FIELDS = {"s": 1, "z": 1, "c_k": 2, "alpha": 1, "beta": 1,
                "log_scale": 1, "sl": 2, "zl": 2, "cl": 2}
_KV_FIELDS = {"tail_k": 2, "tail_v": 2, "k": 2, "v": 2}


def _state_fields(impl: str) -> tuple:
    if impl == "softmax":
        return ("k", "v", "len")
    if impl in ("lln", "lln_diag"):
        return ("s", "z", "c_k", "pos", "alpha", "beta", "log_scale",
                "tail_k", "tail_v")
    if impl == "log_linear":
        # The Fenwick pyramid (B, L, H, ...) keeps its scale axis whole.
        return ("s", "z", "c_k", "pos", "alpha", "beta", "log_scale",
                "sl", "zl", "cl")
    raise ValueError(f"unknown attention impl: {impl!r}")


def state_placements(lay: Layout, name: str) -> tuple:
    """The placements of one state field at the layout the kernels read
    and write: rows over the batch's axes, the query heads' fields over
    'model' with the heads, the kv fields with the kv heads (whole on
    every rank otherwise)."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for name_m in lay.mesh.mesh_dim_names:
        if name_m in lay.batch:
            out.append(Shard(0))
        elif name_m == "model" and name in _HEAD_FIELDS \
                and lay.role == "heads":
            out.append(Shard(_HEAD_FIELDS[name]))
        elif name_m == "model" and name in _KV_FIELDS and lay.kv_split:
            out.append(Shard(_KV_FIELDS[name]))
        else:
            out.append(Replicate())
    return tuple(out)


def _sliced(state, g_lo: int, g_hi: int):
    """The local state with its kv fields cut to kv heads [g_lo, g_hi)."""
    kw = {f: getattr(state, f)[:, :, g_lo:g_hi] for f in _KV_FIELDS
          if getattr(state, f) is not None}
    return state.replace(**kw)


def prefill(engine, q, k, v, *, max_len: int = 0, prefix_len: int = 0,
            alpha=None, beta=None):
    """``AttentionEngine.prefill`` on DTensor q/k/v under ``local_map``;
    returns ``(out, AttentionState)`` with DTensor leaves at
    :func:`state_placements`.  ``prefix_len`` reaches the softmax prefill
    only (the LLN impls take the prefix causally, as without a mesh); a
    given ``alpha`` / ``beta`` is cut to the rank's heads and rows."""
    from torch.distributed.tensor.experimental import local_map
    from repro_torch.core import attention as ca
    from repro_torch.core.engine import AttentionState, _tail_of
    spec = engine.spec
    fields = _state_fields(spec.impl)
    lay = layout_of(q, k)
    h, g = q.shape[2], k.shape[2]
    n = q.shape[1]
    given = alpha is not None and beta is not None

    def local(ql, kl, vl):
        g_lo, g_hi = _kv_range(lay, ql.shape[2], h, g, kl.shape[2])
        ks, vs = kl[:, :, g_lo:g_hi], vl[:, :, g_lo:g_hi]
        if lay.role == "seq":
            out = ca.flash_softmax(ql, kl, vl, causal=True,
                                   chunk=min(spec.softmax_chunk, n),
                                   prefix_len=prefix_len,
                                   q_start=lay.rank * ql.shape[1])
            pad = (0, 0, 0, 0, 0, max(max_len, n) - n)
            return (out, F.pad(kl.to(engine.state_dtype), pad),
                    F.pad(vl.to(engine.state_dtype), pad),
                    torch.full((kl.shape[0],), n, dtype=torch.int32,
                               device=kl.device))
        a = b = None
        if spec.impl != "softmax":
            if given:
                a, b = _local_constants(alpha, beta, lay, h, g, ql.shape[2],
                                        ql.shape[0], g_lo, g_hi)
            else:
                a, b = _calibration(ql, kl, spec, lay, h, g, g_lo, g_hi,
                                    per_row=spec.calibration == "per_row",
                                    n=n)
        out, state = engine.prefill(ql, ks, vs, max_len=max_len, alpha=a,
                                    beta=b, prefix_len=prefix_len)
        if (g_lo, g_hi) != (0, kl.shape[2]):
            # Every rank keeps every kv head's tail / cache.
            if spec.impl == "softmax":
                pad = (0, 0, 0, 0, 0, max(max_len, n) - n)
                state = state.replace(
                    k=F.pad(kl.to(engine.state_dtype), pad),
                    v=F.pad(vl.to(engine.state_dtype), pad))
            elif spec.impl != "log_linear":
                blk = spec.diag_block
                state = state.replace(
                    tail_k=_tail_of(kl, n, blk).to(engine.state_dtype),
                    tail_v=_tail_of(vl, n, blk).to(engine.state_dtype))
        return (out,) + tuple(getattr(state, f) for f in fields)

    outs = local_map(
        local,
        out_placements=(tuple(q.placements),) + tuple(
            state_placements(lay, f) for f in fields),
        in_placements=(tuple(q.placements), tuple(k.placements),
                       tuple(v.placements)),
        device_mesh=lay.mesh)(q, k, v)
    return outs[0], AttentionState(**dict(zip(fields, outs[1:])))


# The fields a decode leaves as they were (the calibration), and those it
# advances by the committed lengths alone.
_KEPT = ("alpha", "beta")
_COUNTERS = ("pos", "len")


def decode(engine, state, q, k, v, *, row_mask=None, commit_len=None):
    """``AttentionEngine.decode`` on DTensor q/k/v and state under
    ``local_map``.  ``row_mask`` / ``commit_len`` (B,) are placed with the
    rows.  The calibration passes through and the counters advance
    outside ``local_map`` (in the state's own placement: no gather)."""
    from torch.distributed.tensor.experimental import local_map
    from repro_torch.core.engine import AttentionState
    spec = engine.spec
    fields = _state_fields(spec.impl)
    changed = tuple(f for f in fields if f not in _KEPT + _COUNTERS)
    lay = layout_of(q, k)
    h, g = q.shape[2], k.shape[2]
    rows = tuple(state_placements(lay, "pos"))
    extras = _row_vectors(lay, row_mask, commit_len)

    def local(ql, kl, vl, rm, cl, *leaves):
        st = AttentionState(**dict(zip(fields, leaves)))
        g_lo, g_hi = _kv_range(lay, ql.shape[2], h, g, kl.shape[2])
        whole = (g_lo, g_hi) == (0, kl.shape[2])
        out, new = engine.decode(
            st if whole else _sliced(st, g_lo, g_hi), ql,
            kl[:, :, g_lo:g_hi], vl[:, :, g_lo:g_hi], row_mask=rm,
            commit_len=cl)
        if not whole:
            new = _every_kv_head(spec, st, new, kl, vl, rm, cl)
        return (out,) + tuple(getattr(new, f) for f in changed)

    leaves = [getattr(state, f) for f in fields]
    in_pl = (tuple(q.placements), tuple(k.placements), tuple(v.placements),
             None if extras[0] is None else rows,
             None if extras[1] is None else rows) + tuple(
        state_placements(lay, f) for f in fields)
    outs = local_map(
        local,
        out_placements=(tuple(q.placements),) + tuple(
            state_placements(lay, f) for f in changed),
        in_placements=in_pl, device_mesh=lay.mesh,
        redistribute_inputs=True)(q, k, v, *extras, *leaves)
    return outs[0], _advanced(spec, state, outs[1:], changed, extras,
                              q.shape[1])


def _row_vectors(lay: Layout, *vectors) -> list:
    """Per-row ``row_mask`` / ``commit_len`` (None, a DTensor, or a plain
    tensor whole on every rank: taken as replicated) as DTensors."""
    from torch.distributed.tensor import DTensor, Replicate
    out = []
    for t in vectors:
        if t is not None and not isinstance(t, DTensor):
            t = DTensor.from_local(t, lay.mesh,
                                   (Replicate(),) * lay.mesh.ndim,
                                   run_check=False)
        out.append(t)
    return out


def _every_kv_head(spec, st, new, kl, vl, rm, cl):
    """A rank's new local state with its kv fields advanced for every kv
    head (the engine ran on the kv heads of its query heads only): every
    rank keeps every kv head's tail / cache."""
    from repro_torch.core import attention as ca
    t = kl.shape[1]
    if spec.impl == "softmax":
        if cl is None:
            cl = torch.full((kl.shape[0],), t, dtype=torch.int32,
                            device=kl.device)
        kv = ca.commit_softmax(ca.KVCache(k=st.k, v=st.v, length=st.len),
                               kl, vl, commit_len=cl, row_mask=rm)
        return new.replace(k=kv.k, v=kv.v)
    if spec.impl == "log_linear":
        return new
    rolled = ca._roll_tail(
        ca.LLNDecodeState(lln=None, tail_k=st.tail_k, tail_v=st.tail_v,
                          pos=st.pos),
        None, kl, vl, ca.commit_lengths(cl, rm, t))
    return new.replace(tail_k=rolled.tail_k, tail_v=rolled.tail_v)


def _advanced(spec, state, outs, changed, extras, t: int):
    """The new state: the fields ``local_map`` returned, the calibration as
    it was, and the counter advanced by the committed lengths outside
    ``local_map`` (in the state's own placement: no gather)."""
    from repro_torch.core import attention as ca
    from repro_torch.core.engine import AttentionState
    fields = _state_fields(spec.impl)
    new = {f: getattr(state, f) for f in fields}
    new.update(zip(changed, outs))
    counter = "len" if spec.impl == "softmax" else "pos"
    rm, cl = (None if x is None else x.redistribute(
        x.device_mesh, getattr(state, counter).placements) for x in extras)
    adv = ca.commit_lengths(cl, rm, t)
    new[counter] = (getattr(state, counter) + adv).to(torch.int32)
    return AttentionState(**new)


def _commit_layout(engine, state, k) -> Layout:
    """The layout of the score pass whose residual k is being committed:
    its q placed as ``_project_qkv`` places it under the active rules (the
    batch, and the heads over 'model' where they divide), read off a q of
    the state's H heads; without rules (or for the softmax cache, whose
    commit reads no query heads) the heads follow k's."""
    from torch.distributed.tensor import Replicate, Shard
    from . import sharding as shd
    mesh = k.device_mesh
    names = mesh.mesh_dim_names
    kv_split = "model" in names and \
        k.placements[names.index("model")] == Shard(2)
    q_pl = tuple(Shard(0) if p == Shard(0) else
                 (Shard(2) if kv_split and n == "model" else Replicate())
                 for n, p in zip(names, k.placements))
    if engine.spec.impl != "softmax" and shd._ACTIVE is not None:
        b, t = k.shape[:2]
        q_pl = shd.spec_placements(
            (b, t, state.alpha.shape[-1], k.shape[-1]),
            ("act_batch", "attn_seq", "heads", None), mesh)
    return _layout(mesh, q_pl, tuple(k.placements))


def commit(engine, state, residual: dict, *, commit_len=None,
           row_mask=None):
    """``AttentionEngine.commit`` on a DTensor residual ``{"k", "v"}`` (as
    ``verify(return_residuals=True)`` returned it on the mesh) and state,
    under ``local_map`` with :func:`decode`'s layout: each rank folds the
    accepted prefix into its shard, its kv fields advanced for every kv
    head, the counter outside ``local_map``.  The same state, bit for bit,
    as :func:`decode` with this ``commit_len``."""
    from torch.distributed.tensor.experimental import local_map
    from repro_torch.core.engine import AttentionState
    spec = engine.spec
    k, v = residual["k"], residual["v"]
    fields = _state_fields(spec.impl)
    changed = tuple(f for f in fields if f not in _KEPT + _COUNTERS)
    lay = _commit_layout(engine, state, k)
    h, g = (k.shape[2] if spec.impl == "softmax"
            else state.alpha.shape[-1]), k.shape[2]
    rows = tuple(state_placements(lay, "pos"))
    extras = _row_vectors(lay, row_mask, commit_len)

    def local(kl, vl, rm, cl, *leaves):
        st = AttentionState(**dict(zip(fields, leaves)))
        g_lo, g_hi = 0, kl.shape[2]
        if spec.impl != "softmax":
            g_lo, g_hi = _kv_range(lay, st.alpha.shape[-1], h, g,
                                   kl.shape[2])
        whole = (g_lo, g_hi) == (0, kl.shape[2])
        new = engine.commit(
            st if whole else _sliced(st, g_lo, g_hi),
            {"k": kl[:, :, g_lo:g_hi], "v": vl[:, :, g_lo:g_hi]},
            commit_len=cl, row_mask=rm)
        if not whole:
            new = _every_kv_head(spec, st, new, kl, vl, rm, cl)
        return tuple(getattr(new, f) for f in changed)

    leaves = [getattr(state, f) for f in fields]
    in_pl = (tuple(k.placements), tuple(v.placements),
             None if extras[0] is None else rows,
             None if extras[1] is None else rows) + tuple(
        state_placements(lay, f) for f in fields)
    outs = local_map(
        local, out_placements=tuple(state_placements(lay, f)
                                    for f in changed),
        in_placements=in_pl, device_mesh=lay.mesh,
        redistribute_inputs=True)(k, v, *extras, *leaves)
    return _advanced(spec, state, outs, changed, extras, k.shape[1])


def mla_absorbed(fn, w_uk, w_uv, cfg, state, q_nope, q_rope, ckv_new,
                 kr_new):
    """MLA's absorbed softmax decode (``models/mla.py:_absorbed``, passed
    as ``fn``) on DTensors under ``local_map``: each rank its query heads
    (by the rules' ``heads``), the latent cache ``ckv`` gathered over its
    split latent dim (``cache_shardings`` splits it over 'model') and
    ``W_uk`` / ``W_uv`` whole, so the contraction over the latent dim is
    local.  Returns (out, ckv, kr, len), the caches whole on 'model'."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    from . import sharding as shd
    q_pl = shd.spec_placements(q_nope.shape,
                               ("act_batch", None, "heads", None))
    mesh = q_nope.device_mesh
    rows = tuple(p if p == Shard(0) else Replicate() for p in q_pl)
    rep = (Replicate(),) * mesh.ndim
    names = mesh.mesh_dim_names
    split = "model" in names and q_pl[names.index("model")] == Shard(2)
    rank = mesh.get_local_rank(names.index("model")) if split else 0

    def local(qn, qr, cn, kn, ckv, kr, length, wk, wv):
        from repro_torch.core.engine import AttentionState
        st = AttentionState(ckv=ckv, kr=kr, len=length)
        return fn(wk, wv, cfg, st, qn, qr, cn, kn, h0=rank * qn.shape[2])

    return local_map(
        local, out_placements=(q_pl, rows, rows, rows),
        in_placements=(q_pl, q_pl, rows, rows, rows, rows, rows, rep, rep),
        device_mesh=mesh, redistribute_inputs=True)(
        q_nope, q_rope, ckv_new, kr_new, state.ckv, state.kr, state.len,
        shd.redistributed(w_uk, rep), shd.redistributed(w_uv, rep))
