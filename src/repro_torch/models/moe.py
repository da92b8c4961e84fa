"""Top-k routed Mixture-of-Experts FFN (port of ``repro.models.moe``,
the meshless path).

Each token is routed by an fp32 softmax router to its ``top_k`` experts
(weights renormalised over the k), then gathered into a capacity-bounded
(E, C, D) buffer by a sort-based dispatch: a slot's rank within its expert
comes from a stable argsort of the routed expert ids, and slots past the
capacity ``max(int(T k capacity_factor / E), 1)`` are dropped.  Every
expert runs its SwiGLU / GeGLU FFN on its whole buffer (empty rows
included, as the reference's fixed-shape dispatch does, at decode too) as
batched matrix products, and the outputs scatter back weighted, summed in
fp32.  The Switch-style load-balance loss is built by a scatter-add.
Optional shared experts (deepseek-v2) add a dense FFN of
``n_shared_experts * expert_d_ff`` over every token.

On a mesh (a DTensor x under ``logical_rules`` with a 'model' axis) the
reference's expert-parallel path runs as ``local_map`` (its
``shard_map``): token rows over the largest prefix of the batch axes that
divides the batch, ``E / model`` experts per rank (``e_start = rank *
e_loc``), the FSDP shards of the expert weights gathered on entry, each
rank's output a partial sum over 'model', reduce-scattered onto the
sequence when ``n % ep == 0 and n > 1`` and all-reduced otherwise, and the
aux loss averaged over 'model' and the batch axes.  The capacity is per
rank's tokens, as in the reference.  Parameter names are the reference's
(``router_w``, ``exp_wi_gate``, ``exp_wi_up``, ``exp_wo``,
``shared_wi_gate``, ``shared_wi_up``, ``shared_wo``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.distributed import sharding as shd
from .layers import _dense_param, _gelu, trunc_normal


class MoE(nn.Module):
    """Router (fp32, (D, E)), expert stacks (E, D, F) / (E, F, D) and the
    optional shared experts, in the reference's layout."""

    def __init__(self, cfg, dtype, device, generator):
        super().__init__()
        d, e, f = cfg.d_model, cfg.n_experts, cfg.expert_d_ff
        std = d ** -0.5

        def param(shape, s, dt):
            return nn.Parameter(trunc_normal(shape, s, dt, device, generator))
        self.router_w = param((d, e), 0.02, torch.float32)
        self.exp_wi_gate = param((e, d, f), std, dtype)
        self.exp_wi_up = param((e, d, f), std, dtype)
        self.exp_wo = param((e, f, d), f ** -0.5, dtype)
        if cfg.n_shared_experts:
            fs = cfg.expert_d_ff * cfg.n_shared_experts
            self.shared_wi_gate = _dense_param(d, fs, dtype, device, generator)
            self.shared_wi_up = _dense_param(d, fs, dtype, device, generator)
            self.shared_wo = _dense_param(fs, d, dtype, device, generator)


def moe_init(cfg, device, generator=None) -> MoE:
    return MoE(cfg, cfg.pdtype, device, generator)


def _act(x, act: str):
    return F.silu(x) if act.startswith("silu") else _gelu(x)


def _route(x, router_w, top_k: int):
    """x (T, D) -> (expert ids (T, K), weights (T, K) fp32, aux loss)."""
    logits = x.float() @ router_w.float()
    probs = torch.softmax(logits, dim=-1)
    w, idx = torch.topk(probs, top_k, dim=-1)
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    e, t = router_w.shape[1], x.shape[0]
    me = probs.mean(0)
    load = torch.zeros(e, device=x.device).index_add_(
        0, idx.reshape(-1), torch.ones(idx.numel(), device=x.device)) / t
    return idx, w, e * torch.sum(me * load)


def _positions_in_expert(flat_e, num_experts: int):
    """Rank of each routed slot within its expert (a stable sort)."""
    m = flat_e.shape[0]
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    starts = torch.searchsorted(
        sorted_e, torch.arange(num_experts, device=flat_e.device))
    rank = torch.arange(m, device=flat_e.device) - starts[sorted_e]
    return torch.zeros(m, dtype=torch.long, device=flat_e.device) \
        .scatter(0, order, rank)


def _expert_ffn(xg, wi_gate, wi_up, wo, act: str, dtype):
    """xg (E, C, D); weights (E, D, F) / (E, F, D) -> (E, C, D)."""
    xg = xg.to(dtype)
    g = torch.bmm(xg, wi_gate.to(dtype))
    u = torch.bmm(xg, wi_up.to(dtype))
    return torch.bmm(_act(g, act) * u, wo.to(dtype))


def _moe_local(x, p, cfg, e0: int, e_loc: int, dtype):
    """Dispatch, experts [e0, e0 + e_loc) and the weighted combine for
    tokens x (T, D); ``p`` holds ``router_w`` and the *local* expert
    slices (E_loc, ...).  Returns (this shard's partial output (T, D) in
    ``dtype``, the sum over shards completing it; aux loss).  The meshless
    path passes e0 = 0, e_loc = E."""
    t, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    idx, w, aux = _route(x, p.router_w, k)
    flat_e = idx.reshape(-1)                                  # (M = T K,)
    pos = _positions_in_expert(flat_e, e)
    cap = max(int(t * k * cfg.capacity_factor / e), 1)
    keep = pos < cap
    if e_loc != e:
        keep = keep & (flat_e >= e0) & (flat_e < e0 + e_loc)
    dump = e_loc * cap
    slot = torch.where(keep, (flat_e - e0) * cap + pos,
                       torch.full_like(pos, dump))
    tok = torch.arange(t, device=x.device).repeat_interleave(k)
    # Kept slots are distinct; every dropped one writes the dump slot,
    # which the experts never read (no mask indexing: its output shape
    # would depend on the data).
    tok_of_slot = torch.zeros(dump + 1, dtype=torch.long, device=x.device)
    tok_of_slot[slot] = tok
    filled = torch.zeros(dump + 1, dtype=torch.bool, device=x.device)
    filled[slot] = keep
    xg = x[tok_of_slot] * filled[:, None].to(x.dtype)
    y = _expert_ffn(xg[:dump].reshape(e_loc, cap, d), p.exp_wi_gate,
                    p.exp_wi_up, p.exp_wo, cfg.act, dtype)
    y_flat = torch.cat([y.reshape(dump, d), y.new_zeros(1, d)], 0)
    wv = (w.reshape(-1) * keep.float())[:, None]
    contrib = (y_flat[slot].float() * wv).reshape(t, k, d).sum(1)
    return contrib.to(dtype), aux


def _shared_ffn(p: MoE, xt, cfg, dtype):
    xt = xt.to(dtype)
    g = xt @ p.shared_wi_gate.to(dtype)
    u = xt @ p.shared_wi_up.to(dtype)
    return (_act(g, cfg.act) * u) @ p.shared_wo.to(dtype)


def moe_apply(p: MoE, x, cfg):
    """x (B, N, D) -> (out (B, N, D), aux loss).  Mesh-aware (see the
    module docstring)."""
    mesh = shd.current_mesh()
    if shd.is_dtensor(x) and mesh is not None \
            and "model" in mesh.mesh_dim_names:
        return _moe_mesh(p, x, cfg, mesh)
    b, n, d = x.shape
    dtype = cfg.cdtype
    xt = x.reshape(b * n, d)
    out, aux = _moe_local(xt, p, cfg, 0, cfg.n_experts, dtype)
    if cfg.n_shared_experts:
        out = out + _shared_ffn(p, xt, cfg, dtype)
    return out.reshape(b, n, d), aux


class _Weights:
    """The local weight shards under the MoE's parameter names."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def _moe_mesh(p: MoE, x, cfg, mesh):
    """The expert-parallel path under ``local_map`` (the reference's
    ``shard_map`` in ``repro.models.moe.moe_apply``)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    b, n, d = x.shape
    dtype = cfg.cdtype
    names = mesh.mesh_dim_names
    sizes = dict(zip(names, mesh.shape))
    ep = int(sizes["model"])
    if cfg.n_experts % ep:
        raise ValueError(f"{cfg.n_experts} experts do not split over "
                         f"model = {ep}")
    e_loc = cfg.n_experts // ep
    fsdp = tuple(a for a in ("pod", "data") if a in names)
    # Token rows over the largest batch-axis prefix that divides the rows.
    batch_axes, used = (), 1
    for a in fsdp:
        if b % (int(sizes[a]) * used) == 0:
            batch_axes += (a,)
            used *= int(sizes[a])
    scatter = n % ep == 0 and n > 1
    rank = mesh.get_local_rank(names.index("model"))
    n_avg = ep * used

    def pl(dim_of: dict, default=Replicate()):
        """Placements from {mesh axis: placement}."""
        return tuple(dim_of.get(a, default) for a in names)

    rows = {a: Shard(0) for a in batch_axes}
    part_rows = {a: Partial() for a in batch_axes}

    def local(xl, rw, wig, wiu, wog, swg=None, swu=None, swo=None):
        xt = xl.reshape(-1, d)
        w = _Weights(router_w=rw, exp_wi_gate=wig, exp_wi_up=wiu,
                     exp_wo=wog)
        out, aux = _moe_local(xt, w, cfg, rank * e_loc, e_loc, dtype)
        if swg is not None:
            # Shared experts as a TP-sharded dense MLP ('model' shards f).
            out = out + _shared_ffn(_Weights(shared_wi_gate=swg,
                                             shared_wi_up=swu,
                                             shared_wo=swo), xt, cfg, dtype)
        return out.reshape(xl.shape), aux / n_avg

    espec = pl({"model": Shard(0)})
    args = [x, p.router_w, p.exp_wi_gate, p.exp_wi_up, p.exp_wo]
    in_pl = [pl(rows), pl({}), espec, espec, espec]
    part_all = {**part_rows, "model": Partial()}
    grad_pl = [pl({**rows, "model": Partial()}), pl(part_all),
               pl({**part_rows, "model": Shard(0)})] + [
        pl({**part_rows, "model": Shard(0)})] * 2
    if cfg.n_shared_experts:
        args += [p.shared_wi_gate, p.shared_wi_up, p.shared_wo]
        in_pl += [pl({"model": Shard(1)})] * 2 + [pl({"model": Shard(0)})]
        grad_pl += [pl({**part_rows, "model": Shard(1)})] * 2 + [
            pl({**part_rows, "model": Shard(0)})]
    out, aux = local_map(
        local,
        out_placements=(pl({**rows, "model": Partial()}), pl(part_all)),
        in_placements=tuple(in_pl), in_grad_placements=tuple(grad_pl),
        device_mesh=mesh, redistribute_inputs=True)(
            *(shd.redistributed(a, p) for a, p in zip(args, in_pl)))
    out = out.redistribute(mesh, pl({**rows, "model": Shard(1)}) if scatter
                           else pl(rows))
    return out, aux.redistribute(mesh, pl({}))
