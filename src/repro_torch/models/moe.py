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

The reference's expert-parallel path over a mesh (a shard_map with
expert-sharded weights and a psum) is ROADMAP.md item 12; the port runs
this meshless path on one device.  Parameter names are the reference's
(``router_w``, ``exp_wi_gate``, ``exp_wi_up``, ``exp_wo``,
``shared_wi_gate``, ``shared_wi_up``, ``shared_wo``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

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


def _moe_local(x, p: MoE, cfg, dtype):
    """Dispatch, the experts and the weighted combine for tokens x (T, D);
    returns ((T, D) in ``dtype``, aux loss)."""
    t, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    idx, w, aux = _route(x, p.router_w, k)
    flat_e = idx.reshape(-1)                                  # (M = T K,)
    pos = _positions_in_expert(flat_e, e)
    cap = max(int(t * k * cfg.capacity_factor / e), 1)
    keep = pos < cap
    dump = e * cap
    slot = torch.where(keep, flat_e * cap + pos, torch.full_like(pos, dump))
    tok = torch.arange(t, device=x.device).repeat_interleave(k)
    tok_of_slot = torch.zeros(dump + 1, dtype=torch.long, device=x.device)
    tok_of_slot[slot[keep]] = tok[keep]
    filled = torch.zeros(dump + 1, dtype=torch.bool, device=x.device)
    filled[slot[keep]] = True
    xg = x[tok_of_slot] * filled[:, None].to(x.dtype)
    y = _expert_ffn(xg[:dump].reshape(e, cap, d), p.exp_wi_gate,
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
    """x (B, N, D) -> (out (B, N, D), aux loss)."""
    b, n, d = x.shape
    dtype = cfg.cdtype
    xt = x.reshape(b * n, d)
    out, aux = _moe_local(xt, p, cfg, dtype)
    if cfg.n_shared_experts:
        out = out + _shared_ffn(p, xt, cfg, dtype)
    return out.reshape(b, n, d), aux
