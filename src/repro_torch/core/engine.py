"""The AttentionEngine: one spec, one state, one serving lifecycle.

Port of ``repro.core.engine``: :class:`AttentionState` holds one layer's
decode state, the softmax KV cache (``k``/``v``/``len``) or the LLN state
(``s``/``z``/``c_k``) with the §4.2 diag tails at the G kv heads or the
log-linear bucket pyramid, the per-row position and calibration;
:class:`AttentionEngine` binds an
:class:`~repro_torch.kernels.registry.AttnSpec` to a layer's head geometry
and runs ``init_state -> prefill -> decode*``, with ``verify`` / ``commit``
for speculative decoding, ``check_health`` and ``evict`` for the serving
pool, and the stateless full-sequence ``attention``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.configs.base import torch_dtype
from repro_torch.kernels import registry as kreg
from repro_torch.kernels.registry import AttnSpec
from repro_torch.tree import map_with_path
from . import health as health_mod
from . import moment_matching as mm
from repro_torch.distributed.sharding import is_dtensor, map_rows
from .attention import (AttnConfig, KVCache, LLNDecodeState,
                        batch_alpha_beta, commit_lln_chunk, commit_softmax,
                        decode_lln_chunk, decode_softmax,
                        multi_head_attention)
from .lln import LLNState, commit_lengths, full_commit
from .loglinear import LogLinState


@dataclasses.dataclass
class AttentionState:
    """Per-layer decode state; the fields an impl does not use are None.

    ``softmax``: k/v (B,S,G,D[v]) the KV cache in the compute dtype, S the
    capacity, and len (B,) int32 its filled length.  The LLN impls: s
    (B,H,D,Dv) fp32, z (B,H,D) fp32, c_k (B,1,H,1) fp32, pos (B,) int32,
    alpha/beta (B,H) fp32 (beta repeated from the G groups), log_scale
    (B,H) fp32; ``lln``/``lln_diag`` also tail_k/tail_v (B,BLK,G,D[v]) in
    the compute dtype.  ``log_linear``: (s, z, c_k) is the open bucket and
    sl (B,L,H,D,Dv), zl (B,L,H,D), cl (B,L,H) fp32 the Fenwick pyramid;
    occupancy comes from ``pos`` (``core/loglinear.py:occupancy``).  MLA's
    absorbed softmax decode (``models/mla.py``): ckv (B,S,kv_lora) and kr
    (B,S,rd), the latent cache in the compute dtype, and len (B,) int32.
    """
    k: Optional[torch.Tensor] = None
    v: Optional[torch.Tensor] = None
    len: Optional[torch.Tensor] = None
    s: Optional[torch.Tensor] = None
    z: Optional[torch.Tensor] = None
    c_k: Optional[torch.Tensor] = None
    pos: Optional[torch.Tensor] = None
    alpha: Optional[torch.Tensor] = None
    beta: Optional[torch.Tensor] = None
    log_scale: Optional[torch.Tensor] = None
    tail_k: Optional[torch.Tensor] = None
    tail_v: Optional[torch.Tensor] = None
    sl: Optional[torch.Tensor] = None
    zl: Optional[torch.Tensor] = None
    cl: Optional[torch.Tensor] = None
    ckv: Optional[torch.Tensor] = None
    kr: Optional[torch.Tensor] = None

    def __getitem__(self, name: str):
        """Dict-style read (``state["pos"]``), as the reference's legacy
        cache dicts; ``KeyError`` for a name that is not a field."""
        if name not in _STATE_FIELDS:
            raise KeyError(name)
        return getattr(self, name)

    def replace(self, **kw) -> "AttentionState":
        return dataclasses.replace(self, **kw)


_STATE_FIELDS = tuple(f.name for f in dataclasses.fields(AttentionState))


def _tail_of(t: torch.Tensor, n: int, blk: int) -> torch.Tensor:
    """Contents of the (partially filled) last ``blk``-sized block."""
    nb = -(-n // blk)
    pad = nb * blk - n
    return torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad))[:, (nb - 1) * blk:]


@dataclasses.dataclass(frozen=True)
class AttentionEngine:
    """One attention configuration bound to one layer's head geometry."""
    spec: AttnSpec
    heads: int
    kv_heads: int
    head_dim: int
    v_dim: int

    @property
    def state_dtype(self) -> torch.dtype:
        return torch_dtype(self.spec.precision)

    @classmethod
    def from_cfg(cls, cfg, causal: bool = True, *,
                 heads: Optional[int] = None, kv_heads: Optional[int] = None,
                 head_dim: Optional[int] = None,
                 v_dim: Optional[int] = None) -> "AttentionEngine":
        """The engine of an ``ArchConfig`` attention layer, causal or
        bidirectional; the head geometry defaults to the config's and can
        be overridden (MLA binds ``heads = kv_heads = H``, its assembled
        ``nope + rope`` q/k width and its own ``v_dim``)."""
        h = heads if heads is not None else cfg.n_heads
        g = kv_heads if kv_heads is not None else cfg.n_kv_heads
        d = head_dim if head_dim is not None else cfg.hd
        return cls(spec=AttnSpec.from_cfg(cfg, causal=causal, r=h // g),
                   heads=h, kv_heads=g, head_dim=d,
                   v_dim=v_dim if v_dim is not None else d)

    def init_state(self, batch: int, device, max_len: int) -> AttentionState:
        """Zeroed decode state for ``batch`` rows (per-row counters and
        calibration); the softmax KV cache holds ``max_len`` positions, the
        LLN impls ignore it."""
        h, g, d, dv = self.heads, self.kv_heads, self.head_dim, self.v_dim
        if self.spec.impl == "softmax":
            return AttentionState(
                k=torch.zeros(batch, max_len, g, d, dtype=self.state_dtype,
                              device=device),
                v=torch.zeros(batch, max_len, g, dv, dtype=self.state_dtype,
                              device=device),
                len=torch.zeros(batch, dtype=torch.int32, device=device))
        f32 = dict(dtype=torch.float32, device=device)
        common = dict(
            s=torch.zeros(batch, h, d, dv, **f32),
            z=torch.zeros(batch, h, d, **f32),
            c_k=torch.zeros(batch, 1, h, 1, **f32),
            pos=torch.zeros(batch, dtype=torch.int32, device=device),
            alpha=torch.ones(batch, h, **f32),
            beta=torch.ones(batch, h, **f32),
            log_scale=torch.zeros(batch, h, **f32))
        if self.spec.impl == "log_linear":
            ls = self.spec.num_scales
            return AttentionState(
                **common, sl=torch.zeros(batch, ls, h, d, dv, **f32),
                zl=torch.zeros(batch, ls, h, d, **f32),
                cl=torch.zeros(batch, ls, h, **f32))
        blk = self.spec.diag_block
        return AttentionState(
            **common,
            tail_k=torch.zeros(batch, blk, g, d, dtype=self.state_dtype,
                               device=device),
            tail_v=torch.zeros(batch, blk, g, dv, dtype=self.state_dtype,
                               device=device))

    def calibrate(self, q, k, n: Optional[int] = None):
        """Moment-matched (alpha, beta) per ``spec.calibration``: ``batch``
        pools the statistics ((H,), (G,)), ``per_row`` measures each row
        alone ((B, H), (B, G))."""
        return batch_alpha_beta(q, k, self.spec,
                                per_row=self.spec.calibration == "per_row",
                                n=n)

    def _length_gain(self, n):
        """beta(n) schedule gain at depth ``n``; None when it is off (and
        for softmax, which has no calibration)."""
        if self.spec.beta_n <= 0.0 or self.spec.impl == "softmax":
            return None
        return mm.length_gain(n, self.spec.beta_n, self.spec.calib_len)

    def attention(self, q, k, v, *, mask=None, alpha=None, beta=None,
                  prefix_len: int = 0):
        """Stateless full-sequence attention (training, scoring).  q:
        (B,N,H,D); k/v: (B,N,G,D[v]).  ``softmax``: the naive quadratic
        for backend ``ref``, the online softmax otherwise.  The LLN impls
        calibrate here per ``spec.calibration`` (with the beta(n) gain at
        N) unless ``alpha``/``beta`` are given, then run
        ``core/attention.py:multi_head_attention`` under ``spec.backend``
        (``ref`` is the core scan).  ``mask`` (B, N) key validity;
        ``prefix_len``: keys below it are visible to every query (the
        prefix-LM mask; the LLN impls approximate it causally, as in the
        reference)."""
        spec = self.spec
        if spec.impl == "softmax":
            return kreg.softmax_attention(spec, q, k, v, mask=mask,
                                          prefix_len=prefix_len)
        if alpha is None or beta is None:
            # Calibrate here, so that spec.calibration="per_row" holds for
            # the full-sequence forward too.
            alpha, beta = self.calibrate(q, k, n=q.shape[1])
            gain = self._length_gain(q.shape[1])
            if gain is not None:
                alpha = torch.as_tensor(alpha, dtype=torch.float32) * gain
                beta = torch.as_tensor(beta, dtype=torch.float32) * gain
        acfg = AttnConfig(
            impl=spec.impl, causal=spec.causal, diag_block=spec.diag_block,
            lln_chunk=spec.lln_chunk, softmax_chunk=spec.softmax_chunk,
            use_kernel=spec.backend != "ref",
            backend=None if spec.backend == "auto" else spec.backend,
            fixed_ab=spec.fixed_ab, num_scales=spec.num_scales,
            scale_decay=spec.scale_decay)
        return multi_head_attention(q, k, v, acfg, mask=mask, alpha=alpha,
                                    beta=beta, prefix_len=prefix_len)

    def prefill(self, q, k, v, *, max_len: int = 0, prefix_len: int = 0,
                alpha=None, beta=None):
        """Causal forward over the prompt; returns ``(out, state)``.
        q: (B,N,H,D); k/v: (B,N,G,D[v]).  ``softmax``: the prompt's k/v
        become the KV cache, zero-padded to ``max(max_len, N)`` positions
        for the tokens decode appends.  The LLN outputs and the
        O(d^2) state come from one pass (``log_linear``: the open bucket and
        the bucket pyramid); ``lln_diag`` averages in the block-diag
        softmax.  ``prefix_len``: the prefix-LM mask of the softmax
        prefill (the LLN impls ignore it, as in the reference).
        ``alpha``/``beta`` override the calibration."""
        if is_dtensor(q):
            from repro_torch.distributed import local_attention
            return local_attention.prefill(self, q, k, v, max_len=max_len,
                                           prefix_len=prefix_len,
                                           alpha=alpha, beta=beta)
        b, n, h, _ = q.shape
        g = k.shape[2]
        spec = self.spec
        if spec.impl == "softmax":
            out = kreg.softmax_attention(spec, q, k, v,
                                         prefix_len=prefix_len)
            pad = (0, 0, 0, 0, 0, max(max_len, n) - n)
            return out, AttentionState(
                k=torch.nn.functional.pad(k.to(self.state_dtype), pad),
                v=torch.nn.functional.pad(v.to(self.state_dtype), pad),
                len=torch.full((b,), n, dtype=torch.int32, device=q.device))
        if alpha is None or beta is None:
            alpha, beta = self.calibrate(q, k, n=n)
        # The prefill runs at the prompt-length temperature; the state keeps
        # the base calibration and decode re-derives the gain from pos.
        gain = self._length_gain(n)
        use_alpha, use_beta = alpha, beta
        if gain is not None:
            use_alpha = torch.as_tensor(alpha, dtype=torch.float32) * gain
            use_beta = torch.as_tensor(beta, dtype=torch.float32) * gain
        f32 = dict(dtype=torch.float32, device=q.device)
        beta_h = torch.as_tensor(beta, **f32)
        if beta_h.shape[-1] == g and g != h:
            beta_h = torch.repeat_interleave(beta_h, h // g, dim=-1)
        common = dict(
            pos=torch.full((b,), n, dtype=torch.int32, device=q.device),
            alpha=torch.as_tensor(alpha, **f32).expand(b, h).clone(),
            beta=beta_h.expand(b, h).clone(),
            log_scale=torch.zeros(b, h, **f32))
        if spec.impl == "log_linear":
            out, s, z, c_k, sl, zl, cl = kreg.loglin_prefill(
                spec, q, k, v, use_alpha, use_beta)
            return out, AttentionState(s=s, z=z, c_k=c_k, sl=sl, zl=zl,
                                       cl=cl, **common)
        lln_out, s, z, c_k = kreg.prefill(spec, q, k, v, use_alpha, use_beta)
        if spec.impl == "lln_diag":
            diag_out = kreg.diag_fwd(spec, q, k, v)
            out = (0.5 * (lln_out.float() + diag_out.float())).to(v.dtype)
        else:
            out = lln_out
        blk = spec.diag_block
        state = AttentionState(
            s=s, z=z, c_k=c_k,
            tail_k=_tail_of(k, n, blk).to(self.state_dtype),
            tail_v=_tail_of(v, n, blk).to(self.state_dtype), **common)
        return out, state

    def decode(self, state: AttentionState, q, k, v, *, row_mask=None,
               commit_len=None):
        """Advance ``state`` over T >= 1 new tokens; returns
        ``(out (B,T,H,Dv), new state)``.  ``softmax`` writes the new k/v at
        each row's ``len`` in a new cache; the state passed in is not
        modified.

        ``row_mask`` (B,) bool: masked rows advance nothing (their outputs
        are to be discarded).  ``commit_len`` (B,) int in [0, T]: all T
        positions are scored, only the accepted prefix folds into the state
        (0 is the masked row, T a plain decode).  The LLN impls apply
        ``spec.renorm``, the drift renorm, to the rows that fold a token."""
        if is_dtensor(q):
            from repro_torch.distributed import local_attention
            return local_attention.decode(self, state, q, k, v,
                                          row_mask=row_mask,
                                          commit_len=commit_len)
        if self.spec.impl == "softmax":
            out, kv = decode_softmax(KVCache(k=state.k, v=state.v,
                                             length=state.len), q, k, v,
                                     chunk=self.spec.softmax_chunk,
                                     row_mask=row_mask,
                                     commit_len=commit_len)
            return out, state.replace(k=kv.k, v=kv.v, len=kv.length)
        alpha_d, beta_d = state.alpha, state.beta
        gain = self._length_gain(state.pos)
        if gain is not None:
            gain = gain.to(state.alpha.device)[..., None]
            alpha_d, beta_d = state.alpha * gain, state.beta * gain
        if self.spec.impl == "log_linear":
            st = LogLinState(s=state.s, z=state.z, c_k=state.c_k,
                             sl=state.sl, zl=state.zl, cl=state.cl,
                             log_scale=state.log_scale)
            out, st2 = kreg.decode_chunk(self.spec, st, q, k, v, alpha_d,
                                         beta_d, pos=state.pos,
                                         row_mask=row_mask,
                                         commit_len=commit_len)
            t = q.shape[1]
            adv = commit_lengths(commit_len, row_mask, t)
            return out, state.replace(
                s=st2.s, z=st2.z, c_k=st2.c_k, sl=st2.sl, zl=st2.zl,
                cl=st2.cl, log_scale=st2.log_scale, pos=state.pos + adv)
        st = LLNDecodeState(
            lln=LLNState(s=state.s, z=state.z, c_k=state.c_k,
                         log_scale=state.log_scale),
            tail_k=state.tail_k, tail_v=state.tail_v, pos=state.pos)
        out, st2 = decode_lln_chunk(st, q, k, v, alpha_d, beta_d,
                                    impl=self.spec.impl,
                                    backend=self.spec.backend,
                                    row_mask=row_mask, commit_len=commit_len,
                                    renorm=self.spec.renorm or None)
        return out, state.replace(
            s=st2.lln.s, z=st2.lln.z, c_k=st2.lln.c_k,
            log_scale=st2.lln.log_scale, tail_k=st2.tail_k,
            tail_v=st2.tail_v, pos=st2.pos)

    def verify(self, state: AttentionState, q, k, v, *, commit_len,
               row_mask=None, return_residuals: bool = False):
        """Speculative verify: score a T-token draft chunk, commit only the
        accepted prefix.  :meth:`decode` with ``commit_len`` (B,) required:
        the outputs cover all T positions, the state folds only tokens
        ``j < commit_len[b]`` (0 is the masked row, T a plain decode).

        ``return_residuals=True`` also returns the chunk's post-RoPE
        ``{"k", "v"}`` (B,T,G,D[v]).  A ``commit_len=0`` score leaves the
        state as it was, so the single-pass verify is: score once with
        ``commit_len=0`` and the residuals, run the acceptance rule on the
        logits, then fold the accepted prefix with :meth:`commit`."""
        if commit_len is None:
            raise ValueError("verify requires commit_len; use decode for "
                             "an unconditional advance")
        out, st = self.decode(state, q, k, v, row_mask=row_mask,
                              commit_len=commit_len)
        if return_residuals:
            return out, st, {"k": k, "v": v}
        return out, st

    def commit(self, state: AttentionState, residual: dict, *, commit_len,
               row_mask=None) -> AttentionState:
        """Fold a scored chunk's accepted prefix into ``state``: the second
        half of the single-pass speculative verify, O(T d^2) per layer.
        ``residual``: the ``{"k", "v"}`` a ``commit_len=0`` :meth:`verify`
        returned against this ``state``.  The same state, bit for bit, as
        :meth:`decode` with this ``commit_len`` on the same backend; the
        beta(n) gain is derived from ``state.pos`` as the score pass
        derived it (``pos`` did not advance).  A DTensor residual (the
        score ran on a mesh) goes to ``local_attention.commit``."""
        k, v = residual["k"], residual["v"]
        if is_dtensor(k):
            from repro_torch.distributed import local_attention
            return local_attention.commit(self, state, residual,
                                          commit_len=commit_len,
                                          row_mask=row_mask)
        spec = self.spec
        if spec.impl == "softmax":
            kv = commit_softmax(KVCache(k=state.k, v=state.v,
                                        length=state.len), k, v,
                                commit_len=commit_len, row_mask=row_mask)
            return state.replace(k=kv.k, v=kv.v, len=kv.length)
        beta_d = state.beta
        gain = self._length_gain(state.pos)
        if gain is not None:
            beta_d = state.beta * gain.to(state.beta.device)[..., None]
        if spec.impl == "log_linear":
            st = LogLinState(s=state.s, z=state.z, c_k=state.c_k,
                             sl=state.sl, zl=state.zl, cl=state.cl,
                             log_scale=state.log_scale)
            st2 = kreg.commit_chunk(spec, st, k, v, beta_d,
                                    row_mask=row_mask,
                                    commit_len=commit_len, pos=state.pos)
            t = k.shape[1]
            adv = commit_lengths(commit_len if commit_len is not None
                                 else full_commit(t, k), row_mask, t)
            return state.replace(
                s=st2.s, z=st2.z, c_k=st2.c_k, sl=st2.sl, zl=st2.zl,
                cl=st2.cl, log_scale=st2.log_scale, pos=state.pos + adv)
        st = LLNDecodeState(
            lln=LLNState(s=state.s, z=state.z, c_k=state.c_k,
                         log_scale=state.log_scale),
            tail_k=state.tail_k, tail_v=state.tail_v, pos=state.pos)
        st2 = commit_lln_chunk(st, k, v, beta_d, impl=spec.impl,
                               commit_len=commit_len, row_mask=row_mask,
                               backend=spec.backend,
                               renorm=spec.renorm or None)
        return state.replace(
            s=st2.lln.s, z=st2.lln.z, c_k=st2.lln.c_k,
            log_scale=st2.lln.log_scale, tail_k=st2.tail_k,
            tail_v=st2.tail_v, pos=st2.pos)

    def check_health(self, state: AttentionState, *,
                     config: Optional[health_mod.HealthConfig] = None
                     ) -> dict:
        """Per-row state-health flags (the serving sentinel hook):
        ``{"unhealthy", "nonfinite", "magnitude", "calib"}``, each a (B,)
        bool over the state's rows (``core/health.py``).  A freshly evicted
        row (zeros, alpha = beta = 1) is healthy by construction."""
        cfg = config if config is not None else health_mod.HealthConfig()
        return health_mod.row_health(state, config=cfg)

    def evict(self, state: AttentionState, rows) -> AttentionState:
        """Reset the given rows (freed slots) of every state leaf to their
        ``init_state`` values; the state passed in is not modified.

        ``rows``: slot indices, or a (B,) bool mask of the rows to clear.
        Every leaf resets to zero except the per-row calibration
        ``alpha``/``beta``, which resets to one (its init value): a
        previous request's constants must never reach the next request
        admitted to that slot."""
        return evict_rows(state, rows)


def evict_rows(tree, rows):
    """:meth:`AttentionEngine.evict` over any decode-state tree whose
    leaves carry the rows on axis 0 (one state, or a model's per-layer
    caches).  A DTensor leaf (a pool on a mesh) is cleared on each rank's
    shard, at the rows it holds."""
    def clear(path, leaf):
        fill = 1 if path[-1] in ("alpha", "beta") else 0
        if is_dtensor(leaf):
            mask = rows_mask(rows, leaf.shape[0], leaf.device)
            return map_rows(leaf, lambda loc, idx: loc.masked_fill(
                mask[idx].reshape((-1,) + (1,) * (loc.ndim - 1)), fill))
        if torch.is_tensor(rows) and rows.dtype == torch.bool:
            return leaf.masked_fill(rows.to(leaf.device).reshape(
                (-1,) + (1,) * (leaf.ndim - 1)), fill)
        out = leaf.clone()
        out[torch.as_tensor(rows, dtype=torch.long,
                            device=leaf.device)] = fill
        return out
    return map_with_path(clear, tree)


def rows_mask(rows, n: int, device) -> torch.Tensor:
    """(n,) bool: ``rows`` given as slot indices or as a bool mask."""
    if torch.is_tensor(rows) and rows.dtype == torch.bool:
        return rows.to(device)
    mask = torch.zeros(n, dtype=torch.bool, device=device)
    mask[torch.as_tensor(rows, dtype=torch.long, device=device)] = True
    return mask
