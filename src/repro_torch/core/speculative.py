"""Draft-then-verify speculative decoding: the acceptance rules (port of
``repro.core.speculative``).

A cheap draft model proposes ``k`` tokens; the target scores the chunk
``[tok, d_1, ..., d_k]`` in one pass, so its logits at input position ``i``
predict the token after ``d_i`` (position 0 predicts ``d_1``'s
replacement).  This module holds only the acceptance math; the state side
(score every position, fold only the accepted prefix) is the
``commit_len`` contract of
:meth:`repro_torch.core.engine.AttentionEngine.verify` / ``commit``, and
the loop is ``launch/steps.py:make_spec_setup``.

Both rules return ``(n_accept, next_token, commit_len)``:

* ``n_accept`` (B,): accepted drafts per row (0..k);
* ``next_token`` (B,): the target's correction at the first rejected
  position, or its bonus token when every draft survived, so a row emits
  ``n_accept + 1`` tokens per verify;
* ``commit_len`` (B,) = ``n_accept + 1``: the chunk inputs whose keys
  commit (``tok`` and the accepted drafts; ``next_token``'s key folds when
  it is fed as the next chunk's first input).

Greedy acceptance reproduces the target's greedy sequence token for token;
residual resampling keeps the target's sampling distribution.

Randomness comes from an explicit ``torch.Generator`` where the reference
takes a PRNG key, so the sampled draws cannot equal JAX's bit for bit: the
sampling rule is held by its distribution, and the deterministic rules
(:func:`greedy_verify`, :func:`emit_tokens`) equal the reference's
exactly.
"""
from __future__ import annotations

from typing import Optional

import torch

_TINY = 1e-30


def greedy_verify(draft_tokens: torch.Tensor, target_logits: torch.Tensor):
    """Keep the longest draft prefix that matches the target's argmax.

    draft_tokens: (B, k) int; target_logits: (B, k+1, V), where
    ``target_logits[:, i]`` predicts the token after chunk input ``i``.
    Returns ``(n_accept (B,), next_token (B,), commit_len (B,))``.
    """
    k = draft_tokens.shape[1]
    tgt = torch.argmax(target_logits, dim=-1).to(draft_tokens.dtype)
    match = (draft_tokens == tgt[:, :k]).to(torch.int32)
    # cumprod zeroes everything after the first mismatch; its sum is the
    # matching prefix's length.
    n_accept = torch.cumprod(match, dim=1).sum(dim=1).to(torch.int32)
    next_token = torch.gather(tgt, 1, n_accept[:, None].long())[:, 0]
    return n_accept, next_token, n_accept + 1


def residual_verify(draft_tokens: torch.Tensor, draft_logits: torch.Tensor,
                    target_logits: torch.Tensor,
                    generator: Optional[torch.Generator],
                    temperature: float):
    """Speculative sampling with residual resampling (Chen et al. 2023).

    Draft ``d_i ~ q_i`` is accepted with probability ``min(1, p_i(d_i) /
    q_i(d_i))`` (``p`` the target's distribution there); at the first
    rejection the replacement is drawn from the renormalized residual
    ``(p_i - q_i)^+`` (from ``p_i`` itself where the residual vanishes),
    and on full acceptance the bonus token from ``p_{k+1}``.

    draft_tokens (B, k); draft_logits (B, k, V), the logits each draft was
    sampled from; target_logits (B, k+1, V); ``generator`` drives the
    accept coins and the draws; temperature > 0.
    Returns ``(n_accept (B,), next_token (B,), commit_len (B,))``.
    """
    if temperature <= 0:
        raise ValueError("residual_verify requires temperature > 0; "
                         "use greedy_verify for greedy decoding")
    b, k = draft_tokens.shape
    p = torch.softmax(target_logits[:, :k].float() / temperature, dim=-1)
    q = torch.softmax(draft_logits.float() / temperature, dim=-1)
    idx = draft_tokens[:, :, None].long()
    p_d = torch.gather(p, 2, idx)[..., 0]                       # (B, k)
    q_d = torch.gather(q, 2, idx)[..., 0]
    u = torch.rand(b, k, generator=generator, device=p.device)
    accept = u < torch.clamp(p_d / torch.clamp(q_d, min=_TINY), max=1.0)
    n_accept = torch.cumprod(accept.to(torch.int32), dim=1).sum(dim=1) \
        .to(torch.int32)
    # The residual at the first rejected position (clamped to k-1: unused
    # when every draft survived).
    j = torch.clamp(n_accept, max=k - 1).long()[:, None, None]
    j = j.expand(b, 1, p.shape[-1])
    p_j = torch.gather(p, 1, j)[:, 0]                           # (B, V)
    q_j = torch.gather(q, 1, j)[:, 0]
    residual = torch.clamp(p_j - q_j, min=0.0)
    norm = residual.sum(dim=-1, keepdim=True)
    residual = torch.where(norm > _TINY,
                           residual / torch.clamp(norm, min=_TINY), p_j)
    resampled = torch.multinomial(residual, 1, generator=generator)[:, 0]
    bonus_p = torch.softmax(target_logits[:, k].float() / temperature, -1)
    bonus = torch.multinomial(bonus_p, 1, generator=generator)[:, 0]
    next_token = torch.where(n_accept == k, bonus, resampled) \
        .to(draft_tokens.dtype)
    return n_accept, next_token, n_accept + 1


def verify_tokens(draft_tokens: torch.Tensor, target_logits: torch.Tensor,
                  temperature: float,
                  generator: Optional[torch.Generator] = None,
                  draft_logits: Optional[torch.Tensor] = None):
    """The one acceptance entry point: greedy at ``temperature == 0``,
    residual resampling otherwise (``draft_logits`` then required; the
    ``generator`` may be None, torch's default generator)."""
    if temperature <= 0:
        return greedy_verify(draft_tokens, target_logits)
    if draft_logits is None:
        raise ValueError("temperature sampling requires draft_logits")
    return residual_verify(draft_tokens, draft_logits, target_logits,
                           generator, temperature)


def emit_tokens(draft_tokens: torch.Tensor, n_accept: torch.Tensor,
                next_token: torch.Tensor) -> torch.Tensor:
    """One verify step's emitted tokens in a fixed (B, k+1) buffer: the
    accepted drafts, then ``next_token``; slots past ``n_accept + 1`` are
    zero padding, to be masked with the emit count."""
    b, k = draft_tokens.shape
    slots = torch.arange(k + 1, device=draft_tokens.device)[None, :]
    padded = torch.cat([draft_tokens, draft_tokens.new_zeros(b, 1)], dim=1)
    out = torch.where(slots < n_accept[:, None], padded,
                      torch.zeros_like(padded))
    return torch.where(slots == n_accept[:, None],
                       next_token[:, None].to(padded.dtype), out)


__all__ = ["greedy_verify", "residual_verify", "verify_tokens",
           "emit_tokens"]
