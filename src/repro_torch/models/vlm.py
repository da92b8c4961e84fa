"""PaliGemma-style VLM (port of ``repro.models.vlm``): a SigLIP patch stub
and the gemma decoder.

The vision frontend is a stub, as in the reference: the batch carries
precomputed patch embeddings (B, num_prefix_tokens, frontend_dim), and a
linear ``patch_proj`` maps them into the decoder's embedding space.  The
decoder is the transformer (MQA kv = 1, GeGLU, embedding scaling) with a
prefix-LM mask: patch positions attend bidirectionally under ``softmax``,
text causally; the LLN impls take the prefix causally (the reference's
approximation).
"""
from __future__ import annotations

import torch
from torch import nn

from .layers import _dense_param, dense
from .transformer import (DenseLM, lm_cache_init, lm_decode, lm_hidden,
                          lm_prefill)


class VLM(DenseLM):
    """The decoder's parameters plus ``patch_proj`` (frontend_dim,
    d_model)."""

    def __init__(self, cfg, device, generator=None):
        super().__init__(cfg, device, generator)
        self.patch_proj = _dense_param(cfg.frontend_dim, cfg.d_model,
                                       cfg.pdtype, device, generator)


def vlm_init(cfg, device, seed: int = 0) -> VLM:
    """Random parameters with the reference's shapes and names, drawn from
    a ``torch.Generator`` seeded with ``seed`` on ``device``."""
    gen = None                 # seed None: an abstract init (FakeTensorMode)
    if seed is not None:
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
    return VLM(cfg, device, gen)


def vlm_hidden(p: VLM, patches, tokens, cfg):
    """patches (B, P, frontend_dim), tokens (B, N) -> the hidden states of
    the text positions (the prefix stripped) and the aux loss."""
    prefix = dense(p.patch_proj, patches, cfg.cdtype)
    h, aux = lm_hidden(p, tokens, cfg, prefix_embed=prefix)
    return h[:, patches.shape[1]:], aux


def vlm_prefill(p: VLM, patches, tokens, cfg, max_len: int):
    """Prompt forward over the patch prefix and the text; returns (last
    logits, caches).  Decode continues at position P + N."""
    with torch.inference_mode():
        prefix = dense(p.patch_proj, patches, cfg.cdtype)
    return lm_prefill(p, tokens, cfg, max_len, prefix_embed=prefix)


vlm_decode = lm_decode
vlm_cache_init = lm_cache_init
