"""Core library of the port: the paper's attention as PyTorch functions."""
from .attention import (AttnConfig, LLNDecodeState, batch_alpha_beta,
                        decode_lln_chunk, multi_head_attention)
from .diag import block_diag_attn
from .engine import AttentionEngine, AttentionState
from .lln import LLNState, lln_bidir, lln_causal_scan
from .loglinear import LogLinState
from .moment_matching import (DEFAULT_A, DEFAULT_B, constants_for_dim,
                              length_gain, solve_alpha_beta)

__all__ = [
    "AttentionEngine", "AttentionState", "AttnConfig", "LLNDecodeState",
    "LLNState", "LogLinState", "batch_alpha_beta", "decode_lln_chunk",
    "multi_head_attention", "block_diag_attn",
    "lln_bidir", "lln_causal_scan", "DEFAULT_A", "DEFAULT_B",
    "constants_for_dim", "length_gain", "solve_alpha_beta",
]
