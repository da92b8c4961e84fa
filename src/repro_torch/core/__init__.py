"""Core library of the port: the paper's attention as PyTorch functions."""
from .attention import LLNDecodeState, batch_alpha_beta, decode_lln_chunk
from .diag import block_diag_attn
from .engine import AttentionEngine, AttentionState
from .lln import LLNState, lln_causal_scan
from .moment_matching import (DEFAULT_A, DEFAULT_B, constants_for_dim,
                              length_gain, solve_alpha_beta)

__all__ = [
    "AttentionEngine", "AttentionState", "LLNDecodeState", "LLNState",
    "batch_alpha_beta", "decode_lln_chunk", "block_diag_attn",
    "lln_causal_scan", "DEFAULT_A", "DEFAULT_B",
    "constants_for_dim", "length_gain", "solve_alpha_beta",
]
