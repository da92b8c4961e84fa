"""Core library of the port: the paper's attention as PyTorch functions."""
from .attention import (AttnConfig, KVCache, LLNDecodeState, batch_alpha_beta,
                        commit_softmax, decode_lln, decode_lln_chunk,
                        decode_softmax, flash_softmax, multi_head_attention,
                        naive_softmax)
from .diag import block_diag_attn
from .engine import AttentionEngine, AttentionState
from .lln import LLNState, lln_bidir, lln_causal, lln_causal_scan
from .loglinear import LogLinState
from .moment_matching import (DEFAULT_A, DEFAULT_B, constants_for_dim,
                              fit_lln_constants, length_gain,
                              solve_alpha_beta)

__all__ = [
    "AttentionEngine", "AttentionState", "AttnConfig", "KVCache",
    "LLNDecodeState", "LLNState", "LogLinState", "batch_alpha_beta",
    "multi_head_attention", "flash_softmax", "naive_softmax",
    "decode_lln", "decode_lln_chunk", "decode_softmax", "commit_softmax",
    "block_diag_attn",
    "lln_bidir", "lln_causal", "lln_causal_scan", "DEFAULT_A", "DEFAULT_B",
    "constants_for_dim", "fit_lln_constants", "length_gain",
    "solve_alpha_beta",
]
