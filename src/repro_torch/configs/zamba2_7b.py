"""zamba2-7b [arXiv:2411.15242; unverified] — Mamba2 backbone + shared attention block.

81L mamba2 (d_inner=7168, head_dim 64 -> 112 heads, state 64) with a shared
transformer block (32H MHA, d_ff=14336) applied every 6 layers on
concat(hidden, embedding); d_model=3584, vocab=32000.  LLN applies to the
shared attention block.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-7b", family="hybrid",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32, head_dim=112,
    d_ff=14336, vocab=32000, ssm_state=64, ssm_expand=2, ssm_head_dim=64,
    ssm_groups=1, shared_attn_period=6, attn_shard="tp_heads",
)

SMOKE = CONFIG.replace(
    n_layers=5, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128,
    vocab=512, ssm_state=16, ssm_head_dim=32, shared_attn_period=2,
    ssm_chunk=16, diag_block=16, lln_chunk=16, softmax_chunk=32, remat="none")
