"""stablelm-1.6b [hf:stabilityai/stablelm-2-1_6b; unverified] — dense MHA, partial RoPE.

24L, d_model=2048, 32H (kv=32), d_ff=5632, vocab=100352, LayerNorm,
rotary_pct=0.25.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="stablelm-1.6b", family="dense",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
    d_ff=5632, vocab=100352, norm="layernorm", rotary_pct=0.25,
    attn_shard="tp_heads",
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128,
    vocab=512, diag_block=16, lln_chunk=16, softmax_chunk=32, remat="none")
