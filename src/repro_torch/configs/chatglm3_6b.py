"""chatglm3-6b [arXiv:2406.12793; hf] — dense GQA (kv=2), half-rotary ("2d") RoPE.

28L, d_model=4096, 32H, d_ff=13696, vocab=65024.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="chatglm3-6b", family="dense",
    n_layers=28, d_model=4096, n_heads=32, n_kv_heads=2, head_dim=128,
    d_ff=13696, vocab=65024, rotary_pct=0.5, attn_shard="tp_heads",
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
    vocab=512, diag_block=16, lln_chunk=16, softmax_chunk=32, remat="none")
