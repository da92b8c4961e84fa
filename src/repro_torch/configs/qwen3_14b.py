"""qwen3-14b [hf:Qwen/Qwen3-14B; hf] — dense GQA with qk_norm.

40L, d_model=5120, 40H (kv=8, head_dim 128), d_ff=17408, vocab=151936,
rope_theta 1e6.  The reference's file cites Qwen/Qwen3-8B; its numbers are
Qwen3-14B's, and so are these.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-14b", family="dense",
    n_layers=40, d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128,
    d_ff=17408, vocab=151936, qk_norm=True, rope_theta=1e6,
    attn_shard="context",
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
    vocab=512, diag_block=16, lln_chunk=16, softmax_chunk=32, remat="none")
