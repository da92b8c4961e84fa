"""yi-9b [arXiv:2403.04652; hf] — llama-arch dense GQA.

48L, d_model=4096, 32H (kv=4), d_ff=11008, vocab=64000.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="yi-9b", family="dense",
    n_layers=48, d_model=4096, n_heads=32, n_kv_heads=4, head_dim=128,
    d_ff=11008, vocab=64000, rope_theta=5e6, attn_shard="tp_heads",
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
    vocab=512, diag_block=16, lln_chunk=16, softmax_chunk=32, remat="none")
