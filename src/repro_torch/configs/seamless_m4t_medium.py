"""seamless-m4t-medium [arXiv:2308.11596; hf] — enc-dec audio/text backbone.

12L encoder + 12L decoder, d_model=1024, 16H (kv=16), d_ff=4096,
vocab=256206 (padded to 256256 for 16-way sharding).  Audio frontend is a
stub providing precomputed frame embeddings (assignment spec).
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-medium", family="encdec",
    n_layers=12, enc_layers=12, d_model=1024, n_heads=16, n_kv_heads=16,
    head_dim=64, d_ff=4096, vocab=256206, frontend_dim=1024,
    norm="layernorm", act="gelu", attn_shard="tp_heads",
)

SMOKE = CONFIG.replace(
    n_layers=2, enc_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    head_dim=16, d_ff=128, vocab=512, frontend_dim=32,
    diag_block=16, lln_chunk=16, softmax_chunk=32, remat="none")
