"""paligemma-3b [arXiv:2407.07726; hf] — SigLIP patch stub + gemma decoder.

18L, d_model=2048, 8H MQA (kv=1, head_dim 256), d_ff=16384 (GeGLU),
vocab=257216, 256 image-patch prefix tokens (frontend stub, dim 1152).
8 heads % 16 != 0 -> context-parallel attention sharding.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="paligemma-3b", family="vlm",
    n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1, head_dim=256,
    d_ff=16384, vocab=257216, act="gelu_glu", embed_scale=True,
    tie_embeddings=True, frontend_dim=1152, num_prefix_tokens=256,
    attn_shard="context",
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=1, head_dim=16, d_ff=128,
    vocab=512, frontend_dim=32, num_prefix_tokens=8,
    diag_block=16, lln_chunk=16, softmax_chunk=32, remat="none")
