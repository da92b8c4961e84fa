"""qwen3-moe-235b-a22b [hf:Qwen/Qwen3-30B-A3B; hf] — 128 experts top-8, GQA kv=4, qk_norm.

94L, d_model=4096, 64H (head_dim 128), expert d_ff=1536, vocab=151936.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4, head_dim=128,
    d_ff=1536, vocab=151936,
    n_experts=128, n_shared_experts=0, top_k=8, expert_d_ff=1536,
    qk_norm=True, rope_theta=1e6,
    param_dtype="bfloat16", attn_shard="tp_heads", grad_accum=8,
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=64,
    vocab=512, n_experts=8, top_k=2, expert_d_ff=32,
    param_dtype="float32", diag_block=16, lln_chunk=16, softmax_chunk=32,
    remat="none")
