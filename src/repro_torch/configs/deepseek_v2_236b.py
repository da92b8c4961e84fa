"""deepseek-v2-236b [arXiv:2405.04434; hf] — MLA + MoE (160 routed top-6 + 2 shared).

60L, d_model=5120, 128H, MLA kv_lora=512 / q_lora=1536 / rope 64 / nope 128,
experts d_ff=1536, first layer dense (d_ff=12288), vocab=102400.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-v2-236b", family="moe",
    n_layers=60, d_model=5120, n_heads=128, n_kv_heads=128, head_dim=192,
    d_ff=12288, vocab=102400,
    n_experts=160, n_shared_experts=2, top_k=6, expert_d_ff=1536,
    first_dense_layers=1,
    kv_lora=512, q_lora=1536, rope_head_dim=64, nope_head_dim=128,
    v_head_dim=128,
    param_dtype="bfloat16", attn_shard="tp_heads", grad_accum=8,
)

SMOKE = CONFIG.replace(
    n_layers=3, d_model=64, n_heads=4, head_dim=24, d_ff=128, vocab=512,
    n_experts=8, n_shared_experts=1, top_k=2, expert_d_ff=32,
    kv_lora=32, q_lora=48, rope_head_dim=8, nope_head_dim=16, v_head_dim=16,
    param_dtype="float32", diag_block=16, lln_chunk=16, softmax_chunk=32,
    remat="none")
