"""mamba2-130m [arXiv:2405.21060; unverified] — SSD (state-space duality), attn-free.

24L, d_model=768, d_inner=1536 (expand 2, head_dim 64 -> 24 heads),
ssm_state=128, vocab=50280 (padded to 50432).  The paper's LLN technique is
inapplicable (attention-free); the model trains through the SSD kernel.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-130m", family="ssm",
    n_layers=24, d_model=768, n_heads=24, n_kv_heads=24, d_ff=0,
    vocab=50280, ssm_state=128, ssm_expand=2, ssm_head_dim=64, ssm_groups=1,
    shared_attn_period=0, tie_embeddings=True, attn_shard="replicate",
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=2, n_kv_heads=2, vocab=512,
    ssm_state=16, ssm_head_dim=32, ssm_chunk=16, remat="none")
