"""RoBERTa-base-style bidirectional encoder: the paper's own experimental
setting (§5), LLN / LLN+Diag attention pre-trained with MLM.

12L, d_model=768, 12H, d_ff=3072, vocab=50265 (RoPE replaces learned
positions, as in the reference).  ``attn_impl`` selects the rows of the
paper's Table 1; the port trains ``lln`` and ``lln_diag``.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="roberta-lln", family="encoder",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=12, head_dim=64,
    d_ff=3072, vocab=50265, norm="layernorm", act="gelu",
    attn_impl="lln_diag", attn_shard="replicate",
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128,
    vocab=512, diag_block=16, lln_chunk=16, softmax_chunk=32, remat="none")
