"""Architecture configuration schema (PyTorch port of ``repro.configs.base``).

The same fields and defaults as the JAX package's ``ArchConfig``, so a
config built here describes exactly the model the reference builds.  The
only difference is ``pdtype``/``cdtype``: they return ``torch`` dtypes.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    """Map a dtype name (``"bfloat16"``, ...) to the ``torch`` dtype."""
    try:
        return _DTYPES[str(name)]
    except KeyError:
        raise ValueError(f"unsupported dtype {name!r}; "
                         f"expected one of {sorted(_DTYPES)}") from None


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | mla_moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None   # default d_model // n_heads

    # --- attention ---------------------------------------------------------
    attn_impl: str = "softmax"       # softmax | lln | lln_diag | log_linear
    diag_block: int = 256
    lln_chunk: int = 256
    use_kernel: bool = False
    use_serve_kernel: bool = True    # False maps to attn_backend="ref"
    attn_backend: str = "auto"       # kernels/registry.py backend:
                                     # auto | kernel | plain | ref
    qk_norm: bool = False
    lln_fixed_ab: float = 0.0        # fixed alpha=beta (paper §A.8.4); 0=dynamic
    lln_per_row_calib: bool = False
    rope_theta: float = 10000.0
    rotary_pct: float = 1.0
    softmax_chunk: int = 1024

    # --- long-context robustness --------------------------------------------
    lln_beta_n: float = 0.0
    lln_calib_len: int = 1024
    lln_renorm: float = 0.0
    lln_num_scales: int = 4
    lln_scale_decay: float = 0.5

    # --- speculative decoding ------------------------------------------------
    draft_layers: int = 0
    spec_k: int = 0

    # --- MoE ----------------------------------------------------------------
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    expert_d_ff: int = 0
    capacity_factor: float = 1.25
    first_dense_layers: int = 0
    router_aux_coef: float = 0.001

    # --- MLA ------------------------------------------------------------------
    kv_lora: int = 0
    q_lora: int = 0
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128

    # --- SSM ------------------------------------------------------------------
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_groups: int = 1
    conv_width: int = 4
    ssm_chunk: int = 256
    shared_attn_period: int = 6

    # --- enc-dec / vlm frontends ---------------------------------------------
    enc_layers: int = 0
    frontend_dim: int = 0
    num_prefix_tokens: int = 0

    # --- norm / act / misc ---------------------------------------------------
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    act: str = "silu_glu"            # silu_glu | gelu_glu | gelu
    tie_embeddings: bool = False
    embed_scale: bool = False
    logit_softcap: float = 0.0

    # --- dtypes / remat / microbatching --------------------------------------
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: str = "full"
    grad_accum: int = 1
    cast_params_once: bool = False
    scan_unroll: bool = False

    # --- distribution policy -------------------------------------------------
    attn_shard: str = "tp_heads"
    vocab_pad_to: int = 256

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_to
        return ((self.vocab + m - 1) // m) * m

    @property
    def pdtype(self) -> torch.dtype:
        return torch_dtype(self.param_dtype)

    @property
    def cdtype(self) -> torch.dtype:
        return torch_dtype(self.compute_dtype)

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One input-shape cell."""
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode


# The four assigned LM shapes (identical for all archs).
SHAPES: Tuple[ShapeSpec, ...] = (
    ShapeSpec("train_4k", 4096, 256, "train"),
    ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    ShapeSpec("decode_32k", 32768, 128, "decode"),
    ShapeSpec("long_500k", 524288, 1, "decode"),
)

SHAPES_BY_NAME = {s.name: s for s in SHAPES}
