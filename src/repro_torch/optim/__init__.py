"""Optimizer substrate of the port: AdamW, LR schedules and gradient
compression."""
from .adamw import (AdamWConfig, adamw_init, adamw_update,
                    clip_by_global_norm, global_norm)
from .compression import (bf16_allreduce_cast, ef_compress, ef_decompress,
                          ef_init)
from .schedules import warmup_cosine, warmup_linear

__all__ = ["AdamWConfig", "adamw_init", "adamw_update",
           "bf16_allreduce_cast", "clip_by_global_norm", "ef_compress",
           "ef_decompress", "ef_init", "global_norm", "warmup_cosine",
           "warmup_linear"]
