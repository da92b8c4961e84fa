"""Optimizer substrate of the port: AdamW and LR schedules."""
from .adamw import (AdamWConfig, adamw_init, adamw_update,
                    clip_by_global_norm, global_norm)
from .schedules import warmup_cosine, warmup_linear

__all__ = ["AdamWConfig", "adamw_init", "adamw_update",
           "clip_by_global_norm", "global_norm", "warmup_cosine",
           "warmup_linear"]
