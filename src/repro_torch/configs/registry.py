"""Config registry: ``--arch <id>`` resolution for the port's launchers.

Every arch of the reference: the dense decoders yi-9b, stablelm-1.6b,
qwen3-14b and chatglm3-6b, the MoE decoder qwen3-moe-235b-a22b, the MLA +
MoE decoder deepseek-v2-236b, the encoder-decoder seamless-m4t-medium, the
VLM paligemma-3b, the bidirectional encoder roberta-lln, the pure SSM
mamba2-130m and the hybrid zamba2-7b.
"""
from __future__ import annotations

import importlib

from .base import ArchConfig

_MODULES = {
    "seamless-m4t-medium": "seamless_m4t_medium",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "yi-9b": "yi_9b",
    "stablelm-1.6b": "stablelm_1_6b",
    "qwen3-14b": "qwen3_14b",
    "chatglm3-6b": "chatglm3_6b",
    "mamba2-130m": "mamba2_130m",
    "zamba2-7b": "zamba2_7b",
    "paligemma-3b": "paligemma_3b",
    "roberta-lln": "roberta_lln",
}

ASSIGNED_ARCHS = tuple(k for k in _MODULES if k != "roberta-lln")


def get_config(name: str, smoke: bool = False, **overrides) -> ArchConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch '{name}'; the port knows "
                       f"{sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    cfg = mod.SMOKE if smoke else mod.CONFIG
    return cfg.replace(**overrides) if overrides else cfg


def list_archs() -> tuple[str, ...]:
    return tuple(_MODULES)
