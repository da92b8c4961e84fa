"""Config registry: ``--arch <id>`` resolution for the port's launchers.

Only the archs whose model family the port runs are registered (the dense
decoder yi-9b, the bidirectional encoder roberta-lln, the pure SSM
mamba2-130m and the hybrid zamba2-7b); the others arrive with the slices
that port their families (ROADMAP.md, queue 1).
"""
from __future__ import annotations

import importlib

from .base import ArchConfig

_MODULES = {
    "yi-9b": "yi_9b",
    "roberta-lln": "roberta_lln",
    "mamba2-130m": "mamba2_130m",
    "zamba2-7b": "zamba2_7b",
}


def get_config(name: str, smoke: bool = False, **overrides) -> ArchConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch '{name}'; the port knows "
                       f"{sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    cfg = mod.SMOKE if smoke else mod.CONFIG
    return cfg.replace(**overrides) if overrides else cfg
