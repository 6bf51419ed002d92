"""Registry of assigned architectures: ``get_config(arch_id)``."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import SHAPES, ArchConfig, ShapeConfig

_MODULES = {
    "qwen3-8b": "repro_torch.configs.qwen3_8b",
    "stablelm-1.6b": "repro_torch.configs.stablelm_1_6b",
    "h2o-danube-1.8b": "repro_torch.configs.h2o_danube_1_8b",
    "qwen3-32b": "repro_torch.configs.qwen3_32b",
    "internvl2-26b": "repro_torch.configs.internvl2_26b",
    "granite-moe-1b-a400m": "repro_torch.configs.granite_moe_1b",
    "qwen2-moe-a2.7b": "repro_torch.configs.qwen2_moe_a2_7b",
    "rwkv6-3b": "repro_torch.configs.rwkv6_3b",
    "zamba2-2.7b": "repro_torch.configs.zamba2_2_7b",
    "whisper-large-v3": "repro_torch.configs.whisper_large_v3",
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch_id: str) -> ArchConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(_MODULES[arch_id]).CONFIG


def get_shape(shape_id: str) -> ShapeConfig:
    if shape_id not in SHAPES:
        raise KeyError(f"unknown shape {shape_id!r}; known: {sorted(SHAPES)}")
    return SHAPES[shape_id]


def iter_cells():
    """Yield every runnable (arch, shape) dry-run cell, plus skipped ones.

    Returns (arch_id, shape_id, runnable: bool).
    """
    for arch_id in ARCH_IDS:
        cfg = get_config(arch_id)
        for shape_id, shape in SHAPES.items():
            yield arch_id, shape_id, cfg.supports_shape(shape)
