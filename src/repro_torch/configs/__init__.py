"""Architecture registry of the port: ``get_config(arch_id)`` /
``get_smoke(arch_id)`` over the archs the PyTorch port runs.

Served so far: ``yi-9b`` (dense GQA) and ``deepseek-v2-lite-16b`` (MLA
attention, a dense first layer, then GShard MoE layers). The other archs of
``repro.configs`` (``phi3.5-moe``'s ``gqa_moe``, the recurrent families)
come with ROADMAP A.10.
"""
from __future__ import annotations

from repro_torch.configs import deepseek_v2_lite_16b, yi_9b
from repro_torch.configs.base import ModelConfig, SHAPES, ShapeConfig  # noqa: F401

_MODULES = {
    "yi-9b": yi_9b,
    "deepseek-v2-lite-16b": deepseek_v2_lite_16b,
}

ARCH_IDS = tuple(_MODULES.keys())


def get_config(arch_id: str, **kw) -> ModelConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    return _MODULES[arch_id].full(**kw)


def get_smoke(arch_id: str, **kw) -> ModelConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    return _MODULES[arch_id].smoke(**kw)
