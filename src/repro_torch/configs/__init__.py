"""Architecture registry of the port: ``get_config(arch_id)`` /
``get_smoke(arch_id)`` over the archs the PyTorch port runs.

Only ``yi-9b`` (dense GQA) is served so far; the other archs of
``repro.configs`` come with ROADMAP A.10.
"""
from __future__ import annotations

from repro_torch.configs import yi_9b
from repro_torch.configs.base import ModelConfig, SHAPES, ShapeConfig  # noqa: F401

_MODULES = {
    "yi-9b": yi_9b,
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
