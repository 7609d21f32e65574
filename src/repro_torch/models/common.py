"""Shared model components: norms, embeddings, RoPE, initialisers.

Port of ``repro/models/common.py``. Parameters live in ``nn.Module``s
(see models/transformer.py); these are the plain functions on tensors that
the blocks call.
"""
from __future__ import annotations

import functools
import math
from typing import Optional, Sequence

import numpy as np
import torch


def dtype_of(name: str) -> torch.dtype:
    """cfg.dtype ("bfloat16" | "float32") -> torch dtype."""
    return torch.bfloat16 if name == "bfloat16" else torch.float32


def init_normal(shape: Sequence[int], gen: torch.Generator, dtype: torch.dtype,
                device: torch.device, std: Optional[float] = None) -> torch.Tensor:
    """N(0, std^2) in float32, cast to ``dtype``. The default std is
    1/sqrt(shape[0]), the JAX spec's fan-in rule (common._init_leaf)."""
    if std is None:
        fan_in = shape[0] if len(shape) >= 2 else max(shape[-1], 1)
        std = 1.0 / math.sqrt(max(fan_in, 1))
    w = torch.randn(tuple(shape), generator=gen, dtype=torch.float32,
                    device=device)
    return (w * std).to(dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------
def rmsnorm(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Variance in float32, normalisation and scale in x.dtype (as JAX)."""
    var = x.to(torch.float32).square().mean(dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps).to(x.dtype)
    return y * scale.to(x.dtype)


# ---------------------------------------------------------------------------
# Embedding / LM head
# ---------------------------------------------------------------------------
def embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return table[tokens]


def unembed(table: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Logits projection against a (vocab, d) table."""
    return x @ table.t()


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------
def rope_frequencies(head_dim: int, theta: float = 1e4) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float64) / head_dim))


@functools.lru_cache(maxsize=None)
def _rope_table(head_dim: int, theta: float, device: torch.device) -> torch.Tensor:
    """float32 frequencies, copied to the device once: a copy from host
    memory per call would wait for the device at every layer."""
    return torch.as_tensor(rope_frequencies(head_dim, theta), dtype=torch.float32,
                           device=device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 1e4) -> torch.Tensor:
    """x: (..., S, H, D); positions broadcastable to (..., S)."""
    d = x.shape[-1]
    freqs = _rope_table(d, float(theta), x.device)
    ang = positions[..., :, None].to(torch.float32) * freqs        # (..., S, d/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
