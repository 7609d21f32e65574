"""Shared model components: norms, embeddings, RoPE, initialisers.

Port of ``repro/models/common.py``. Parameters live in ``nn.Module``s
(see models/transformer.py); these are the plain functions on tensors that
the blocks call.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.kernels import gemm as G


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


def rmsnorm_cut(scale: torch.Tensor, x: torch.Tensor, width: int,
                eps: float = 1e-5) -> torch.Tensor:
    """``rmsnorm`` of a rank's slice ``x`` of a ``width``-wide row (its
    ``scale`` slice): the float32 sum of squares reduced over the model
    axis, then divided by ``width`` (under grad its gradient is summed
    too: each rank reads the sum for its slice)."""
    from repro_torch.distributed import sharding as shd

    ss = x.to(torch.float32).square().sum(dim=-1, keepdim=True)
    var = shd.shared_sum(ss) / width
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


def unembed_f32(table: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Float32 logits: ``unembed`` of the table and ``x`` cast to float32
    (the JAX ``apply`` unembeds in float32)."""
    return unembed(table.to(torch.float32), x.to(torch.float32))


# ---------------------------------------------------------------------------
# The products and norms of a forward
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Products:
    """The matrix products a forward runs: ``matmul(a, b)`` and
    ``einsum(eq, a, b)`` with torch's signatures and dtype rules, and
    ``unembed(table, x)`` (float32 logits). The norms are torch's in both
    sets: on the card their bits did not follow the row count or width
    (chip_smoke.py's prefill probe, PERF.md).

    ``LIBRARY`` is torch's own: on the card cuBLAS picks its product kernel
    by the problem's shape, so an element's arithmetic follows the launch's
    row count (ROADMAP F6). ``INVARIANT``
    is the paged prefill's (serve/engine.py ``make_paged_prefill_step``):
    the kernels of kernels/gemm.py, whose arithmetic for an output element
    depends on the reduction's width and the dtypes alone, so a position's
    K, V and logits are the same bits whatever row count, row width or
    start its prefill ran at (ROADMAP B.10). A forward reads its set from
    its cache (``products_of``)."""
    matmul: Callable
    einsum: Callable
    unembed: Callable


LIBRARY = Products(torch.matmul, torch.einsum, unembed_f32)
INVARIANT = Products(G.matmul, G.einsum, G.unembed)


def products_of(cache) -> Products:
    """The products a layer's cache (a dict, or None) asks for: a paged
    prefill's view carries ``INVARIANT`` under "products"; every other
    forward runs ``LIBRARY``."""
    if isinstance(cache, dict):
        return cache.get("products", LIBRARY)
    return LIBRARY


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


# ---------------------------------------------------------------------------
# The recurrent blocks' shared pieces (models/xlstm.py, models/ssm.py)
# ---------------------------------------------------------------------------
def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0) = max(x, 0) + log1p(exp(-|x|)),
    op by op in x.dtype."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))


def log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.log_sigmoid``: -softplus(-x)."""
    return -softplus(-x)


def causal_conv(xs: torch.Tensor, w: torch.Tensor,
                state: Optional[torch.Tensor] = None):
    """Depthwise causal conv of width W = w.shape[0] over ``xs`` (B, S, C),
    after the cached last W-1 inputs ``state`` (or zeros): the sum of the W
    shifted products, first to last, as the reference's Python ``sum``.
    Returns (y, new state: the context's last W-1 rows, or None without a
    state)."""
    Wd, S = w.shape[0], xs.shape[1]
    if state is not None:
        ctx = torch.cat([state.to(xs.dtype), xs], dim=1)
        new = ctx[:, -(Wd - 1):]
    else:
        ctx, new = torch.nn.functional.pad(xs, (0, 0, Wd - 1, 0)), None
    out = ctx[:, 0:S] * w[0]
    for i in range(1, Wd):
        out = out + ctx[:, i:i + S] * w[i]
    return out, new
