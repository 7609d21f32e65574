"""Threefry-2x32 random numbers, bit for bit as ``jax.random`` draws them
with ``jax_threefry_partitionable=True`` (jax 0.9.0's default).

A key is a (..., 2) int64 tensor holding two 32-bit words. Every lane is an
int64 masked to 32 bits, since ``torch.uint32`` supports few operations;
the words of a sum or a rotation never leave 62 bits, so nothing wraps
before the mask.

    threefry_seed(seed)        jax.random.PRNGKey(seed)'s words
    fold_in(key, data)         jax.random.fold_in
    random_bits(key, shape)    jax.random.bits (uint32), the partitionable
                               layout: threefry over the (hi, lo) words of
                               each element's flat index, hi ^ lo
    uniform(key, shape, lo, hi) jax.random.uniform, float32
    gumbel(key, shape)         jax.random.gumbel, mode "low": -log(-log(u))
                               through ``numerics.xla_log_f32``

Keys may carry batch dimensions in front of the 2: ``random_bits`` then
draws ``shape`` per key, as ``jax.vmap`` over the keys does.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.core import numerics as nx

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
#: float32's smallest normal, the low end of gumbel's uniform
TINY = nx.FLT_MIN


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & _M32) | (x >> (32 - r))


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 block (20 rounds, five key injections) on
    broadcastable int64 lanes; returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x0 = (x1 + ks[0]) & _M32
    x1 = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def _words(v, device=None) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.int64, device=device) & _M32


def threefry_seed(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``: (2,) words (high, low). A seed inside
    int32 has a zero high word, as JAX's 32-bit seed."""
    hi = 0 if -2 ** 31 <= seed < 2 ** 31 else (seed >> 32) & _M32
    return _words([hi, seed & _M32], device)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in(key, data)``: threefry of the key over the
    words (0, data & 0xFFFFFFFF). ``data`` may be a tensor of the key's
    batch shape."""
    data = _words(data, key.device)
    x0, x1 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(data), data)
    return torch.stack([x0, x1], dim=-1)


def random_bits(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` as int64 lanes in [0, 2^32), per
    key: (*key.shape[:-1], *shape)."""
    shape = tuple(shape)
    n = 1
    for d in shape:
        n *= d
    idx = torch.arange(n, dtype=torch.int64, device=key.device)
    lead = key.shape[:-1]
    k1 = key[..., 0].reshape(lead + (1,))
    k2 = key[..., 1].reshape(lead + (1,))
    b1, b2 = threefry2x32(k1, k2, idx >> 32, idx & _M32)
    return (b1 ^ b2).reshape(lead + shape)


def uniform(key: torch.Tensor, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in float32: the top 23 bits as the mantissa of
    a number in [1, 2), minus 1, scaled to [minval, maxval) and floored at
    minval."""
    bits = (random_bits(key, shape) >> 9) | 0x3F800000
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32)
    span = float(torch.tensor(maxval, dtype=torch.float32) - lo)
    lo = float(lo)
    return torch.clamp(floats * span + lo, min=lo)


def gumbel(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.gumbel`` (mode "low"): -log(-log(u)), u uniform on
    [TINY, 1), both logs XLA:CPU's float32 log."""
    u = uniform(key, shape, TINY, 1.0)
    return -nx.xla_log_f32(-nx.xla_log_f32(u))
