"""How the reference's float arithmetic rounds, written out for torch.

The JAX package runs its float boundary ops through jitted XLA on the CPU,
and the port matches it bit for bit. Four rules cover what XLA:CPU does
differently from a plain reading of the source (jax 0.9.0, measured):

* **Weak constants.** A Python float meeting a bfloat16 array becomes a
  bfloat16 constant before the op (``x * 1.37`` multiplies by 1.3671875);
  torch keeps it in float32. ``weak`` rounds such a constant to the
  tensor's dtype first. Every bfloat16 op rounds its result, as torch does.
* **Fused multiply-adds.** XLA contracts a float32 ``a * b + c`` into one
  FMA in some fusions and not in others (``x - k ln2`` is fused in the
  kernel stages, not in ``functions.exp_fixed`` jitted alone), so each
  site is matched against the reference on its own; ``fma`` computes the
  fused ones in float64 and rounds once.
* **exp2.** ``jnp.exp2(k)`` lowers to ``exp(k * log 2)``: it is exact only
  for small |k|, and XLA:CPU flushes results below the normal range to 0.
  ``exp2`` reproduces it for the integer-valued float32 arguments the
  function library gives it.
* **Row sums.** A float32 reduction of more than 32 elements is split into
  windows of 32, each summed left to right, then the window sums left to
  right; the row is padded to a whole number of windows with the smaller
  half of the padding in front. ``xla_sum`` replays that order.

``log2`` is ``log(x) / log(2)`` in the input's dtype, as ``jnp.log2``.
``sqrt`` is correctly rounded, as XLA's (torch's float32 CPU sqrt is not:
it misses on ~0.5% of inputs).
"""
from __future__ import annotations

import functools
import math

import torch

_F32 = torch.float32
#: float32(log 2), as a float64 value
LN2_F32 = float(torch.tensor(math.log(2.0), dtype=_F32))
#: window of XLA:CPU's split float reductions
SUM_WINDOW = 32


@functools.lru_cache(maxsize=None)
def _weak(c: float, dtype: torch.dtype) -> float:
    return float(torch.tensor(c, dtype=dtype))


def weak(c: float, like: torch.Tensor) -> float:
    """The Python constant ``c`` as XLA sees it next to ``like``: rounded
    to a low-precision dtype, float32 (torch's own scalar rule) otherwise."""
    if like.dtype in (torch.bfloat16, torch.float16):
        return _weak(float(c), like.dtype)
    return c


def _f64(v):
    """A float32 operand (tensor or Python constant) as float64."""
    return v.double() if torch.is_tensor(v) else _weak(float(v), _F32)


def fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """``a * b + c`` as XLA:CPU computes it: one rounding in float32 (the
    contracted FMA; a product of two float32 values is exact in float64),
    every op rounded in a lower precision (the converts around each
    bfloat16 op keep LLVM from contracting)."""
    if a.dtype == _F32:
        return (a.double() * _f64(b) + _f64(c)).to(_F32)
    return a * b + c


def exp2(k: torch.Tensor) -> torch.Tensor:
    """``jnp.exp2`` of integer-valued float32 ``k``: exp(float32(k * log2))
    with the exponential's own range reduction, 2^k (1 + r) with r = k*log2
    - k*ln2 rounded once to float32; results below 2^-126 flush to 0.
    Other dtypes get exact powers of two (the library's bfloat16 calls
    take k in {0, .., -3}, where XLA's result is exact)."""
    if k.dtype != _F32:
        return torch.exp2(k.to(_F32)).to(k.dtype)
    kd = k.double().clamp(-1022.0, 1023.0)
    x = (kd * LN2_F32).to(_F32).double()
    m = (1.0 + (x - kd * math.log(2.0))).to(_F32).double()
    p2 = ((kd.long() + 1023) << 52).view(torch.float64)
    out = (m * p2).to(_F32)
    return torch.where(out.abs() < 2.0 ** -126, torch.zeros_like(out), out)


def log2(x: torch.Tensor) -> torch.Tensor:
    """``jnp.log2``: log(x) / log(2), both in x's dtype."""
    return torch.log(x) / torch.log(torch.tensor(2.0, dtype=x.dtype,
                                                 device=x.device))


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded square root (float64, then rounded once to float32
    and to x's dtype)."""
    return x.double().sqrt().to(_F32).to(x.dtype)


def _seq(x: torch.Tensor) -> torch.Tensor:
    s = x[..., 0]
    for i in range(1, x.shape[-1]):
        s = s + x[..., i]
    return s


def xla_sum(x: torch.Tensor, dim: int = -1, keepdim: bool = False) -> torch.Tensor:
    """Sum along ``dim`` in XLA:CPU's order (see the module docstring)."""
    xm = torch.movedim(x, dim, -1)
    while xm.shape[-1] > SUM_WINDOW:
        n = xm.shape[-1]
        w = -(-n // SUM_WINDOW)
        pad = w * SUM_WINDOW - n
        if pad:
            lo = xm.new_zeros(xm.shape[:-1] + (pad // 2,))
            hi = xm.new_zeros(xm.shape[:-1] + (pad - pad // 2,))
            xm = torch.cat([lo, xm, hi], dim=-1)
        xm = _seq(xm.reshape(xm.shape[:-1] + (w, SUM_WINDOW)))
    s = _seq(xm) if xm.shape[-1] else xm.sum(-1)
    return s.unsqueeze(dim) if keepdim else s
