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
  half of the padding in front. ``xla_sum`` replays that order;
  ``window_sums`` is its first level over a row of whole windows, so a row
  cut into spans of whole windows sums as the whole row does when the
  spans' window sums are joined and ``xla_sum`` finishes them.

``log2`` is ``log(x) / log(2)`` in the input's dtype, as ``jnp.log2``.
``sqrt`` is correctly rounded, as XLA's (torch's float32 CPU sqrt is not:
it misses on ~0.5% of inputs). ``xla_log_f32`` is XLA:CPU's float32 log,
a Cephes polynomial with its multiply-adds fused in a fixed order
(``torch.log`` is 1 ulp off on about one float32 input in seven).
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


#: Cephes logf's polynomial, highest power first, and the split of ln 2
_LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
          -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
          2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)
_LOG_Q1, _LOG_Q2 = -2.12194440e-4, 0.693359375
_SQRT_HALF = 0.70710678
#: smallest normal float32
FLT_MIN = 2.0 ** -126


def xla_log_f32(x: torch.Tensor) -> torch.Tensor:
    """Natural log of float32 ``x`` as jitted ``jnp.log`` computes it on
    the CPU: frexp into m in [0.5, 1) and e; m < sqrt(1/2) shifts to
    (2m - 1, e - 1), otherwise m - 1; x2 = m*m and x3 = x2*m rounded; the
    degree-8 polynomial as three fused Horner pairs folded by x3 (every
    multiply-add one ``fma``); then ``fma(y, x3, e*q1)``, ``(m - x2/2) + y``
    and ``+ e*q2``, each rounded. 0 and subnormal inputs give -inf (XLA:CPU
    flushes subnormals), a negative input NaN, +inf itself."""
    xf = x.to(_F32)
    c = torch.clamp(xf, min=FLT_MIN)
    bits = c.view(torch.int32)
    e = ((bits >> 23) & 0xFF).to(_F32) - 126.0
    m = ((bits & ~0x7F800000) | 0x3F000000).view(_F32)
    small = m < _SQRT_HALF
    e = torch.where(small, e - 1.0, e)
    m = torch.where(small, (m - 1.0) + m, m - 1.0)
    x2 = m * m
    x3 = x2 * m
    p = _LOG_P
    y = fma(m, p[0], p[1])
    y1 = fma(m, p[3], p[4])
    y2 = fma(m, p[6], p[7])
    y = fma(y, m, p[2])
    y1 = fma(y1, m, p[5])
    y2 = fma(y2, m, p[8])
    y = fma(y, x3, y1)
    y = fma(y, x3, y2)
    y = fma(y, x3, e * _LOG_Q1)
    r = (m - x2 * 0.5) + y
    r = r + e * _LOG_Q2
    r = torch.where(xf < 0, torch.full_like(r, math.nan), r)
    r = torch.where(xf.abs() < FLT_MIN, torch.full_like(r, -math.inf), r)
    return torch.where((xf == math.inf) | torch.isnan(xf), xf, r)


def _seq(x: torch.Tensor) -> torch.Tensor:
    s = x[..., 0]
    for i in range(1, x.shape[-1]):
        s = s + x[..., i]
    return s


def window_sums(x: torch.Tensor) -> torch.Tensor:
    """The first level of ``xla_sum`` over a last axis of whole windows:
    (..., 32 w) -> (..., w), each window of 32 summed left to right."""
    n = x.shape[-1]
    if n % SUM_WINDOW:
        raise ValueError(f"{n} lanes are not whole windows of {SUM_WINDOW}")
    return _seq(x.reshape(x.shape[:-1] + (n // SUM_WINDOW, SUM_WINDOW)))


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
        xm = window_sums(xm)
    s = _seq(xm) if xm.shape[-1] else xm.sum(-1)
    return s.unsqueeze(dim) if keepdim else s
