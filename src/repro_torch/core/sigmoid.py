"""Sigmoid/tanh evaluators (port of ``repro.core.sigmoid``): the paper's
MR-HRC pipeline plus the baseline families it compares against in Table 2
(piecewise-linear, piecewise-poly2, LUT, Taylor, conventional radix-2
CORDIC), all at the same 16-bit fixed-point budget.

Float ops follow the reference's rounding (``core.numerics``): each op in
the input's dtype, Python constants rounded to it, and the multiply-adds
that jitted XLA contracts computed with one rounding in float32.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import fixed_point as fp
from repro_torch.core import numerics as nx
from repro_torch.core.cordic import (
    FixedConfig,
    MRSchedule,
    PAPER_FIXED,
    PAPER_SCHEDULE,
    R2_BASELINE_SCHEDULE,
    sigmoid_fixed,
    sigmoid_mr_f,
    tanh_fixed,
    tanh_mr_f,
)


# --------------------------------------------------------------------------
# Reference + paper implementations
# --------------------------------------------------------------------------
def sigmoid_exact(x):
    return torch.sigmoid(x)


def tanh_exact(x):
    return torch.tanh(x)


def sigmoid_cordic_float(x, sched: MRSchedule = PAPER_SCHEDULE, clamp: bool = True):
    """MR-HRC sigmoid in float arithmetic (algorithmic error only)."""
    if clamp:
        x = x.clamp(-1.0, 1.0)
    return sigmoid_mr_f(x, sched)


def sigmoid_cordic_fixed(x, sched: MRSchedule = PAPER_SCHEDULE,
                         cfg: FixedConfig = PAPER_FIXED, clamp: bool = True):
    """The paper's implementation: 16-bit Q2.14 MR-HRC + R2-LVC."""
    return sigmoid_fixed(x, sched, cfg, clamp=clamp)


def tanh_cordic_float(z, sched: MRSchedule = PAPER_SCHEDULE, clamp: bool = True):
    if clamp:
        z = z.clamp(-0.5, 0.5)
    return tanh_mr_f(z, sched)


def tanh_cordic_fixed(z, sched: MRSchedule = PAPER_SCHEDULE,
                      cfg: FixedConfig = PAPER_FIXED, clamp: bool = True):
    return tanh_fixed(z, sched, cfg, clamp=clamp)


def sigmoid_r2_cordic_fixed(x, cfg: FixedConfig = PAPER_FIXED, clamp: bool = True):
    """Conventional pure radix-2 hyperbolic CORDIC baseline: j=2..14 with
    the textbook repeated iterations, same 16-bit datapath."""
    return sigmoid_fixed(x, R2_BASELINE_SCHEDULE, cfg, clamp=clamp)


# --------------------------------------------------------------------------
# Range extension beyond the paper's |x| <= 1 contract
# --------------------------------------------------------------------------
def sigmoid_cordic_wide(x, sched: MRSchedule = PAPER_SCHEDULE,
                        cfg: FixedConfig = PAPER_FIXED, max_doublings: int = 3):
    """Range extension to |x| <= 2^max_doublings by the dyadic identity
    sigma(2a) = s^2 / (s^2 + (1-s)^2), s = sigma(a), applied k =
    ceil(log2 |x|) times in float on top of the fixed-point core.

    Every float op runs in x's dtype, as the reference's: in bfloat16 the
    log2 (log(|x|) / log 2) rounds, so k can fall one short of the exact
    ceil(log2 |x|) just above a power of two, and each doubling op rounds.
    In float32 the denominator is the fused fma(1-s, 1-s, s^2)."""
    ax = x.abs()
    k = torch.ceil(nx.log2(torch.maximum(
        ax, torch.tensor(nx.weak(1e-30, x), dtype=x.dtype, device=x.device))))
    k = k.clamp(0, max_doublings)
    s = sigmoid_cordic_fixed(x * nx.exp2(-k), sched, cfg, clamp=True)
    floor = nx.weak(1e-12, s)
    for i in range(max_doublings):
        s2 = s * s
        t = 1.0 - s
        doubled = s2 / nx.fma(t, t, s2).clamp_min(floor)
        s = torch.where(k > i, doubled, s)
    return s


# --------------------------------------------------------------------------
# Baseline families (paper Table 1/2 comparison points)
# --------------------------------------------------------------------------
def _quant_out(y, fmt=fp.Q2_14):
    """Quantize a baseline's output to the same 16-bit output format."""
    return fp.dequantize(fp.quantize(y, fmt), fmt)


def _np_quant(a: np.ndarray, fmt=fp.Q2_14) -> np.ndarray:
    """Pure-numpy table quantization (constant prep)."""
    q = np.clip(np.round(a * fmt.scale), fmt.min_int, fmt.max_int)
    return (q / fmt.scale).astype(np.float32)


def _table(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(like.device)


def _segment(xc, lo: float, hi: float, segments: int) -> torch.Tensor:
    idx = ((xc - lo) / (hi - lo) * segments).to(torch.int32)   # trunc to 0
    return idx.clamp(0, segments - 1).long()


def sigmoid_pwl_fixed(x, segments: int = 16, lo: float = -1.0, hi: float = 1.0):
    """Piecewise-linear approximation: uniform segments, 16-bit quantized
    slope/intercept tables and output."""
    edges = np.linspace(lo, hi, segments + 1)
    x0, x1 = edges[:-1], edges[1:]
    y0 = 1.0 / (1.0 + np.exp(-x0))
    y1 = 1.0 / (1.0 + np.exp(-x1))
    slope = (y1 - y0) / (x1 - x0)
    icept = y0 - slope * x0
    xc = x.clamp(lo, hi)
    idx = _segment(xc, lo, hi, segments)
    y = nx.fma(_table(_np_quant(slope), xc)[idx], xc,
               _table(_np_quant(icept), xc)[idx])
    return _quant_out(y)


def sigmoid_poly2_fixed(x, segments: int = 8, lo: float = -1.0, hi: float = 1.0):
    """Piecewise 2nd-degree polynomial, least-squares fit per segment,
    16-bit coefficient/output quantization."""
    edges = np.linspace(lo, hi, segments + 1)
    coefs = []
    for a, b in zip(edges[:-1], edges[1:]):
        xs = np.linspace(a, b, 64)
        coefs.append(np.polyfit(xs, 1.0 / (1.0 + np.exp(-xs)), 2))
    coefs_q = _np_quant(np.asarray(coefs))  # (segments, 3) highest-first
    xc = x.clamp(lo, hi)
    idx = _segment(xc, lo, hi, segments)
    c2, c1, c0 = (_table(coefs_q[:, i], xc)[idx] for i in range(3))
    y = nx.fma(nx.fma(c2, xc, c1), xc, c0)
    return _quant_out(y)


def sigmoid_lut_fixed(x, entries: int = 256, lo: float = -1.0, hi: float = 1.0):
    """Direct lookup table: nearest-entry LUT, 16-bit outputs."""
    grid = np.linspace(lo, hi, entries)
    tab_q = _np_quant(1.0 / (1.0 + np.exp(-grid)))
    xc = x.clamp(lo, hi)
    idx = torch.round((xc - lo) / (hi - lo) * (entries - 1)).to(torch.int32)
    return _table(tab_q, xc)[idx.clamp(0, entries - 1).long()]


def sigmoid_taylor_fixed(x, order: int = 5):
    """Maclaurin expansion sigma(x) ~= 1/2 + x/4 - x^3/48 + x^5/480,
    16-bit quantized."""
    c = {1: 0.25, 3: -1.0 / 48.0, 5: 1.0 / 480.0, 7: -17.0 / 80640.0}
    xc = x.clamp(-1.0, 1.0)
    y = torch.full_like(xc, 0.5)
    p = xc
    for k in (1, 3, 5, 7):
        if k > order:
            break
        y = nx.fma(p, c[k], y)
        p = p * xc * xc
    return _quant_out(y)


#: Registry of the accuracy benchmark (paper Table 2 reproduction).
TABLE2_METHODS = {
    "proposed_mr_hrc_q2.14": lambda x: sigmoid_cordic_fixed(x),
    "r2_cordic_q2.14 [9]": lambda x: sigmoid_r2_cordic_fixed(x),
    "pwl_16seg [7]/[11]": lambda x: sigmoid_pwl_fixed(x, 16),
    "pwl_8seg [11]": lambda x: sigmoid_pwl_fixed(x, 8),
    "poly2_8seg [2]/[8]": lambda x: sigmoid_poly2_fixed(x, 8),
    "lut_256 [10]": lambda x: sigmoid_lut_fixed(x, 256),
    "lut_64 [10]": lambda x: sigmoid_lut_fixed(x, 64),
    "taylor_o5 [2]": lambda x: sigmoid_taylor_fixed(x, 5),
    "mr_hrc_float (algorithmic)": lambda x: sigmoid_cordic_float(x),
}
