"""CORDIC function library (port of ``repro.cordic_engine.functions``):
transcendental-free evaluators derived from the generalized engine, each as
float-in/float-out with dyadic range reduction.

Every function comes in two datapaths mirroring the sigmoid pipeline:

    *_float  — the CORDIC algorithm in float (algorithmic error only),
    *_fixed  — bit-accurate Q2.14 core with float-only boundary ops
               (quantize/dequantize, dyadic 2^k scaling, frexp).

Derivations (mode x direction -> function):

    hyperbolic rotation   cosh z, sinh z            ->  exp z = cosh + sinh
    hyperbolic vectoring  atanh(y/x)                ->  log m = 2 atanh((m-1)/(m+1))
    linear vectoring      y/x                       ->  divide, reciprocal
    linear rotation       y = x * z                 ->  multiply
    circular rotation     cos z, sin z

Composites: softplus = relu(x) + log(1 + exp(-|x|)); elu from exp; erf via
erf(u)^2 ~ 1 - exp(-u^2 (4/pi + a u^2) / (1 + a u^2)) (a = 0.147), giving
an erf-based GELU.

The float boundary ops round as the reference's jitted XLA does
(``core.numerics``): the circular reduction ``t - n pi/2`` is a fused
multiply-add; the exp's ``x - k ln2`` and erf's ``4/pi + a u^2`` and ``1 +
a u^2`` are not (jitted on their own, XLA rounds those products), ``2^k`` is
``jnp.exp2``'s value, row sums take XLA's order, the sqrt is correctly
rounded, and a float32 numpy constant promotes a bfloat16 input to float32
where the reference's does. ``softmax`` and ``log_softmax`` carry their tangent rules as
``torch.autograd.Function``s; the other functions here have no gradient
rule of their own (``core.activations`` installs them).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core import fixed_point as fp
from repro_torch.core import numerics as nx
from repro_torch.cordic_engine import core as eng
from repro_torch.cordic_engine.core import FixedConfig, PAPER_FIXED
from repro_torch.cordic_engine.schedule import (
    CIRC_ROTATION,
    HYP_ROTATION,
    HYP_VECTORING,
    LIN_ROTATION,
    LIN_VECTORING,
    ROTATION,
    CordicSchedule,
    MRSchedule,
    hyp_rotation_for,
    hyp_vectoring_for,
    lin_vectoring_for,
    mr_schedule_for,
)

_F32 = torch.float32


def _c32(v: float) -> float:
    """A float32 numpy constant of the reference, as a float64 value."""
    return float(torch.tensor(v, dtype=_F32))


_LN2 = _c32(0.6931471805599453)
_INV_LN2 = _c32(1.0 / 0.6931471805599453)
_HALF_PI = _c32(math.pi / 2.0)
_INV_HALF_PI = _c32(1.0 / (math.pi / 2.0))
#: exp clamp: keeps 2^k inside normal f32 exponent range.
_EXP_CLIP = 80.0
_ERF_A = _c32(0.147)
_FOUR_PI = _c32(4.0 / math.pi)
_INV_SQRT2 = _c32(1.0 / math.sqrt(2.0))
_HALF = 0.5
_LOG_FLOOR = _c32(1e-30)


# --------------------------------------------------------------------------
# Format profiles: a datapath format bundled with schedules sized to it
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class FormatProfile:
    """Everything needed to run the function library at one Q format: the
    FixedConfig plus rotation/vectoring/division schedules whose iteration
    depth matches the format's fraction bits."""

    name: str
    cfg: FixedConfig
    rotation: CordicSchedule       # exp / cosh+sinh
    vectoring: CordicSchedule      # atanh / log
    division: CordicSchedule       # divide / reciprocal
    pipeline: MRSchedule           # bundled sigmoid/tanh schedule

    @classmethod
    def for_format(cls, name: str, fmt: fp.QFormat) -> "FormatProfile":
        fb = fmt.frac_bits
        return cls(name=name, cfg=FixedConfig(fmt=fmt),
                   rotation=hyp_rotation_for(fb),
                   vectoring=hyp_vectoring_for(fb),
                   division=lin_vectoring_for(fb),
                   pipeline=mr_schedule_for(fb))


#: The accuracy-study ladder: the paper's 16-bit format and two wider ones.
FORMAT_PROFILES = {
    "q2_14": FormatProfile.for_format("q2_14", fp.Q2_14),
    "q2_20": FormatProfile.for_format("q2_20", fp.Q2_20),
    "q2_29": FormatProfile.for_format("q2_29", fp.Q2_29),
}


def _t(x) -> torch.Tensor:
    """A tensor keeps its dtype; anything else becomes float32."""
    return x if torch.is_tensor(x) else torch.as_tensor(x, dtype=_F32)


def _frexp(v: torch.Tensor):
    """``jnp.frexp``: (m, p), v = m 2^p, m in [0.5, 1), (0, 0) at 0; m in
    v's dtype (a bfloat16 mantissa is exact)."""
    m, p = torch.frexp(v.to(_F32))
    return m.to(v.dtype), p.to(torch.int32)


# --------------------------------------------------------------------------
# exp (hyperbolic rotation: e^r = cosh r + sinh r)
# --------------------------------------------------------------------------
def coshsinh_fixed(r, sched: CordicSchedule = HYP_ROTATION,
                   cfg: FixedConfig = PAPER_FIXED, clamp: bool = True):
    """(cosh r, sinh r) for |r| <= 0.5 on the Q2.14 datapath."""
    r = _t(r)
    if clamp:
        r = r.clamp(-0.5, 0.5)
    c, s, _ = eng.rotate_q(fp.quantize(r, cfg.fmt), sched, cfg)
    return fp.dequantize(c, cfg.fmt), fp.dequantize(s, cfg.fmt)


def coshsinh_float(r, sched: CordicSchedule = HYP_ROTATION, clamp: bool = True):
    r = _t(r)
    if clamp:
        r = r.clamp(-0.5, 0.5)
    c, s, _ = eng.rotate_f(r, sched)
    return c, s


def _dyadic(x: torch.Tensor):
    """x = k ln2 + r: k = round(x / ln2) (half to even), r = x - k ln2 with
    the product rounded (jitted XLA does not fuse this one), in float32."""
    xf = x.to(_F32)
    k = torch.round(xf * _INV_LN2)
    return k, xf - k * _LN2


def exp_fixed(x, sched: CordicSchedule = HYP_ROTATION,
              cfg: FixedConfig = PAPER_FIXED):
    """e^x over (-80, 80): dyadic reduction + Q2.14 cosh+sinh core; the
    only non-shift-add ops are the 2^k scale and the quantize/dequantize."""
    x = _t(x).clamp(-_EXP_CLIP, _EXP_CLIP)
    k, r = _dyadic(x)
    c, s, _ = eng.rotate_q(fp.quantize(r, cfg.fmt), sched, cfg)
    eq = fp.add(c, s, cfg.fmt)                         # e^r in (0.70, 1.42)
    return fp.dequantize(eq, cfg.fmt) * nx.exp2(k)


def exp_float(x, sched: CordicSchedule = HYP_ROTATION):
    x = _t(x).clamp(-_EXP_CLIP, _EXP_CLIP)
    k, r = _dyadic(x)
    c, s, _ = eng.rotate_f(r, sched)
    return (c + s) * nx.exp2(k)


# --------------------------------------------------------------------------
# atanh / log (hyperbolic vectoring)
# --------------------------------------------------------------------------
def atanh_fixed(t, sched: CordicSchedule = HYP_VECTORING,
                cfg: FixedConfig = PAPER_FIXED, clamp: bool = True):
    """atanh(t) for |t| <= 0.8 (clamped) via hyperbolic vectoring."""
    t = _t(t)
    if clamp:
        t = t.clamp(-0.8, 0.8)
    one = fp.quantize(torch.ones_like(t), cfg.fmt)
    z = eng.vector_q(one, fp.quantize(t, cfg.fmt), sched, cfg)
    return fp.dequantize(z, cfg.zfmt)


def atanh_float(t, sched: CordicSchedule = HYP_VECTORING, clamp: bool = True):
    t = _t(t)
    if clamp:
        t = t.clamp(-0.8, 0.8)
    return eng.vector_f(torch.ones_like(t), t, sched)


def _log_tail(at: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """2 at + p ln2 (float32)."""
    return 2.0 * at + p.to(_F32) * _LN2


def log_fixed(x, sched: CordicSchedule = HYP_VECTORING,
              cfg: FixedConfig = PAPER_FIXED):
    """ln x for x > 0: x = m 2^p, m in [0.5, 1), ln x = 2 atanh((m-1)/(m+1))
    + p ln2; the vectoring runs on (m+1, m-1), no division materialized."""
    x = torch.maximum(_t(x).to(_F32), torch.tensor(_LOG_FLOOR, device=_t(x).device))
    m, p = _frexp(x)
    num = fp.quantize(m - 1.0, cfg.fmt)                # in [-0.5, 0)
    den = fp.quantize(m + 1.0, cfg.fmt)                # in [1.5, 2)
    at = fp.dequantize(eng.vector_q(den, num, sched, cfg), cfg.zfmt)
    return _log_tail(at, p)


def log_float(x, sched: CordicSchedule = HYP_VECTORING):
    x = torch.maximum(_t(x).to(_F32), torch.tensor(_LOG_FLOOR, device=_t(x).device))
    m, p = _frexp(x)
    return _log_tail(eng.vector_f(m + 1.0, m - 1.0, sched), p)


# --------------------------------------------------------------------------
# division (linear vectoring)
# --------------------------------------------------------------------------
def _div_operands(y, x):
    y, x = _t(y), _t(x)
    sign = torch.sign(y) * torch.sign(x)
    my, py = _frexp(y.abs())
    mx, px = _frexp(x.abs())
    h = (my >= mx).to(torch.int32)
    num = torch.where(h == 1, my * 0.5, my)
    den = torch.maximum(mx.to(_F32), torch.tensor(0.5, device=mx.device))
    return sign, num, den, (py - px + h).to(_F32)


def divide_fixed(y, x, sched: CordicSchedule = LIN_VECTORING,
                 cfg: FixedConfig = PAPER_FIXED):
    """y/x for finite nonzero x via linear vectoring on frexp mantissas,
    the numerator halved when m_y >= m_x so the ratio lies in [0.5, 1):
    y/x = ((m_y / 2^h) / m_x) 2^(p_y - p_x + h). A zero operand gives 0."""
    sign, num, den, e = _div_operands(y, x)
    z = eng.vector_q(fp.quantize(den, cfg.fmt), fp.quantize(num, cfg.fmt),
                     sched, cfg)
    return sign * fp.dequantize(z, cfg.zfmt) * nx.exp2(e)


def divide_float(y, x, sched: CordicSchedule = LIN_VECTORING):
    sign, num, den, e = _div_operands(y, x)
    return sign * eng.vector_f(den, num, sched) * nx.exp2(e)


def reciprocal_fixed(x, sched: CordicSchedule = LIN_VECTORING,
                     cfg: FixedConfig = PAPER_FIXED):
    return divide_fixed(torch.ones_like(_t(x)), x, sched, cfg)


def reciprocal_float(x, sched: CordicSchedule = LIN_VECTORING):
    return divide_float(torch.ones_like(_t(x)), x, sched)


# --------------------------------------------------------------------------
# multiplication (linear rotation)
# --------------------------------------------------------------------------
def _mul_operands(a, b):
    a, b = torch.broadcast_tensors(_t(a), _t(b))
    sign = torch.sign(a) * torch.sign(b)
    ma, pa = _frexp(a.abs())
    mb, pb = _frexp(b.abs())
    half = torch.tensor(0.5, device=a.device)
    return (sign, torch.maximum(ma.to(_F32), half),
            torch.maximum(mb.to(_F32), half), (pa + pb).to(_F32))


def multiply_fixed(a, b, sched: CordicSchedule = LIN_ROTATION,
                   cfg: FixedConfig = PAPER_FIXED):
    """a*b via linear rotation (y accumulates x * z0) on frexp mantissas:
    the multiplicand mantissa in x, the multiplier mantissa as the angle
    z0, a b = (m_a m_b) 2^(p_a + p_b). A zero operand gives 0."""
    sign, ma, mb, e = _mul_operands(a, b)
    xq = fp.quantize(ma, cfg.fmt)
    zq = fp.quantize(mb, cfg.zfmt)
    _, y, _ = eng.sweep_q(xq, torch.zeros_like(xq), zq, sched, ROTATION, cfg)
    return sign * fp.dequantize(y, cfg.fmt) * nx.exp2(e)


def multiply_float(a, b, sched: CordicSchedule = LIN_ROTATION):
    sign, ma, mb, e = _mul_operands(a, b)
    _, y, _ = eng.sweep_f(ma, torch.zeros_like(ma), mb, sched, ROTATION)
    return sign * y * nx.exp2(e)


# --------------------------------------------------------------------------
# sin / cos (circular rotation)
# --------------------------------------------------------------------------
def _quadrant_fix(c, s, quad):
    cos = torch.where(quad == 0, c, torch.where(quad == 1, -s,
                                                torch.where(quad == 2, -c, s)))
    sin = torch.where(quad == 0, s, torch.where(quad == 1, c,
                                                torch.where(quad == 2, -s, -c)))
    return sin, cos


def _circ_reduce(t):
    """t = n pi/2 + r, |r| <= pi/4; the quadrant n mod 4."""
    tf = _t(t).to(_F32)
    n = torch.round(tf * _INV_HALF_PI)
    r = nx.fma(-n, _HALF_PI, tf)
    return r, torch.remainder(n, 4.0).to(torch.int32)


def sincos_fixed(t, sched: CordicSchedule = CIRC_ROTATION,
                 cfg: FixedConfig = PAPER_FIXED):
    """(sin t, cos t): reduce to |r| <= pi/4, rotate, quadrant-correct."""
    r, quad = _circ_reduce(t)
    c, s, _ = eng.rotate_q(fp.quantize(r, cfg.fmt), sched, cfg)
    return _quadrant_fix(fp.dequantize(c, cfg.fmt), fp.dequantize(s, cfg.fmt), quad)


def sincos_float(t, sched: CordicSchedule = CIRC_ROTATION):
    r, quad = _circ_reduce(t)
    c, s, _ = eng.rotate_f(r, sched)
    return _quadrant_fix(c, s, quad)


def sin_fixed(t, cfg: FixedConfig = PAPER_FIXED):
    return sincos_fixed(t, cfg=cfg)[0]


def cos_fixed(t, cfg: FixedConfig = PAPER_FIXED):
    return sincos_fixed(t, cfg=cfg)[1]


def sin_float(t):
    return sincos_float(t)[0]


def cos_float(t):
    return sincos_float(t)[1]


# --------------------------------------------------------------------------
# Composite activations
# --------------------------------------------------------------------------
def softplus_fixed(x, cfg: FixedConfig = PAPER_FIXED):
    """log(1 + e^x) = relu(x) + log(1 + e^-|x|) — both CORDIC legs."""
    x = _t(x)
    e = exp_fixed(-x.abs(), cfg=cfg)                   # in (0, 1]
    return x.clamp_min(0.0) + log_fixed(1.0 + e, cfg=cfg)


def softplus_float(x):
    x = _t(x)
    e = exp_float(-x.abs())
    return x.clamp_min(0.0) + log_float(1.0 + e)


def _elu(x, em1, alpha: float):
    return torch.where(x > 0, x.to(_F32), _c32(alpha) * em1)


def elu_fixed(x, alpha: float = 1.0, cfg: FixedConfig = PAPER_FIXED):
    x = _t(x)
    return _elu(x, exp_fixed(x.clamp_max(0.0), cfg=cfg) - 1.0, alpha)


def elu_float(x, alpha: float = 1.0):
    x = _t(x)
    return _elu(x, exp_float(x.clamp_max(0.0)) - 1.0, alpha)


def _erf_from_exp(u, exp_fn):
    """Exponential erf approximation (|err| < 2.5e-4); sqrt is a boundary
    op. Jitted XLA rounds both products of the prefactor (no FMA)."""
    u = _t(u)
    uf = u.to(_F32)
    # a bfloat16 u*u whose only consumers are float32 ops is computed in
    # float32 by XLA (no bfloat16 rounding); the product of two bfloat16
    # values is exact in float32
    u2 = uf * uf
    g = u2 * (_FOUR_PI + _ERF_A * u2) / (1.0 + _ERF_A * u2)
    return torch.sign(u) * nx.sqrt((1.0 - exp_fn(-g)).clamp_min(0.0))


def erf_fixed(u, cfg: FixedConfig = PAPER_FIXED):
    return _erf_from_exp(u, lambda v: exp_fixed(v, cfg=cfg))


def erf_float(u):
    return _erf_from_exp(u, exp_float)


def _gelu_erf(x, erf_fn):
    x = _t(x)
    return (nx.weak(_HALF, x) * x) * (1.0 + erf_fn(x.to(_F32) * _INV_SQRT2))


def gelu_erf_fixed(x, cfg: FixedConfig = PAPER_FIXED):
    """Exact-form GELU 0.5 x (1 + erf(x/sqrt2)) with the CORDIC-exp erf."""
    return _gelu_erf(x, lambda u: erf_fixed(u, cfg))


def gelu_erf_float(x):
    return _gelu_erf(x, erf_float)


# --------------------------------------------------------------------------
# softmax (CORDIC exp + linear-vectoring normalization)
# --------------------------------------------------------------------------
def _max_sub(x, axis):
    x = _t(x)
    return x - x.amax(dim=axis, keepdim=True).detach()


def softmax_fixed(x, axis: int = -1, cfg: FixedConfig = PAPER_FIXED):
    """softmax along `axis`: max-subtract, CORDIC exp, LVC division. Masked
    lanes (<= -1e30 after the max-subtract) clip at e^-80, not 0. Raw
    forward; ``softmax`` below is the differentiable wrapper."""
    e = exp_fixed(_max_sub(x, axis), cfg=cfg)
    return divide_fixed(e, nx.xla_sum(e, axis, keepdim=True), cfg=cfg)


class _Softmax(torch.autograd.Function):
    """The reference's jvp dy = y * (dx - sum(y dx)), transposed (the
    Jacobian is symmetric)."""

    @staticmethod
    def forward(ctx, x, axis):
        y = softmax_fixed(x, axis=axis)
        ctx.axis = axis
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, dy):
        (y,) = ctx.saved_tensors
        return y * (dy - (y * dy).sum(ctx.axis, keepdim=True)), None


def _needs_grad(x) -> bool:
    return torch.is_grad_enabled() and torch.is_tensor(x) and x.requires_grad


def softmax(x, axis: int = -1):
    """Differentiable CORDIC softmax (fixed path)."""
    if _needs_grad(x):
        return _Softmax.apply(x, axis)
    return softmax_fixed(x, axis=axis)


# --------------------------------------------------------------------------
# log-softmax (CORDIC exp for the sum + hyperbolic-vectoring log leg)
# --------------------------------------------------------------------------
def log_softmax_fixed(x, axis: int = -1, cfg: FixedConfig = PAPER_FIXED):
    """log-softmax along `axis`: u_i = x_i - max(x), y_i = u_i - ln(sum_j
    e^{u_j}), the log by the hyperbolic-vectoring leg. Raw forward."""
    u = _max_sub(x, axis)
    s = nx.xla_sum(exp_fixed(u, cfg=cfg), axis, keepdim=True)
    return u - log_fixed(s, cfg=cfg)


def log_softmax_float(x, axis: int = -1):
    """Float-datapath CORDIC log-softmax (algorithmic error only)."""
    u = _max_sub(x, axis)
    return u - log_float(nx.xla_sum(exp_float(u), axis, keepdim=True))


class _LogSoftmax(torch.autograd.Function):
    """The reference's jvp dy = dx - sum(p dx), p = exp(y), transposed."""

    @staticmethod
    def forward(ctx, x, axis):
        y = log_softmax_fixed(x, axis=axis)
        ctx.axis = axis
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, dy):
        (y,) = ctx.saved_tensors
        return dy - torch.exp(y) * dy.sum(ctx.axis, keepdim=True), None


def log_softmax(x, axis: int = -1):
    """Differentiable CORDIC log-softmax (fixed path)."""
    if _needs_grad(x):
        return _LogSoftmax.apply(x, axis)
    return log_softmax_fixed(x, axis=axis)
