"""Pluggable activation registry (port of ``repro.core.activations``): the
bridge between the paper's CORDIC evaluator and the LM substrate.

Models obtain their nonlinearities from ``get_activation(kind, impl)``:

    impl = "exact"         : torch's transcendental functions (float reference)
    impl = "cordic_float"  : MR-HRC algorithm in float (no quantization)
    impl = "cordic_fixed"  : bit-accurate Q2.14 (paper-faithful), plain torch int32
    impl = "cordic_pallas" : the CUDA kernels of the Q2.14 pipeline
                             (kernels/ops.py; their plain versions on the CPU)

Quantized/iterative forwards carry the analytic derivative from the primal
*output* (sigma' = s(1-s), tanh' = 1 - t^2) as ``torch.autograd.Function``s,
first order, the reference's ``custom_jvp`` rules transposed; a call that
needs no gradient runs the forward alone.

Range handling (``range_mode``): "clamp" saturates into the paper domain
(|x| <= 1 sigmoid, |z| <= 0.5 tanh); "reduce" uses the dyadic argument
reduction to |x| <= 8 (``core/sigmoid.sigmoid_cordic_wide``). As in the
reference, ``cordic_float`` with "reduce" takes that fixed-core wide path.

The "exact" impl is torch's own libm; it matches the reference's XLA
lowering to float round-off, not bit for bit.
"""
from __future__ import annotations

import math
from functools import partial
from typing import Callable

import torch
import torch.nn.functional as tF

from repro_torch.core import numerics as nx
from repro_torch.core import sigmoid as S
from repro_torch.core.cordic import FixedConfig, MRSchedule, PAPER_FIXED, PAPER_SCHEDULE

ACT_IMPLS = ("exact", "cordic_float", "cordic_fixed", "cordic_pallas")
RANGE_MODES = ("clamp", "reduce")


class _OutputRule(torch.autograd.Function):
    """y = fwd(x); dx = tangent(x, y) * dy."""

    @staticmethod
    def forward(ctx, x, fwd, tangent):
        y = fwd(x)
        ctx.tangent = tangent
        ctx.save_for_backward(x, y)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, y = ctx.saved_tensors
        return ctx.tangent(x, y) * dy, None, None


def _with_output_jvp(fwd: Callable, tangent_from_primal: Callable) -> Callable:
    """The tangent coefficient from (x, primal y)."""
    def f(x):
        if torch.is_grad_enabled() and x.requires_grad:
            return _OutputRule.apply(x, fwd, tangent_from_primal)
        return fwd(x)
    return f


def _with_sigmoid_jvp(fwd: Callable) -> Callable:
    return _with_output_jvp(fwd, lambda x, s: s * (1.0 - s))


def _with_tanh_jvp(fwd: Callable) -> Callable:
    return _with_output_jvp(fwd, lambda x, t: 1.0 - t * t)


def _sigmoid_fwd(impl: str, range_mode: str, sched: MRSchedule, cfg: FixedConfig):
    if impl == "exact":
        return torch.sigmoid
    if impl == "cordic_float":
        if range_mode == "clamp":
            return lambda x: S.sigmoid_cordic_float(x, sched)
        return lambda x: S.sigmoid_cordic_wide(x, sched, cfg)
    if impl == "cordic_fixed":
        if range_mode == "clamp":
            return lambda x: S.sigmoid_cordic_fixed(x, sched, cfg)
        return lambda x: S.sigmoid_cordic_wide(x, sched, cfg)
    if impl == "cordic_pallas":
        from repro_torch.kernels import ops as kops  # lazy, as the reference

        if range_mode == "clamp":
            return lambda x: kops.sigmoid(x)
        return lambda x: kops.sigmoid_wide(x)
    raise ValueError(f"unknown activation impl {impl!r}")


def _tanh_fwd(impl: str, range_mode: str, sched: MRSchedule, cfg: FixedConfig):
    if impl == "exact":
        return torch.tanh
    if range_mode == "clamp":
        if impl == "cordic_float":
            return lambda z: S.tanh_cordic_float(z, sched)
        if impl == "cordic_fixed":
            return lambda z: S.tanh_cordic_fixed(z, sched, cfg)
        from repro_torch.kernels import ops as kops

        return lambda z: kops.tanh(z)
    # tanh(z) = 2 sigmoid(2z) - 1 handles the range via the sigmoid path
    sig = _sigmoid_fwd(impl, range_mode, sched, cfg)
    return lambda z: 2.0 * sig(2.0 * z) - 1.0


def _gelu_erf_exact(x):
    return tF.gelu(x, approximate="none")


def _engine_fwd(kind: str, impl: str, cfg: FixedConfig):
    """Forward of the engine-derived kinds (exp/softplus/elu/gelu_erf);
    ``cordic_pallas`` runs the kernels of ``kernels/ops.py``, bit-identical
    to the fixed path."""
    from repro_torch.cordic_engine import functions as F

    if impl == "cordic_pallas":
        from repro_torch.kernels import ops as kops

        ktable = {"exp": kops.exp, "softplus": kops.softplus,
                  "elu": kops.elu, "gelu_erf": kops.gelu_erf}
        return lambda x, _k=ktable[kind]: _k(x, PAPER_SCHEDULE, cfg)
    table = {
        "exp": (torch.exp, F.exp_float, lambda x: F.exp_fixed(x, cfg=cfg)),
        "softplus": (tF.softplus, F.softplus_float,
                     lambda x: F.softplus_fixed(x, cfg=cfg)),
        "elu": (tF.elu, F.elu_float, lambda x: F.elu_fixed(x, cfg=cfg)),
        "gelu_erf": (_gelu_erf_exact, F.gelu_erf_float,
                     lambda x: F.gelu_erf_fixed(x, cfg=cfg)),
    }
    exact, flt, fxd = table[kind]
    if impl == "exact":
        return exact
    return fxd if impl == "cordic_fixed" else flt


def _gelu_erf_tangent(x, y):
    """gelu'(x) = Phi(x) + x phi(x)."""
    cdf = 0.5 * torch.erfc(-x * (1.0 / math.sqrt(2.0)))
    pdf = torch.exp(-0.5 * x * x) * (1.0 / math.sqrt(2.0 * math.pi))
    return cdf + x * pdf


#: tangent coefficients from (x, primal) for the engine-derived kinds
_ENGINE_JVPS = {
    "exp": lambda x, y: y,
    "softplus": lambda x, y: -torch.expm1(-y),            # sigma(x) = 1 - e^-y
    "elu": lambda x, y: torch.where(x > 0, torch.ones_like(y), y + 1.0),
    "gelu_erf": _gelu_erf_tangent,
}


def _silu(sig: Callable) -> Callable:
    return lambda x: x * sig(x)


def _gelu_tanh(th: Callable) -> Callable:
    """GELU(x) ~= 0.5 x (1 + tanh(sqrt(2/pi) (x + 0.044715 x^3))); the
    multiply-add x + (0.044715 x x) x is fused in float32, as jitted XLA
    computes it."""
    def f(x):
        c = nx.weak(0.7978845608028654, x)
        inner = nx.fma(nx.weak(0.044715, x) * x * x, x, x)
        return nx.weak(0.5, x) * x * (1.0 + th(c * inner))
    return f


def get_activation(kind: str, impl: str = "exact", range_mode: str = "reduce",
                   sched: MRSchedule = PAPER_SCHEDULE,
                   cfg: FixedConfig = PAPER_FIXED) -> Callable:
    """Return a differentiable activation fn of the requested kind/impl.

    kind in {"sigmoid", "tanh", "silu", "gelu_tanh", "relu", "gelu",
             "exp", "softplus", "elu", "gelu_erf"}; the last four are
    derived from the generalized engine (cordic_engine.functions).
    """
    if impl not in ACT_IMPLS:
        raise ValueError(f"impl {impl!r} not in {ACT_IMPLS}")
    if range_mode not in RANGE_MODES:
        raise ValueError(f"range_mode {range_mode!r} not in {RANGE_MODES}")

    if kind == "relu":
        return torch.relu
    if kind == "gelu":
        return partial(tF.gelu, approximate="tanh")

    if kind in _ENGINE_JVPS:
        fwd = _engine_fwd(kind, impl, cfg)
        if impl in ("exact", "cordic_pallas"):
            # exact is torch-native; the kernel ops carry their own rules
            return fwd
        return _with_output_jvp(fwd, _ENGINE_JVPS[kind])

    if kind == "sigmoid":
        fwd = _sigmoid_fwd(impl, range_mode, sched, cfg)
        return fwd if impl == "exact" else _with_sigmoid_jvp(fwd)
    if kind == "tanh":
        fwd = _tanh_fwd(impl, range_mode, sched, cfg)
        return fwd if impl == "exact" else _with_tanh_jvp(fwd)
    if kind == "silu":
        if impl == "exact":
            return tF.silu
        return _silu(_with_sigmoid_jvp(_sigmoid_fwd(impl, range_mode, sched, cfg)))
    if kind == "gelu_tanh":
        if impl == "exact":
            return partial(tF.gelu, approximate="tanh")
        return _gelu_tanh(_with_tanh_jvp(_tanh_fwd(impl, range_mode, sched, cfg)))
    raise ValueError(f"unknown activation kind {kind!r}")
