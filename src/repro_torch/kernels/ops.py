"""Front door to the CORDIC kernels (port of ``repro/kernels/ops.py``).

Shape-polymorphic wrappers: an input of any rank is flattened (the TPU's
(rows, 1024) padding is gone) and handed to the kernel wrapper, which takes
the kernel for a CUDA tensor and the plain PyTorch version for a CPU one.

Gradients: each JAX ``custom_jvp`` rule (``ops.py:49-173``) is a
``torch.autograd.Function`` here, with the same tangent formula transposed
into a backward (first order only; the backward is plain PyTorch, as the
JAX rules are plain jnp). A call that needs no gradient (grad mode off, or
no input that requires grad) takes the forward path alone, so serving runs
exactly what it ran before. Where a JAX rule computes its primal itself,
the port does the same under grad: ``silu_mul`` then returns
``u * (g * sigmoid_wide(g))`` in the input dtype from one ``act_2d`` launch,
not the fused ``silu_mul_2d`` kernel, whose ``(u * g) * s`` rounds
differently; ``silu`` launches ``act_2d`` twice (the primal and the
``sigmoid_wide`` of its tangent). ``sigmoid_q`` and ``paged_attend_mla``
have no gradient, as their JAX counterparts have no jvp rule.
"""
from __future__ import annotations

import math

import torch

from repro_torch.cordic_engine.core import PAPER_FIXED
from repro_torch.cordic_engine.schedule import PAPER_SCHEDULE
from repro_torch.kernels import cordic_act as K
from repro_torch.kernels import paged_attention as PA
from repro_torch.kernels import softmax_cordic as SM


def _elementwise(x: torch.Tensor, op: str, sched, cfg,
                 max_doublings: int) -> torch.Tensor:
    y = K.act_2d(x.contiguous().view(-1), op, sched=sched, cfg=cfg,
                 max_doublings=max_doublings)
    return y.view(x.shape)


def _needs_grad(*ts: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


# ---------------------------------------------------------------------------
# Elementwise ops: the tangent coefficient from (x, primal y), ops.py:64-84
# ---------------------------------------------------------------------------
def _sigmoid_deriv(x, s):
    return s * (1.0 - s)


def _log_deriv(x, y):
    # log floors x at 1e-30, so the primal is flat (tangent 0) below it
    return torch.where(x > 1e-30, 1.0 / x, torch.zeros_like(x))


def _gelu_erf_deriv(x, y):
    """gelu'(x) = Phi(x) + x phi(x), the closed form of ops.py:81-84."""
    cdf = 0.5 * torch.erfc(-x * (1.0 / math.sqrt(2.0)))
    pdf = torch.exp(-0.5 * x * x) * (1.0 / math.sqrt(2.0 * math.pi))
    return cdf + x * pdf


_DERIV = {
    "sigmoid": _sigmoid_deriv,
    "sigmoid_wide": _sigmoid_deriv,
    "tanh": lambda x, t: 1.0 - t * t,
    "exp": lambda x, y: y,
    "log": _log_deriv,
    "softplus": lambda x, y: -torch.expm1(-y),
    "elu": lambda x, y: torch.where(x > 0, torch.ones_like(y), y + 1.0),
    "gelu_erf": _gelu_erf_deriv,
}


class _Unary(torch.autograd.Function):
    """y = op(x) by the kernel; dx = deriv(x, y) * dy."""

    @staticmethod
    def forward(ctx, x, op, sched, cfg, max_doublings):
        y = _elementwise(x, op, sched, cfg, max_doublings)
        ctx.op = op
        ctx.save_for_backward(x, y)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, y = ctx.saved_tensors
        return _DERIV[ctx.op](x, y) * dy, None, None, None, None


def _unary(x, op, sched, cfg, max_doublings):
    if _needs_grad(x):
        return _Unary.apply(x, op, sched, cfg, max_doublings)
    return _elementwise(x, op, sched, cfg, max_doublings)


def sigmoid(x, sched=PAPER_SCHEDULE, cfg=PAPER_FIXED, max_doublings=3):
    """Sigmoid with the paper's |x| <= 1 clamp contract."""
    return _unary(x, "sigmoid", sched, cfg, max_doublings)


def sigmoid_wide(x, sched=PAPER_SCHEDULE, cfg=PAPER_FIXED, max_doublings=3):
    """Sigmoid with dyadic range extension to |x| <= 2^max_doublings."""
    return _unary(x, "sigmoid_wide", sched, cfg, max_doublings)


def tanh(x, sched=PAPER_SCHEDULE, cfg=PAPER_FIXED, max_doublings=3):
    """tanh with the paper's |z| <= 0.5 clamp contract."""
    return _unary(x, "tanh", sched, cfg, max_doublings)


def exp(x, sched=PAPER_SCHEDULE, cfg=PAPER_FIXED, max_doublings=3):
    """e^x over (-80, 80) (dyadic reduction + MR-HRC rotation)."""
    return _unary(x, "exp", sched, cfg, max_doublings)


def log(x, sched=PAPER_SCHEDULE, cfg=PAPER_FIXED, max_doublings=3):
    """ln x, x floored at 1e-30 (hyperbolic vectoring)."""
    return _unary(x, "log", sched, cfg, max_doublings)


def softplus(x, sched=PAPER_SCHEDULE, cfg=PAPER_FIXED, max_doublings=3):
    """log(1 + e^x) through the CORDIC exp and log legs."""
    return _unary(x, "softplus", sched, cfg, max_doublings)


def elu(x, sched=PAPER_SCHEDULE, cfg=PAPER_FIXED, max_doublings=3):
    """x for x > 0, e^x - 1 otherwise (alpha 1)."""
    return _unary(x, "elu", sched, cfg, max_doublings)


def gelu_erf(x, sched=PAPER_SCHEDULE, cfg=PAPER_FIXED, max_doublings=3):
    """Exact-form GELU 0.5 x (1 + erf(x / sqrt 2)), erf by the CORDIC exp."""
    return _unary(x, "gelu_erf", sched, cfg, max_doublings)


class _Silu(torch.autograd.Function):
    """y = silu kernel; dx = (s + x s (1 - s)) dy with s = sigmoid_wide(x)
    from a second kernel call, as ops.py:107-113."""

    @staticmethod
    def forward(ctx, x, sched, cfg, max_doublings):
        y = _elementwise(x, "silu", sched, cfg, max_doublings)
        s = _elementwise(x, "sigmoid_wide", sched, cfg, max_doublings)
        ctx.save_for_backward(x, s)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, s = ctx.saved_tensors
        return (s + x * s * (1.0 - s)) * dy, None, None, None


def silu(x, sched=PAPER_SCHEDULE, cfg=PAPER_FIXED, max_doublings=3):
    """x * sigmoid(x), wide-range, in one kernel pass."""
    if _needs_grad(x):
        return _Silu.apply(x, sched, cfg, max_doublings)
    return _elementwise(x, "silu", sched, cfg, max_doublings)


class _SiluMul(torch.autograd.Function):
    """The JAX rule's primal and tangent (ops.py:131-138): s =
    sigmoid_wide(g), y = u * (g * s), dg = u (s + g s (1 - s)) dy,
    du = (g * s) dy."""

    @staticmethod
    def forward(ctx, gate, up, sched, cfg, max_doublings):
        s = _elementwise(gate, "sigmoid_wide", sched, cfg, max_doublings)
        sg = gate * s
        ctx.save_for_backward(gate, up, s, sg)
        return up * sg

    @staticmethod
    def backward(ctx, dy):
        g, u, s, sg = ctx.saved_tensors
        dsg = s + g * s * (1.0 - s)
        return u * dsg * dy, sg * dy, None, None, None


def silu_mul(gate, up, sched=PAPER_SCHEDULE, cfg=PAPER_FIXED, max_doublings=3):
    """SwiGLU combiner up * gate * sigmoid(gate); equal shapes. Without a
    gradient: the fused kernel; with one: the JAX rule's primal (above)."""
    if gate.shape != up.shape:
        raise ValueError(f"silu_mul: shapes differ {gate.shape} {up.shape}")
    if _needs_grad(gate, up):
        return _SiluMul.apply(gate, up, sched, cfg, max_doublings)
    y = K.silu_mul_2d(gate.contiguous().view(-1), up.contiguous().view(-1),
                      sched=sched, cfg=cfg, max_doublings=max_doublings)
    return y.view(gate.shape)


# ---------------------------------------------------------------------------
# Row softmax / log-softmax along an axis (computed in float32, returned in
# x.dtype), ops.py:141-173
# ---------------------------------------------------------------------------
def _rowwise(kernel, x, axis, sched, cfg):
    xm = torch.movedim(x, axis, -1)
    lead, c = xm.shape[:-1], xm.shape[-1]
    y2 = kernel(xm.reshape(-1, c).to(torch.float32).contiguous(),
                sched=sched, cfg=cfg)
    return torch.movedim(y2.view(*lead, c).to(x.dtype), -1, axis)


class _Softmax(torch.autograd.Function):
    """dx = y * (dy - sum(y * dy))."""

    @staticmethod
    def forward(ctx, x, axis, sched, cfg):
        y = _rowwise(SM.softmax_2d, x, axis, sched, cfg)
        ctx.axis = axis
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, dy):
        (y,) = ctx.saved_tensors
        return (y * (dy - (y * dy).sum(ctx.axis, keepdim=True)),
                None, None, None)


class _LogSoftmax(torch.autograd.Function):
    """dx = dy - exp(y) * sum(dy)."""

    @staticmethod
    def forward(ctx, x, axis, sched, cfg):
        y = _rowwise(SM.log_softmax_2d, x, axis, sched, cfg)
        ctx.axis = axis
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, dy):
        (y,) = ctx.saved_tensors
        return (dy - torch.exp(y) * dy.sum(ctx.axis, keepdim=True),
                None, None, None)


def softmax(x, axis: int = -1, sched=PAPER_SCHEDULE, cfg=PAPER_FIXED):
    """CORDIC softmax along ``axis``. -1e30 masked lanes come out exactly 0."""
    if _needs_grad(x):
        return _Softmax.apply(x, axis, sched, cfg)
    return _rowwise(SM.softmax_2d, x, axis, sched, cfg)


def log_softmax(x, axis: int = -1, sched=PAPER_SCHEDULE, cfg=PAPER_FIXED):
    """CORDIC log-softmax along ``axis`` (the loss's datapath under
    ``loss_impl="cordic_pallas"``); -1e30 masked lanes keep their huge
    negative value."""
    if _needs_grad(x):
        return _LogSoftmax.apply(x, axis, sched, cfg)
    return _rowwise(SM.log_softmax_2d, x, axis, sched, cfg)


def paged_attend_gqa(q, k_pool, v_pool, tables, k_len, *, scale,
                     softmax_impl: str = "exact", kv_dtype=None,
                     kv_quant: str = "none", k_scale_pool=None,
                     v_scale_pool=None, sched=PAPER_SCHEDULE, cfg=PAPER_FIXED):
    """Block-walking paged GQA decode attend (kernels/paged_attention.py)."""
    return PA.gqa_decode(q, k_pool, v_pool, tables, k_len, scale=scale,
                         softmax_impl=softmax_impl, kv_dtype=kv_dtype,
                         kv_quant=kv_quant, k_scale_pool=k_scale_pool,
                         v_scale_pool=v_scale_pool, sched=sched, cfg=cfg)


def paged_attend_mla(q_eff, q_rope, c_pool, r_pool, tables, k_len, *, scale,
                     softmax_impl: str = "exact", sched=PAPER_SCHEDULE,
                     cfg=PAPER_FIXED):
    """Block-walking paged MLA decode attend, absorbed form
    (kernels/paged_attention.py). Returns latent outputs (B,H,R) float32."""
    return PA.mla_decode(q_eff, q_rope, c_pool, r_pool, tables, k_len,
                         scale=scale, softmax_impl=softmax_impl, sched=sched,
                         cfg=cfg)


def sigmoid_q(x_q, sched=PAPER_SCHEDULE, cfg=PAPER_FIXED):
    """The integer path: Q2.14 codes in (int16/int32), Q2.14 sigmoid codes
    out, same shape and dtype. Activations never leave the integer domain.
    No gradient (integer in and out), as in the JAX package."""
    y = K.act_q_2d(x_q.contiguous().view(-1), sched=sched, cfg=cfg)
    return y.view(x_q.shape)
