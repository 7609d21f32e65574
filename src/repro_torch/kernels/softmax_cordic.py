"""Whole-row CORDIC softmax: plain PyTorch version and the CUDA kernel.

Port of ``softmax_2d`` of ``repro/kernels/softmax_cordic.py``:

    u_i = x_i - max(x)                    row max
    u_i = k_i ln2 + r_i, |r_i| <= ln2/2   dyadic reduction (fused, as XLA)
    e_i = (cosh r_i + sinh r_i) * 2^k_i   Q2.14 MR-HRC rotation
    S   = sum_i e_i = m * 2^p             exponent-field frexp
    p_i = ((e_i/2) / m) * 2^(k_i - p + 1) R2-LVC division

Lanes more than e^-20 below the row max are exactly 0. The TPU kernel pads
columns to 128 lanes; this one takes the row as it is. The row sum runs left
to right in both the plain version and the kernel (``csrc/softmax.cu``), so
the two agree bit for bit; against the JAX kernel, whose reduction order is
XLA's, a lane can differ by one Q2.14 code step of its probability where the
sum lands on a rounding edge of its Q2.14 mantissa.

``log_softmax_2d`` (the train loss, ``loss_impl="cordic_pallas"``) is the
same exp sweep followed by the hyperbolic-vectoring log of the row sum:

    y_i = u_i - ln S,   ln S = 2 atanh((m-1)/(m+1)) + p ln2   (S = m 2^p)

Lanes masked with -1e30 keep their hugely negative u. Its rows are up to a
vocabulary wide (64000 lanes), too long for one thread, so the row sum is a
fixed-order block reduction (``_block_sum``): thread t of ``LOG_SOFTMAX_T``
sums lanes t, t+T, ... in order, then a pairwise tree adds the T partials.
The plain version replays that order, so kernel and plain version agree bit
for bit. Against the JAX kernel, whose sum XLA orders, only ln S can move:
where the sum lands on a rounding edge of its Q2.14 mantissa, m-1 and m+1
quantize one code apart and the vectoring settles a few codes of atanh
away, so y moves by at most ``LOG_SOFTMAX_ATOL`` on every lane of that row.
"""
from __future__ import annotations

import torch

from repro_torch.cordic_engine.core import PAPER_FIXED, FixedConfig
from repro_torch.cordic_engine.schedule import PAPER_SCHEDULE, MRSchedule
from repro_torch.kernels import build
from repro_torch.kernels.cordic_act import (
    _I32,
    _coshsinh_q,
    _dequantize_f,
    _exp2_i32,
    _fma_k,
    _fma_r,
    _guard_drop,
    _log_q,
    _lvc_div_q,
    _quantize_f,
    _shr,
    _wrap16,
)

#: lanes more than ~e^-20 below the row max flush to exactly zero
_DEAD_CUTOFF = -20.0
_MIN_K = -30.0
#: threads per row of the log-softmax kernel (csrc/softmax.cu), which fix
#: the order of its row sum
LOG_SOFTMAX_T = 256
#: |port - JAX| bound of log_softmax_2d: 4 codes of the vectoring's atanh
#: (2^-14 each), doubled by ln S = 2 atanh(...) + p ln2
LOG_SOFTMAX_ATOL = 2 * 4 * 2.0 ** -14


def _exp_codes(u: torch.Tensor, sched: MRSchedule, cfg: FixedConfig):
    """Dyadic reduction + rotation: (e^r codes, exponents k, dead mask)."""
    fb, bits = cfg.fmt.frac_bits, cfg.fmt.total_bits
    dead = u < _DEAD_CUTOFF
    k = _fma_k(u).clamp_min(_MIN_K)
    r = torch.where(dead, torch.zeros_like(u), _fma_r(u, k))
    c, s = _coshsinh_q(_quantize_f(r, fb, bits), sched, cfg)
    return _wrap16(c + s, bits), k.to(_I32), dead


def _lane_exp(u: torch.Tensor, sched: MRSchedule, cfg: FixedConfig) -> torch.Tensor:
    """CORDIC e^u per lane (u <= 0), dead lanes exactly 0."""
    eq, ki, dead = _exp_codes(u, sched, cfg)
    ef = _dequantize_f(eq, cfg.fmt.frac_bits) * _exp2_i32(ki)
    return torch.where(dead, torch.zeros_like(ef), ef)


def _lane_probs(u: torch.Tensor, ssum: torch.Tensor, sched: MRSchedule,
                cfg: FixedConfig) -> torch.Tensor:
    """Normalised probability per lane given the row sum (broadcastable)."""
    fb, bits = cfg.fmt.frac_bits, cfg.fmt.total_bits
    eq, ki, dead = _exp_codes(u, sched, cfg)
    p = (ssum.view(_I32) >> 23) - 127
    mq = _quantize_f(ssum * _exp2_i32(-p), fb, bits).expand_as(eq)
    t = _lvc_div_q(mq, _shr(eq, 1, bits), sched, cfg)
    out = _dequantize_f(_guard_drop(t, cfg), fb) * _exp2_i32(ki - p + 1)
    return torch.where(dead, torch.zeros_like(out), out)


def _seq_sum(x: torch.Tensor) -> torch.Tensor:
    """Left-to-right float32 sum over the last axis (keepdim), the order the
    kernels use."""
    acc = torch.zeros(x.shape[:-1] + (1,), dtype=x.dtype, device=x.device)
    for i in range(x.shape[-1]):
        acc = acc + x[..., i:i + 1]
    return acc


def _block_sum(x: torch.Tensor, threads: int = LOG_SOFTMAX_T) -> torch.Tensor:
    """Row sum over the last axis (keepdim) in the kernel's block order:
    strided per-thread sums left to right, then a pairwise tree over the
    ``threads`` partials (threads a power of two)."""
    rows, cols = x.shape
    n = -(-cols // threads) * threads
    xp = torch.nn.functional.pad(x, (0, n - cols))     # + 0.0 is exact
    steps = xp.view(rows, n // threads, threads)
    parts = torch.zeros(rows, threads, dtype=x.dtype, device=x.device)
    for i in range(steps.shape[1]):
        parts = parts + steps[:, i]
    width = threads
    while width > 1:
        width //= 2
        parts = parts[:, :width] + parts[:, width:2 * width]
    return parts


def log_softmax_2d_plain(x: torch.Tensor, *, sched: MRSchedule = PAPER_SCHEDULE,
                         cfg: FixedConfig = PAPER_FIXED) -> torch.Tensor:
    """Plain PyTorch version of the CORDIC log-softmax over the last axis
    of a 2D tensor."""
    xf = x.to(torch.float32)
    u = xf - xf.amax(dim=-1, keepdim=True)
    ssum = _block_sum(_lane_exp(u, sched, cfg))
    return u - _log_q(ssum, cfg)


def softmax_2d_plain(x: torch.Tensor, *, sched: MRSchedule = PAPER_SCHEDULE,
                     cfg: FixedConfig = PAPER_FIXED) -> torch.Tensor:
    """Plain PyTorch version of the CORDIC softmax over the last axis."""
    xf = x.to(torch.float32)
    m = xf.amax(dim=-1, keepdim=True)
    u = xf - m
    ssum = _seq_sum(_lane_exp(u, sched, cfg))
    return _lane_probs(u, ssum, sched, cfg)


def softmax_2d(x: torch.Tensor, *, sched: MRSchedule = PAPER_SCHEDULE,
               cfg: FixedConfig = PAPER_FIXED) -> torch.Tensor:
    """CORDIC softmax over the last axis of a (rows, cols) float32 tensor."""
    if x.dim() != 2:
        raise ValueError(f"softmax_2d takes a 2D tensor, got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return softmax_2d_plain(x, sched=sched, cfg=cfg)
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("softmax_2d: the kernel takes contiguous float32")
    rows, cols = x.shape
    y = torch.empty_like(x)
    rc = build.library("softmax").cordic_softmax_2d(
        x.data_ptr(), y.data_ptr(), rows, cols, build.params_ptr(sched, cfg),
        build.stream_ptr(x))
    build.check(rc, "softmax_2d")
    build.count("softmax_2d")
    return y


def log_softmax_2d(x: torch.Tensor, *, sched: MRSchedule = PAPER_SCHEDULE,
                   cfg: FixedConfig = PAPER_FIXED) -> torch.Tensor:
    """CORDIC log-softmax over the last axis of a (rows, cols) float32
    tensor."""
    if x.dim() != 2:
        raise ValueError(f"log_softmax_2d takes a 2D tensor, got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return log_softmax_2d_plain(x, sched=sched, cfg=cfg)
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("log_softmax_2d: the kernel takes contiguous float32")
    rows, cols = x.shape
    y = torch.empty_like(x)
    rc = build.library("softmax").cordic_log_softmax_2d(
        x.data_ptr(), y.data_ptr(), rows, cols,
        build.params_ptr(sched, cfg),
        build.stream_ptr(x))
    build.check(rc, "log_softmax_2d")
    build.count("log_softmax_2d")
    return y
