"""The work of each kernel's function and the card's peak rates: one count
that ``chip_smoke.py``'s bound column and the dry run's cost
(launch/op_cost.py) both read.

Peaks (NVIDIA H100 SXM data sheet): HBM3 3.35 TB/s, FP32 67 TFLOP/s
outside the tensor cores, dense BF16 989.4 TFLOP/s on the tensor cores,
NVLink 450 GB/s a direction (900 GB/s both ways). The INT32 rate is
derived from the card: SMs x 64 INT32 lanes x the max SM clock; on the card
``chip_smoke.Card`` reads the SMs and clock, and a host without one takes
the data sheet's 132 SMs at 1980 MHz (``INT32_OPS_S``).

A kernel wrapper books one op with its function's work (``booking``):
the bytes it must move (each input read once, each output written once)
and its INT32 and FP32 operations, whatever route runs (the kernel, the
plain version on a CPU tensor, or nothing on a meta tensor). The counts
come from the schedule (``pipeline_ops``): the least INT32 work a stage
needs, one operation per shift, compare, select, add/sub and 16-bit wrap
(a sign extension), a conditional add or subtract counted as a select of
the operand's sign plus an add. Where the work depends on the data (the
live lanes of a masked softmax row, the live keys of a decode), the
booking counts this call's data when its tensors hold values, and every
lane on a meta tensor.
"""
from __future__ import annotations

import contextlib
import functools
from typing import List

import torch

#: H100 SXM published rates: HBM3 bytes/s, FP32 FLOP/s outside the tensor
#: cores, dense BF16 tensor-core FLOP/s, NVLink bytes/s a direction
HBM_BYTES_S = 3.35e12
FP32_FLOP_S = 67e12
BF16_FLOP_S = 989.4e12
NVLINK_BYTES_S = 450e9
#: INT32 lanes an SM, and the data sheet's SMs and max SM clock
INT32_LANES_PER_SM = 64
H100_SMS, H100_MAX_SM_HZ = 132, 1.98e9
INT32_OPS_S = H100_SMS * INT32_LANES_PER_SM * H100_MAX_SM_HZ

#: the name of the peak set, for the records that use it
PEAKS = {"name": "H100 SXM data sheet", "bf16_flop_s": BF16_FLOP_S,
         "fp32_flop_s": FP32_FLOP_S, "int32_op_s": INT32_OPS_S,
         "hbm_bytes_s": HBM_BYTES_S, "nvlink_bytes_s": NVLINK_BYTES_S}


def pipeline_ops(sched):
    """INT32 operations per element of each function's pipeline (the
    module docstring's rule), by function and route (``_tab``: the table
    route of a 16-bit format)."""
    from repro_torch.kernels.cordic_act import _HYP_VEC_JS as HYP_VEC_JS

    wrap, cadd = 1, 2
    r2 = 1 + 2 + 3 * (cadd + wrap)                 # sign, xs/ys, x/y/z: 12
    r4 = 1 + 3 + 2 * (1 + 2 + cadd + wrap) + (2 + cadd + wrap)   # 21
    lvc = 1 + 1 + 2 * (cadd + wrap)                # sign, xs, y/t: 8
    rot = len(sched.r2_js) * r2 + len(sched.r4_js) * r4
    div = len(sched.lvc_js) * lvc
    boundary = 7 + 2 + 5 + 2     # quantize, input shr, 1/2 + t/2, dequantize
    exp_codes = rot + 7 + 2      # quantize r, rotation, c + s
    normalize = div + 2 + 4      # LVC divide and its boundary ops
    # the table route (a 16-bit format): the stage is one load of its code,
    # its index clamped to the table and offset (4); the dyadic reduction
    # before the e^r stage is 4 (two fused multiply-adds, floor, max)
    lookup = 4
    exp_codes_tab = 4 + 7 + lookup
    return {"sigmoid": rot + div + boundary,
            # act_q_2d: integer codes in and out, no quantize/dequantize
            "sigmoid_q": rot + div + 2 + 5,
            # its table route: the index ((x >> 1) & 0xFFFF) ^ 0x8000 (3)
            # and the lookup
            "sigmoid_q_tab": 3 + 1,
            "wide": rot + div + boundary + 6 + 2,  # doubling count, 2^-k
            # log_softmax_2d: one rotation per live lane and its add into
            # the row sum; the vectoring log runs once per row
            "log_softmax_lane": exp_codes + 1,
            "log_row": len(HYP_VEC_JS) * r2 + 7 + 7 + 8,
            # softmax_2d: one rotation per lane, since the function it
            # replaces keeps each lane's e^r codes for the divide (the CUDA
            # kernel recomputes them, which is its own cost, not the work's)
            "softmax_lane": exp_codes + normalize,
            # gqa_decode / mla_decode cordic: the least work of the
            # function, one rotation per lane (its e^r codes serve both the
            # row sum and the divide) and the normalize, as softmax_lane;
            # the TPU kernel rotates again in its normalize pass, and the
            # CUDA kernels keep the codes
            "decode_lane": exp_codes + normalize,
            # act_2d gelu_erf: one e^r rotation with its dyadic boundary
            # (the erf prefactor, sqrt and GELU product are float work)
            "gelu_erf": exp_codes + 4,
            # act_2d exp / softplus / elu: the e^r rotation with its
            # boundary; log: the vectoring rotation
            "exp": exp_codes + 4,
            "log": len(HYP_VEC_JS) * r2 + 7 + 7 + 8,
            # the same functions on the table route: its own operations
            "sigmoid_tab": lookup + boundary,
            "wide_tab": lookup + boundary + 6 + 2,
            "exp_codes_tab": exp_codes_tab,
            "exp_tab": exp_codes_tab + 4,
            "log_softmax_lane_tab": exp_codes_tab + 1,
            "softmax_lane_tab": exp_codes_tab + normalize,
            "gelu_erf_tab": exp_codes_tab + 4}


def dequant_flops() -> int:
    """FP32 operations of one KV dequant (functions.multiply_float over a
    code): the code's scale to a value, three per linear-rotation stage
    (the shifted product, the y and z updates), the sign product, the
    sign and the 2^e scale."""
    from repro_torch.cordic_engine.schedule import LIN_ROTATION

    return 1 + 3 * len(LIN_ROTATION.r2_js) + 3


# ---------------------------------------------------------------------------
# Each kernel's work: (bytes, INT32 operations, FP32 operations)
# ---------------------------------------------------------------------------
#: act_2d's op -> its pipeline_ops entry (log has no table stage)
ACT_OPS = {"sigmoid": "sigmoid", "tanh": "wide", "sigmoid_wide": "wide",
           "silu": "wide", "exp": "exp", "softplus": "exp", "elu": "exp",
           "gelu_erf": "gelu_erf", "log": "log"}
#: FP32 operations an element of an act_2d op does beside its pipeline
ACT_FLOPS = {"gelu_erf": 16}


def _ops(sched, fixed, key: str) -> int:
    from repro_torch.kernels import code_tables as CT

    ops = pipeline_ops(sched)
    tab = key + "_tab"
    return ops[tab] if CT.table_route(fixed) and tab in ops else ops[key]


def _live(x, floor: float = -1e29) -> int:
    """Lanes above the mask value: counted on a tensor with values, every
    lane on a meta one."""
    if x.device.type == "meta":
        return x.numel()
    return int((x > floor).sum())


def act_2d_work(x, op: str, sched, fixed):
    n = x.numel()
    return (2 * n * x.element_size(), _ops(sched, fixed, ACT_OPS[op]) * n,
            ACT_FLOPS.get(op, 0) * n)


def silu_mul_2d_work(gate, sched, fixed):
    n = gate.numel()
    return 3 * n * gate.element_size(), _ops(sched, fixed, "wide") * n, 0


def act_q_2d_work(x_q, sched, fixed):
    n = x_q.numel()
    return 2 * n * x_q.element_size(), _ops(sched, fixed, "sigmoid_q") * n, 0


def softmax_2d_work(x, sched, fixed):
    return (2 * x.numel() * x.element_size(),
            _ops(sched, fixed, "softmax_lane") * _live(x), 0)


def row_max_work(x):
    """softmax_split_max: the span read, a float32 max a row written, one
    compare a lane."""
    return x.numel() * x.element_size() + 4 * x.shape[0], 0, x.numel()


def softmax_split_windows_work(x, sched, fixed):
    """softmax_split_windows: the span and the row max read, a window sum
    per 32 lanes written; a rotation per live lane and its add into the
    window sum."""
    rows, cols = x.shape
    nbytes = x.numel() * x.element_size() + 4 * rows + 4 * rows * (cols // 32)
    return nbytes, _ops(sched, fixed, "log_softmax_lane") * _live(x), 0


def softmax_split_probs_work(x, windows, sched, fixed):
    """softmax_split_probs: the span, the row max and every span's window
    sums read, the span written; the later levels' adds once a row, and a
    rotation and the normalize per live lane (as softmax_2d's lane)."""
    rows = x.shape[0]
    nbytes = (2 * x.numel() * x.element_size() + 4 * rows
              + windows.numel() * windows.element_size())
    return nbytes, _ops(sched, fixed, "softmax_lane") * _live(x), windows.numel()


def log_softmax_2d_work(x, sched, fixed):
    rows = x.shape[0]
    if x.device.type == "meta":
        live = x.numel()
    else:
        live = int((x - x.amax(-1, keepdim=True) >= -20.0).sum())
    ops = (_ops(sched, fixed, "log_softmax_lane") * live
           + pipeline_ops(sched)["log_row"] * rows)
    return 2 * x.numel() * x.element_size(), ops, 3 * x.numel()


def _keys_blocks(tables, k_len, L: int):
    """(live keys, live blocks) over the rows: from ``k_len``, or every
    table entry on a meta tensor."""
    if k_len.device.type == "meta":
        return tables.numel() * L, tables.numel()
    kl = k_len.to("cpu").long()
    return int(kl.sum()), int((-(-kl // L)).sum())


def gqa_decode_work(q, k_pool, tables, k_len, impl: str, sched, scales=None):
    """q (B,KH,G,hd), pools (N,L,KH,hd) (codes with float32 ``scales``
    under kv_quant): the live blocks' K and V (and scales), the tables,
    lengths, q and the float32 output; one lane per live key and query
    head, as chip_smoke's bound."""
    B, KH, G, hd = q.shape
    L = k_pool.shape[1]
    keys, blocks = _keys_blocks(tables, k_len, L)
    nbytes = (q.numel() * q.element_size()
              + 2 * blocks * L * KH * hd * k_pool.element_size()
              + tables.numel() * 4 + k_len.numel() * 4 + q.numel() * 4)
    lanes = keys * KH * G
    flops = 4 * hd * lanes
    if scales is not None:
        nbytes += 2 * blocks * KH * 4
        flops += dequant_flops() * 2 * blocks * L * KH * hd
    ops = pipeline_ops(sched)["decode_lane"] * lanes if impl != "exact" else 0
    return nbytes, ops, flops


def mla_decode_work(q_eff, q_rope, c_pool, tables, k_len, impl: str, sched):
    """q_eff (B,H,R), q_rope (B,H,P), pools (N,L,R) and (N,L,P)."""
    B, H, R = q_eff.shape
    P = q_rope.shape[-1]
    L = c_pool.shape[1]
    keys, blocks = _keys_blocks(tables, k_len, L)
    nbytes = (q_eff.numel() * q_eff.element_size()
              + q_rope.numel() * q_rope.element_size()
              + blocks * L * (R + P) * c_pool.element_size() + tables.numel() * 4
              + k_len.numel() * 4 + B * H * R * 4)
    lanes = keys * H
    ops = pipeline_ops(sched)["decode_lane"] * lanes if impl != "exact" else 0
    return nbytes, ops, (2 * (R + P) + 2 * R) * lanes


# ---------------------------------------------------------------------------
# Booking: the active counters (launch/op_cost.py) and the mute they read
# ---------------------------------------------------------------------------
#: the op counters entered (innermost last)
COUNTERS: List[object] = []
#: > 0 while a wrapper's own work runs: the counters skip its aten ops
MUTED = [0]
#: how many times the counters count each op run now (``repeated``)
REPEAT = [1]


@contextlib.contextmanager
def repeated(n: int):
    """Inside it, each op counts ``n`` times: a loop whose steps do the
    same work, run once on meta tensors (the dry run) and counted for all
    its steps."""
    REPEAT[0] *= n
    try:
        yield
    finally:
        REPEAT[0] //= n


class _RepeatedStep(torch.autograd.Function):
    """``repeated_step`` under grad: the step's forward and its backward
    each counted ``n`` times (the backward recomputes the step's graph
    uncounted, then counts the gradient's ops)."""

    @staticmethod
    def forward(ctx, n, fn, *inputs):
        ctx.n, ctx.fn = n, fn
        ctx.needs = [t.requires_grad for t in inputs]
        ctx.save_for_backward(*inputs)
        with repeated(n):
            return tuple(fn(*inputs))

    @staticmethod
    def backward(ctx, *grads):
        ins = [t.detach().requires_grad_(r) for t, r in zip(ctx.saved_tensors, ctx.needs)]
        with torch.enable_grad(), _muted():
            out = ctx.fn(*ins)
        want = [t for t in ins if t.requires_grad]
        with repeated(ctx.n):
            got = iter(torch.autograd.grad(out, want, grads, allow_unused=True))
        return (None, None) + tuple(next(got) if r else None for r in ctx.needs)


def repeated_step(n: int, fn, *inputs):
    """``fn(*inputs)`` (a tuple of tensors) run once with its ops counted
    ``n`` times, and under grad its backward too: a loop of ``n`` steps
    doing the same work, on meta tensors (the dry run's sLSTM time loop)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        return _RepeatedStep.apply(n, fn, *inputs)
    with repeated(n):
        return fn(*inputs)


@contextlib.contextmanager
def _muted():
    MUTED[0] += 1
    try:
        yield
    finally:
        MUTED[0] -= 1


def booking(name: str, work):
    """Book one call of kernel ``name`` in every active counter and mute
    their counting of the ops the wrapper runs; ``work`` is a callable
    giving (bytes, INT32 operations, FP32 operations), called only when a
    counter is active. A no-op context otherwise."""
    if not COUNTERS or MUTED[0]:
        return contextlib.nullcontext()
    with _muted():
        nbytes, int_ops, flops = work()
    for c in COUNTERS:
        c.book_kernel(name, nbytes, int_ops, flops)
    return _muted()


def booked(name: str, work):
    """Decorate a kernel wrapper: each call books ``work(*args, **kwargs)``
    (``booking``) around the wrapper's own run."""
    def deco(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with booking(name, lambda: work(*args, **kwargs)):
                return fn(*args, **kwargs)
        return call
    return deco
