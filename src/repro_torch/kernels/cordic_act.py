"""MR-HRC CORDIC activations: plain PyTorch stages and the CUDA kernels.

Port of ``repro/kernels/cordic_act.py``. The stages ``_wrap16`` ..
``_wide_sigmoid_f`` are torch functions on int32 lanes, bit-identical to the
JAX stages of the same names (:60-292); they are the plain version of the
CUDA kernels in ``csrc/act.cu`` (shared stages in ``csrc/cordic.cuh``) and
what the CPU runs. ``act_2d`` and ``silu_mul_2d`` take a tensor on the CPU
through the plain version and a CUDA tensor through the kernel; there is no
fallback between the two.

Float boundary ops round as jitted XLA rounds them: XLA:CPU contracts
``s2 + (1 - s) * (1 - s)`` (``_wide_sigmoid_f``, into fma(1-s, 1-s, s2),
since s2 = s*s is also the numerator), ``u * _INV_LN2 + 0.5`` and
``u - k * _LN2`` (the dyadic reduction of the softmax stages) into FMAs. The
plain versions compute those three in float64 and round once to float32
(``_fma_*`` below): a product of two float32 values is exact in float64.
The kernels write them with ``fmaf``.

The exp and log legs (``_exp_q``, ``_log_q``) reuse the same rules: the
dyadic reduction ``r = x - k * _LN2`` is the fused form (``_fma_r``); the log
tail ``2 * at + p * _LN2`` rounds the same whether XLA fuses it or not, so it
is written in two steps.

Ops: the sigmoid family (``sigmoid``, ``tanh``, ``sigmoid_wide``,
``silu``), ``exp``, ``log``, ``softplus``, ``elu`` and ``gelu_erf`` (the
``_erf_q`` stage over ``_exp_q``, whose rational prefactor XLA computes
without FMAs). ``act_q_2d`` is the
paper's integer datapath: Q2.14 int16/int32 codes in, sigmoid codes of the
same dtype out; in a 16-bit format its kernel reads one 65,536-entry
table of sigmoid codes (``code_tables.py``).
"""
from __future__ import annotations

import math

import torch

from repro_torch.core import numerics as nx
from repro_torch.cordic_engine.core import PAPER_FIXED, FixedConfig
from repro_torch.cordic_engine.schedule import (
    HYP_VECTORING,
    PAPER_SCHEDULE,
    MRSchedule,
)
from repro_torch.kernels import build
from repro_torch.kernels import code_tables as CT
from repro_torch.kernels import cost

_I32 = torch.int32
#: np.float32(log 2) and np.float32(1 / log 2), as float64 values
_LN2 = float(torch.tensor(math.log(2.0), dtype=torch.float32))
_INV_LN2 = float(torch.tensor(1.0 / math.log(2.0), dtype=torch.float32))
#: exp clamp: keeps 2^k inside the normal float32 exponent range
_EXP_CLIP = 80.0
#: hyperbolic-vectoring schedule of the log leg (j=1..14 with repeats)
_HYP_VEC_JS = HYP_VECTORING.r2_js

#: erf's rational prefactor constants and 1/sqrt(2), float32 values
_ERF_A = float(torch.tensor(0.147, dtype=torch.float32))
_FOUR_PI = float(torch.tensor(4.0 / math.pi, dtype=torch.float32))
_INV_SQRT2 = float(torch.tensor(1.0 / math.sqrt(2.0), dtype=torch.float32))

#: op name -> op code of csrc/act.cu
OPS = ("sigmoid", "tanh", "sigmoid_wide", "silu", "exp", "log", "softplus",
       "elu", "gelu_erf")
_OP_CODE = {op: i for i, op in enumerate(OPS)}
#: the code table each op reads on the table route; log has no table stage
_TABLE_ROW = {"sigmoid": CT.TANH_ROW, "tanh": CT.TANH_ROW,
              "sigmoid_wide": CT.TANH_ROW, "silu": CT.TANH_ROW, "exp": CT.EXP_ROW,
              "softplus": CT.EXP_ROW, "elu": CT.EXP_ROW, "gelu_erf": CT.EXP_ROW}


# ---------------------------------------------------------------------------
# Plain stages (int32 lanes), one per JAX stage
# ---------------------------------------------------------------------------
def _wrap16(v: torch.Tensor, bits: int) -> torch.Tensor:
    """Mask an int32 lane to ``bits``-bit two's complement (add/and/sub)."""
    mask = (1 << bits) - 1
    half = 1 << (bits - 1)
    return ((v + half) & mask) - half


def _shr(v: torch.Tensor, s: int, bits: int) -> torch.Tensor:
    """Arithmetic right shift with truncation, re-wrapped to the width."""
    if s <= 0:
        return v
    return _wrap16(v >> s, bits)


def _coshsinh_q(zq: torch.Tensor, sched: MRSchedule, cfg: FixedConfig):
    """MR-HRC rotation: angle codes -> (cosh, sinh) codes in cfg.fmt."""
    bits = cfg.fmt.total_bits
    fb = cfg.fmt.frac_bits
    zbits = cfg.zfmt.total_bits
    zfb = cfg.zfmt.frac_bits

    z = zq
    if cfg.z_guard:
        z = _wrap16(z << cfg.z_guard, zbits)
    x = torch.full_like(zq, int(round(sched.x0 * (1 << fb))))
    y = torch.zeros_like(zq)

    for j in sched.r2_js:
        a = int(round(math.atanh(2.0 ** -j) * (1 << zfb)))
        pos = z >= 0
        xs = _shr(x, j, bits)
        ys = _shr(y, j, bits)
        x_n = torch.where(pos, _wrap16(x + ys, bits), _wrap16(x - ys, bits))
        y_n = torch.where(pos, _wrap16(y + xs, bits), _wrap16(y - xs, bits))
        z = torch.where(pos, _wrap16(z - a, zbits), _wrap16(z + a, zbits))
        x, y = x_n, y_n

    for j in sched.r4_js:
        t05 = int(round(0.5 * 4.0 ** -j * (1 << zfb)))
        t15 = int(round(1.5 * 4.0 ** -j * (1 << zfb)))
        a1 = int(round(math.atanh(1.0 * 4.0 ** -j) * (1 << zfb)))
        a2 = int(round(math.atanh(2.0 * 4.0 ** -j) * (1 << zfb)))
        pos = z >= 0
        mag2 = (z >= t15) | (z < -t15)
        mag0 = (z < t05) & (z >= -t05)
        xs1 = _shr(x, 2 * j, bits)
        ys1 = _shr(y, 2 * j, bits)
        xs2 = _shr(x, 2 * j - 1, bits)
        ys2 = _shr(y, 2 * j - 1, bits)
        zero = torch.zeros_like(x)
        dx = torch.where(mag0, zero, torch.where(mag2, ys2, ys1))
        dy = torch.where(mag0, zero, torch.where(mag2, xs2, xs1))
        da = torch.where(mag0, zero, torch.where(mag2, a2, a1).to(_I32))
        x = torch.where(pos, _wrap16(x + dx, bits), _wrap16(x - dx, bits))
        y = torch.where(pos, _wrap16(y + dy, bits), _wrap16(y - dy, bits))
        z = torch.where(pos, _wrap16(z - da, zbits), _wrap16(z + da, zbits))
    return x, y


def _lvc_div_q(x: torch.Tensor, y: torch.Tensor, sched: MRSchedule,
               cfg: FixedConfig) -> torch.Tensor:
    """Radix-2 linear vectoring: y/x in cfg.zfmt codes."""
    bits = cfg.fmt.total_bits
    zbits = cfg.zfmt.total_bits
    zfb = cfg.zfmt.frac_bits
    t = torch.zeros_like(y)
    for j in sched.lvc_js:
        pos = y >= 0
        xs = _shr(x, j, bits)
        step = 1 << max(zfb - j, 0)
        y = torch.where(pos, _wrap16(y - xs, bits), _wrap16(y + xs, bits))
        t = torch.where(pos, _wrap16(t + step, zbits), _wrap16(t - step, zbits))
    return t


def _guard_drop(t: torch.Tensor, cfg: FixedConfig) -> torch.Tensor:
    """Requantize zfmt -> fmt (round to nearest on the guard-bit drop)."""
    if cfg.z_guard:
        t = _wrap16((t + (1 << (cfg.z_guard - 1))) >> cfg.z_guard,
                    cfg.fmt.total_bits)
    return t


def _cordic_tanh_q(zq: torch.Tensor, sched: MRSchedule,
                   cfg: FixedConfig) -> torch.Tensor:
    """tanh codes of angle codes |z| <= 0.5 (core.cordic.tanh_mr_q)."""
    x, y = _coshsinh_q(zq, sched, cfg)
    return _guard_drop(_lvc_div_q(x, y, sched, cfg), cfg)


def _tanh_code(zq: torch.Tensor, sched: MRSchedule, cfg: FixedConfig,
               tables=None) -> torch.Tensor:
    """The tanh stage: the pipeline, or one lookup in ``tables`` (the code
    tables of a 16-bit format, ``code_tables.py``), as the kernels' table
    route reads it."""
    if tables is not None:
        return tables.tanh_code(zq)
    return _cordic_tanh_q(zq, sched, cfg)


def _exp_code(zq: torch.Tensor, sched: MRSchedule, cfg: FixedConfig,
              tables=None) -> torch.Tensor:
    """The e^r stage: wrap(cosh r + sinh r) codes of angle codes, from the
    rotation or from ``tables``."""
    if tables is not None:
        return tables.exp_code(zq)
    c, s = _coshsinh_q(zq, sched, cfg)
    return _wrap16(c + s, cfg.fmt.total_bits)


def _cordic_sigmoid_q(xq: torch.Tensor, sched: MRSchedule,
                      cfg: FixedConfig, tables=None) -> torch.Tensor:
    """Sigmoid codes: input halving, tanh core, 1/2 + t/2 output stage."""
    bits = cfg.fmt.total_bits
    fb = cfg.fmt.frac_bits
    t = _tanh_code(_shr(xq, 1, bits), sched, cfg, tables)
    t2 = _wrap16((t + 1) >> 1, bits)
    return _wrap16((1 << (fb - 1)) + t2, bits)


def _quantize_f(xf: torch.Tensor, fb: int, bits: int = 16) -> torch.Tensor:
    """float32 -> Q codes, round half to even, saturating."""
    lim = (1 << (bits - 1)) - 1
    q = torch.round(xf * float(1 << fb))
    return q.clamp(-lim - 1, lim).to(_I32)


def _dequantize_f(q: torch.Tensor, fb: int) -> torch.Tensor:
    return q.to(torch.float32) * (1.0 / (1 << fb))


def _exp2_i32(k: torch.Tensor) -> torch.Tensor:
    """2^k for int32 k through the float32 exponent field."""
    return ((k.to(_I32) + 127) << 23).view(torch.float32)


def _frexp_f(v: torch.Tensor):
    """(m, p) with v = m * 2^p, m in [0.5, 1), through the exponent field
    (positive normal float32)."""
    e = (v.view(_I32) >> 23) - 127
    return v * _exp2_i32(-e) * 0.5, e + 1


def _hyp_vector_q(x: torch.Tensor, y: torch.Tensor, cfg: FixedConfig,
                  js=_HYP_VEC_JS) -> torch.Tensor:
    """Radix-2 hyperbolic vectoring: drives y to 0, returns atanh(y0/x0)
    codes in cfg.zfmt."""
    bits = cfg.fmt.total_bits
    zbits = cfg.zfmt.total_bits
    zfb = cfg.zfmt.frac_bits
    z = torch.zeros_like(y)
    for j in js:
        a = int(round(math.atanh(2.0 ** -j) * (1 << zfb)))
        plus = y < 0
        xs = _shr(x, j, bits)
        ys = _shr(y, j, bits)
        x_n = torch.where(plus, _wrap16(x + ys, bits), _wrap16(x - ys, bits))
        y_n = torch.where(plus, _wrap16(y + xs, bits), _wrap16(y - xs, bits))
        z = torch.where(plus, _wrap16(z - a, zbits), _wrap16(z + a, zbits))
        x, y = x_n, y_n
    return z


def _exp_q(xf: torch.Tensor, sched: MRSchedule, cfg: FixedConfig,
           tables=None) -> torch.Tensor:
    """e^x over (-80, 80): dyadic reduction + Q2.14 cosh+sinh rotation."""
    fb, bits = cfg.fmt.frac_bits, cfg.fmt.total_bits
    x = xf.clamp(-_EXP_CLIP, _EXP_CLIP)
    k = torch.round(x * _INV_LN2)
    r = _fma_r(x, k)
    eq = _exp_code(_quantize_f(r, fb, bits), sched, cfg, tables)
    return _dequantize_f(eq, fb) * _exp2_i32(k.to(_I32))


def _log_q(v: torch.Tensor, cfg: FixedConfig) -> torch.Tensor:
    """ln v (v floored at 1e-30): exponent-field mantissa split, then
    ln v = 2 atanh((m-1)/(m+1)) + p ln2 by hyperbolic vectoring."""
    fb, bits = cfg.fmt.frac_bits, cfg.fmt.total_bits
    zfb = cfg.zfmt.frac_bits
    js = build.log_vectoring_js(fb)
    m, p = _frexp_f(v.clamp_min(1e-30))
    num = _quantize_f(m - 1.0, fb, bits)
    den = _quantize_f(m + 1.0, fb, bits)
    at = _dequantize_f(_hyp_vector_q(den, num, cfg, js), zfb)
    return 2.0 * at + p.to(torch.float32) * _LN2


def _erf_q(u: torch.Tensor, sched: MRSchedule, cfg: FixedConfig,
           tables=None) -> torch.Tensor:
    """Exponential erf approximation with the CORDIC exp core (|err| <
    2.5e-4): erf(u)^2 ~ 1 - exp(-u^2 (4/pi + a u^2) / (1 + a u^2)); XLA
    rounds the prefactor's two products (no FMA), the sqrt is a correctly
    rounded boundary op."""
    u2 = u * u
    g = u2 * (_FOUR_PI + _ERF_A * u2) / (1.0 + _ERF_A * u2)
    e = _exp_q(-g, sched, cfg, tables)
    return torch.sign(u) * nx.sqrt((1.0 - e).clamp_min(0.0))


def _fma_denom(s: torch.Tensor, s2: torch.Tensor) -> torch.Tensor:
    """s2 + (1-s)*(1-s) as XLA computes it in ``_wide_sigmoid_f``, where
    s2 = round(s*s) is a value of its own (it is also the numerator):
    fma(1-s, 1-s, s2)."""
    t = (1.0 - s).double()
    return (t * t + s2.double()).to(torch.float32)


def _fma_log2e_half(u: torch.Tensor) -> torch.Tensor:
    """u * _INV_LN2 + 0.5 with the multiply-add fused, as XLA does."""
    return (u.double() * _INV_LN2 + 0.5).to(torch.float32)


def _fma_k(u: torch.Tensor) -> torch.Tensor:
    """The dyadic exponent floor(u / ln2 + 1/2)."""
    return torch.floor(_fma_log2e_half(u))


def _fma_r(u: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """u - k * _LN2 with the multiply-add fused, as XLA does."""
    return (u.double() - k.double() * _LN2).to(torch.float32)


def _wide_sigmoid_f(xf: torch.Tensor, sched: MRSchedule, cfg: FixedConfig,
                    max_doublings: int, tables=None) -> torch.Tensor:
    """Dyadic range extension around the Q2.14 core (|x| <= 2^k)."""
    ax = xf.abs()
    k = torch.zeros_like(xf, dtype=_I32)
    for i in range(max_doublings):
        k = k + (ax > 2.0 ** i).to(_I32)
    xs = (xf * _exp2_i32(-k)).clamp(-1.0, 1.0)
    s = _dequantize_f(_cordic_sigmoid_q(
        _quantize_f(xs, cfg.fmt.frac_bits, cfg.fmt.total_bits), sched, cfg,
        tables), cfg.fmt.frac_bits)
    for i in range(max_doublings):
        s2 = s * s
        doubled = s2 / _fma_denom(s, s2).clamp_min(1e-12)
        s = torch.where(k > i, doubled, s)
    return s


# ---------------------------------------------------------------------------
# Plain versions of the kernels
# ---------------------------------------------------------------------------
def act_2d_plain(x: torch.Tensor, op: str, *, sched: MRSchedule = PAPER_SCHEDULE,
                 cfg: FixedConfig = PAPER_FIXED, max_doublings: int = 3,
                 tables=None) -> torch.Tensor:
    """Plain PyTorch version of the activation kernel (any shape).
    ``tables`` (``code_tables.code_tables`` of a 16-bit format) takes the
    tanh and e^r stages from lookups, as the kernel's table route does; the
    boundary code around them is the same."""
    _check_op(op)
    xf = x.to(torch.float32)
    fb, bits = cfg.fmt.frac_bits, cfg.fmt.total_bits
    if op == "sigmoid":
        xq = _quantize_f(xf.clamp(-1.0, 1.0), fb, bits)
        out = _dequantize_f(_cordic_sigmoid_q(xq, sched, cfg, tables), fb)
    elif op == "tanh":
        zq = _quantize_f(xf.clamp(-0.5, 0.5), fb, bits)
        out = _dequantize_f(_tanh_code(zq, sched, cfg, tables), fb)
    elif op == "sigmoid_wide":
        out = _wide_sigmoid_f(xf, sched, cfg, max_doublings, tables)
    elif op == "silu":
        out = xf * _wide_sigmoid_f(xf, sched, cfg, max_doublings, tables)
    elif op == "exp":
        out = _exp_q(xf, sched, cfg, tables)
    elif op == "log":
        out = _log_q(xf, cfg)
    elif op == "softplus":
        # log(1 + e^x) = relu(x) + log(1 + e^-|x|), both CORDIC legs
        e = _exp_q(-xf.abs(), sched, cfg, tables)
        out = xf.clamp_min(0.0) + _log_q(1.0 + e, cfg)
    elif op == "elu":
        em1 = _exp_q(xf.clamp_max(0.0), sched, cfg, tables) - 1.0
        out = torch.where(xf > 0, xf, em1)
    else:  # gelu_erf: 0.5 x (1 + erf(x / sqrt 2))
        out = 0.5 * xf * (1.0 + _erf_q(xf * _INV_SQRT2, sched, cfg, tables))
    return out.to(x.dtype)


def silu_mul_2d_plain(gate: torch.Tensor, up: torch.Tensor, *,
                      sched: MRSchedule = PAPER_SCHEDULE,
                      cfg: FixedConfig = PAPER_FIXED,
                      max_doublings: int = 3, tables=None) -> torch.Tensor:
    """Plain PyTorch version of the fused SwiGLU kernel: up * g * s(g);
    ``tables`` as in ``act_2d_plain``."""
    g = gate.to(torch.float32)
    u = up.to(torch.float32)
    s = _wide_sigmoid_f(g, sched, cfg, max_doublings, tables)
    return (u * g * s).to(gate.dtype)


def act_q_2d_plain(x_q: torch.Tensor, *, sched: MRSchedule = PAPER_SCHEDULE,
                   cfg: FixedConfig = PAPER_FIXED, table=None) -> torch.Tensor:
    """Plain PyTorch version of the integer sigmoid kernel: Q2.14 codes in
    (int16 or int32), sigmoid codes of the same dtype out. ``table``
    (``code_tables.sigmoid_q_table`` of a 16-bit format) looks every code up
    as the kernel's table route does."""
    if table is not None:
        return table[CT.sigmoid_q_index(x_q).long()].to(x_q.dtype)
    return _cordic_sigmoid_q(x_q.to(_I32), sched, cfg).to(x_q.dtype)


# ---------------------------------------------------------------------------
# Wrappers: CPU tensor -> plain version, CUDA tensor -> kernel
# ---------------------------------------------------------------------------
def _check_op(op: str) -> None:
    if op not in _OP_CODE:
        raise ValueError(f"unknown act op {op!r}")


def _check_cuda(name: str, *ts: torch.Tensor) -> None:
    for t in ts:
        if t.dtype not in build.DTYPE_CODE:
            raise TypeError(f"{name}: dtype {t.dtype} not supported "
                            "(float32 or bfloat16)")
        if not t.is_contiguous():
            raise ValueError(f"{name}: input must be contiguous")
        if t.device != ts[0].device or t.dtype != ts[0].dtype:
            raise ValueError(f"{name}: inputs must share device and dtype")


@cost.booked("act_2d", lambda x, op, sched=PAPER_SCHEDULE, cfg=PAPER_FIXED, **_:
             cost.act_2d_work(x, op, sched, cfg))
def act_2d(x: torch.Tensor, op: str, *, sched: MRSchedule = PAPER_SCHEDULE,
           cfg: FixedConfig = PAPER_FIXED, max_doublings: int = 3) -> torch.Tensor:
    """CORDIC activation over a tensor (the TPU kernel took 2D tiles; this
    one runs over the flat elements of any shape). A meta tensor (the dry
    run) is checked and gets an output of its shape, its work booked."""
    if x.device.type == "cpu":
        return act_2d_plain(x, op, sched=sched, cfg=cfg,
                            max_doublings=max_doublings)
    _check_op(op)
    _check_cuda("act_2d", x)
    y = torch.empty_like(x)
    if x.device.type == "meta":
        return y                         # the dry run: checked, not launched
    tab, half = CT.table_args(_TABLE_ROW.get(op), sched, cfg, x.device)
    rc = build.library("act").cordic_act_2d(
        x.data_ptr(), y.data_ptr(), x.numel(), _OP_CODE[op],
        build.DTYPE_CODE[x.dtype], build.params_ptr(sched, cfg, max_doublings),
        tab, half, build.stream_ptr(x))
    build.check(rc, "act_2d")
    build.count("act_2d")
    return y


@cost.booked("silu_mul_2d", lambda gate, up, sched=PAPER_SCHEDULE, cfg=PAPER_FIXED, **_:
             cost.silu_mul_2d_work(gate, sched, cfg))
def silu_mul_2d(gate: torch.Tensor, up: torch.Tensor, *,
                sched: MRSchedule = PAPER_SCHEDULE, cfg: FixedConfig = PAPER_FIXED,
                max_doublings: int = 3) -> torch.Tensor:
    """Fused ``up * silu(gate)`` over tensors of identical shape."""
    if gate.shape != up.shape:
        raise ValueError(f"silu_mul_2d: shapes differ {gate.shape} {up.shape}")
    if gate.device.type == "cpu" and up.device.type == "cpu":
        return silu_mul_2d_plain(gate, up, sched=sched, cfg=cfg,
                                 max_doublings=max_doublings)
    _check_cuda("silu_mul_2d", gate, up)
    y = torch.empty_like(gate)
    if gate.device.type == "meta":
        return y                         # the dry run: checked, not launched
    tab, half = CT.table_args(CT.TANH_ROW, sched, cfg, gate.device)
    rc = build.library("act").cordic_silu_mul_2d(
        gate.data_ptr(), up.data_ptr(), y.data_ptr(), gate.numel(),
        build.DTYPE_CODE[gate.dtype], build.params_ptr(sched, cfg, max_doublings),
        tab, half, build.stream_ptr(gate))
    build.check(rc, "silu_mul_2d")
    build.count("silu_mul_2d")
    return y


#: integer dtypes of act_q_2d -> dtype code of csrc/act.cu
_INT_CODE = {torch.int16: 0, torch.int32: 1}


@cost.booked("act_q_2d", lambda x_q, sched=PAPER_SCHEDULE, cfg=PAPER_FIXED, **_:
             cost.act_q_2d_work(x_q, sched, cfg))
def act_q_2d(x_q: torch.Tensor, *, sched: MRSchedule = PAPER_SCHEDULE,
             cfg: FixedConfig = PAPER_FIXED) -> torch.Tensor:
    """Integer (Q2.14 int16/int32 codes) sigmoid over the flat elements of a
    tensor of any shape; the result has the input's dtype. In a 16-bit
    format the kernel looks each code up in the sigmoid-code table
    (``code_tables.sigmoid_q_table``); wider formats run the pipeline."""
    if x_q.dtype not in _INT_CODE:
        raise TypeError(f"act_q_2d: dtype {x_q.dtype} not supported "
                        "(int16 or int32 codes)")
    if x_q.device.type == "cpu":
        return act_q_2d_plain(x_q, sched=sched, cfg=cfg)
    if not x_q.is_contiguous():
        raise ValueError("act_q_2d: input must be contiguous")
    y = torch.empty_like(x_q)
    if x_q.device.type == "meta":
        return y                         # the dry run: checked, not launched
    tab = (CT.sigmoid_q_table(sched, cfg, x_q.device).data_ptr()
           if CT.table_route(cfg) else None)
    rc = build.library("act").cordic_act_q_2d(
        x_q.data_ptr(), y.data_ptr(), x_q.numel(), _INT_CODE[x_q.dtype],
        build.params_ptr(sched, cfg), tab, build.stream_ptr(x_q))
    build.check(rc, "act_q_2d")
    build.count("act_q_2d")
    return y
