"""Mode-parameterized CORDIC core (port of ``repro.cordic_engine.core``):
one iteration engine for all six (mode x direction) combinations, in float
and in bit-accurate fixed point.

The unified iteration (direction factor e, mode factor m_x):

    x' = x + m_x * e * y * 2^-j        m_x = -1 circular, 0 linear, +1 hyperbolic
    y' = y +       e * x * 2^-j
    z' = z -       e * alpha_j(mode)

    rotation:   e = sign(z)   (drive z -> 0; rotates (x, y) by z0)
    vectoring:  e = -sign(y)  (drive y -> 0; accumulates z += f(y0/x0))

The fixed-point sweeps carry values in int32 lanes masked to ``cfg.fmt``
after every op (``repro_torch.core.fixed_point``); the z/angle register may
be widened by ``cfg.z_guard`` fraction bits. The float sweeps run in the
input's dtype; in bfloat16 every op rounds and the angle constants are
bfloat16 values, as in the reference.
"""
from __future__ import annotations

import dataclasses
from functools import lru_cache

import torch

from repro_torch.core import fixed_point as fp
from repro_torch.core.fixed_point import Q2_14, QFormat
from repro_torch.core.numerics import weak
from repro_torch.cordic_engine.schedule import (
    CIRCULAR,
    HYPERBOLIC,
    LINEAR,
    ROTATION,
    VECTORING,
    CordicSchedule,
    angle_r2,
    angle_r4,
)


@dataclasses.dataclass(frozen=True)
class FixedConfig:
    """Datapath quantization config.

    ``fmt``        — x/y register format (the paper's 16-bit Q2.14).
    ``z_guard``    — extra fraction bits on the z (angle) register. 0 keeps
                     the strict 16-bit paper datapath.
    ``shift_round``— rounding of datapath right-shifts ("trunc" is a plain
                     two's-complement ``>>``).
    ``out_round``  — rounding of the final output requantization.
    """

    fmt: QFormat = Q2_14
    z_guard: int = 0
    shift_round: str = "trunc"
    out_round: str = "nearest"

    @property
    def zfmt(self) -> QFormat:
        if self.z_guard == 0:
            return self.fmt
        return QFormat(
            total_bits=self.fmt.total_bits + self.z_guard,
            frac_bits=self.fmt.frac_bits + self.z_guard,
        )


PAPER_FIXED = FixedConfig()


# --------------------------------------------------------------------------
# Float sweeps
# --------------------------------------------------------------------------
def _sign_e(cond: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """+1 where cond, else -1, in like's dtype."""
    one = torch.ones_like(like)
    return torch.where(cond, one, -one)


def radix2_sweep_f(x, y, z, js, mode: str, direction: str):
    """Generic radix-2 CORDIC iterations in float. Returns (x, y, z)."""
    for j in js:
        a = weak(angle_r2(mode, j), z)
        f = 2.0 ** (-j)
        e = _sign_e(z >= 0, y) if direction == ROTATION else _sign_e(y < 0, y)
        if mode == HYPERBOLIC:
            x_n = x + e * y * f
        elif mode == CIRCULAR:
            x_n = x - e * y * f
        else:
            x_n = x
        x, y, z = x_n, y + e * x * f, z - e * a
    return x, y, z


def _r4_digit_f(z, j):
    """SRT-style radix-4 digit selection on w = 4^j z (paper eq. (8))."""
    w = z * (4.0 ** j)
    d = torch.where(w >= 1.5, 2.0, torch.where(w >= 0.5, 1.0, torch.where(
        w >= -0.5, 0.0, torch.where(w >= -1.5, -1.0, -2.0))))
    return d.to(z.dtype)


def radix4_sweep_f(x, y, z, js, mode: str = HYPERBOLIC, direction: str = ROTATION):
    """Radix-4 hyperbolic rotation iterations, digit set {-2,-1,0,1,2}."""
    if mode != HYPERBOLIC or direction != ROTATION:
        raise NotImplementedError("radix-4 sweep: hyperbolic rotation only")
    for j in js:
        s = _r4_digit_f(z, j)
        mag = s.abs()
        # the reference selects the angle among float32 constants, then
        # casts to z's dtype (two roundings in bfloat16)
        a2 = float(torch.tensor(angle_r4(mode, j, 2), dtype=torch.float32))
        a1 = float(torch.tensor(angle_r4(mode, j, 1), dtype=torch.float32))
        sel = torch.where(mag == 2.0, a2, torch.where(mag == 1.0, a1, 0.0))
        a = torch.sign(s) * sel.to(torch.float32).to(z.dtype)
        f = s * (4.0 ** (-j))
        x, y, z = x + f * y, y + f * x, z - a
    return x, y, z


def sweep_f(x, y, z, sched: CordicSchedule, direction: str):
    """Full float sweep: radix-2 stage then (hyperbolic-only) radix-4 tail."""
    x, y, z = radix2_sweep_f(x, y, z, sched.r2_js, sched.mode, direction)
    if sched.r4_js:
        x, y, z = radix4_sweep_f(x, y, z, sched.r4_js, sched.mode, direction)
    return x, y, z


# --------------------------------------------------------------------------
# Fixed-point sweeps
# --------------------------------------------------------------------------
@lru_cache(maxsize=None)
def _q_angles_r2(mode: str, js: tuple, zfmt: QFormat):
    """Pre-quantized radix-2 angle ROM in the z format. Linear mode uses
    the exact power-of-two step (``1 << (frac - j)``, floored at 1)."""
    if mode == LINEAR:
        return tuple(1 << max(zfmt.frac_bits - j, 0) for j in js)
    return tuple(fp.const(angle_r2(mode, j), zfmt) for j in js)


@lru_cache(maxsize=None)
def _q_r4_consts(mode: str, js: tuple, zfmt: QFormat):
    """Radix-4 ROM: atanh tables + SRT digit-selection thresholds."""
    a1 = tuple(fp.const(angle_r4(mode, j, 1), zfmt) for j in js)
    a2 = tuple(fp.const(angle_r4(mode, j, 2), zfmt) for j in js)
    thr05 = tuple(fp.const(0.5 * 4.0 ** (-j), zfmt) for j in js)
    thr15 = tuple(fp.const(1.5 * 4.0 ** (-j), zfmt) for j in js)
    return a1, a2, thr05, thr15


def radix2_sweep_q(x, y, z, js, mode: str, direction: str, cfg: FixedConfig):
    """Generic radix-2 fixed-point sweep. x/y in cfg.fmt, z in cfg.zfmt."""
    f, zf, rnd = cfg.fmt, cfg.zfmt, cfg.shift_round
    angles = _q_angles_r2(mode, tuple(js), zf)
    for i, j in enumerate(js):
        a = angles[i]
        # `plus` selects the e = +1 branch of the unified iteration
        plus = (z >= 0) if direction == ROTATION else (y < 0)
        xs = fp.shr(x, j, f, rounding=rnd)
        if mode != LINEAR:
            ys = fp.shr(y, j, f, rounding=rnd)
            if mode == HYPERBOLIC:
                x_n = torch.where(plus, fp.add(x, ys, f), fp.sub(x, ys, f))
            else:
                x_n = torch.where(plus, fp.sub(x, ys, f), fp.add(x, ys, f))
        else:
            x_n = x
        y_n = torch.where(plus, fp.add(y, xs, f), fp.sub(y, xs, f))
        z = torch.where(plus, fp.sub(z, a, zf), fp.add(z, a, zf))
        x, y = x_n, y_n
    return x, y, z


def radix4_sweep_q(x, y, z, js, mode: str, direction: str, cfg: FixedConfig):
    """Fixed-point radix-4 hyperbolic rotation with SRT digit selection; the
    digit compare is done on z against pre-scaled thresholds (0.5*4^-j,
    1.5*4^-j), with no left shift that could overflow the register."""
    if mode != HYPERBOLIC or direction != ROTATION:
        raise NotImplementedError("radix-4 sweep: hyperbolic rotation only")
    f, zf, rnd = cfg.fmt, cfg.zfmt, cfg.shift_round
    a1s, a2s, t05s, t15s = _q_r4_consts(mode, tuple(js), zf)
    for i, j in enumerate(js):
        t05, t15 = t05s[i], t15s[i]
        mag2 = (z >= t15) | (z < -t15)                    # |sigma| == 2
        mag0 = (z < t05) & (z >= -t05)                    # sigma == 0
        pos = z >= 0
        xs1 = fp.shr(x, 2 * j, f, rounding=rnd)
        ys1 = fp.shr(y, 2 * j, f, rounding=rnd)
        xs2 = fp.shr(x, 2 * j - 1, f, rounding=rnd)
        ys2 = fp.shr(y, 2 * j - 1, f, rounding=rnd)
        zero = torch.zeros_like(x)
        dx = torch.where(mag0, zero, torch.where(mag2, ys2, ys1))
        dy = torch.where(mag0, zero, torch.where(mag2, xs2, xs1))
        da = torch.where(mag0, zero,
                         torch.where(mag2, a2s[i], a1s[i]).to(torch.int32))
        x = torch.where(pos, fp.add(x, dx, f), fp.sub(x, dx, f))
        y = torch.where(pos, fp.add(y, dy, f), fp.sub(y, dy, f))
        z = torch.where(pos, fp.sub(z, da, zf), fp.add(z, da, zf))
    return x, y, z


def sweep_q(x, y, z, sched: CordicSchedule, direction: str, cfg: FixedConfig):
    """Full fixed-point sweep: radix-2 then (hyperbolic-only) radix-4 tail."""
    x, y, z = radix2_sweep_q(x, y, z, sched.r2_js, sched.mode, direction, cfg)
    if sched.r4_js:
        x, y, z = radix4_sweep_q(x, y, z, sched.r4_js, sched.mode, direction, cfg)
    return x, y, z


# --------------------------------------------------------------------------
# Canonical entry points (unit starts, guard-bit handling)
# --------------------------------------------------------------------------
def rotate_q(z_q, sched: CordicSchedule, cfg: FixedConfig = PAPER_FIXED):
    """Rotation from the gain-folded unit start x0 = 1/K, y0 = 0. ``z_q`` is
    the angle in cfg.fmt codes. Returns (x, y, residual z), x/y in cfg.fmt
    codes and z in cfg.zfmt codes: (cosh z, sinh z) hyperbolic, (cos z,
    sin z) circular."""
    z_q = z_q.to(torch.int32)
    x = torch.full_like(z_q, fp.const(sched.x0, cfg.fmt))
    y = torch.zeros_like(z_q)
    z = z_q << cfg.z_guard if cfg.z_guard else z_q   # extend angle register
    return sweep_q(x, y, z, sched, ROTATION, cfg)


def vector_q(x_q, y_q, sched: CordicSchedule, cfg: FixedConfig = PAPER_FIXED):
    """Vectoring from (x_q, y_q): drives y -> 0 and returns the z
    accumulator in cfg.zfmt codes (linear: y0/x0; hyperbolic:
    atanh(y0/x0))."""
    x_q, y_q = torch.broadcast_tensors(x_q.to(torch.int32), y_q.to(torch.int32))
    z = torch.zeros_like(y_q)
    _, _, z = sweep_q(x_q, y_q, z, sched, VECTORING, cfg)
    return z


def rotate_f(z, sched: CordicSchedule):
    """Float rotation from the unit start. Returns (x, y, residual)."""
    x = torch.full_like(z, sched.x0)
    y = torch.zeros_like(z)
    return sweep_f(x, y, z, sched, ROTATION)


def vector_f(x, y, sched: CordicSchedule):
    """Float vectoring: returns the accumulated z (y driven to 0)."""
    x, y = torch.broadcast_tensors(x, y)
    z = torch.zeros_like(y)
    _, _, z = sweep_f(x, y, z, sched, VECTORING)
    return z
