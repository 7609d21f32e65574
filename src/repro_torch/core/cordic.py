"""The paper's sigmoid pipeline, specialized from the generalized CORDIC
engine (port of ``repro.core.cordic``):

    z = x/2  -->  [ MR-HRC: hyperbolic rotation, R2 j=2..9 + R4 j=4..7 ]
             -->  (cosh z, sinh z)
             -->  [ R2-LVC: linear vectoring, j=1..14 ]  -->  tanh z
             -->  sigmoid(x) = 1/2 + 1/2 * tanh z

Everything delegates to ``cordic_engine.core`` (the generic radix-2 /
radix-4 sweeps). The kernel stages of ``kernels/cordic_act.py`` are a
separate transcription of the same datapath; the golden vectors
(``tests/golden``) hold both.
"""
from __future__ import annotations

import torch

from repro_torch.core import fixed_point as fp
from repro_torch.cordic_engine import core as eng
from repro_torch.cordic_engine.core import FixedConfig, PAPER_FIXED  # noqa: F401
from repro_torch.cordic_engine.schedule import (  # noqa: F401
    HYPERBOLIC,
    LINEAR,
    ROTATION,
    VECTORING,
    MRSchedule,
    PAPER_SCHEDULE,
    R2_BASELINE_SCHEDULE,
    CordicSchedule,
)

#: SRT digit selection (float), under its historical name.
_r4_digit_f = eng._r4_digit_f


# --------------------------------------------------------------------------
# Float implementations (engine specializations)
# --------------------------------------------------------------------------
def r2_hrc_f(x, y, z, js) -> tuple:
    """Radix-2 hyperbolic rotation iterations (d = sign(z), never 0)."""
    return eng.radix2_sweep_f(x, y, z, js, HYPERBOLIC, ROTATION)


def r4_hrc_f(x, y, z, js) -> tuple:
    """Radix-4 hyperbolic rotation iterations, digit set {-2,-1,0,1,2}."""
    return eng.radix4_sweep_f(x, y, z, js)


def mr_hrc_f(z, sched: MRSchedule = PAPER_SCHEDULE) -> tuple:
    """Mixed-radix HRC: returns (cosh z, sinh z, residual angle)."""
    return eng.rotate_f(z, sched.rotation)


def r2_lvc_f(x, y, js) -> torch.Tensor:
    """Radix-2 linear vectoring: drives y -> 0, accumulating z -> y0/x0."""
    return eng.vector_f(x, y, CordicSchedule(LINEAR, tuple(js)))


def tanh_mr_f(z, sched: MRSchedule = PAPER_SCHEDULE) -> torch.Tensor:
    """tanh(z) for |z| <= 0.5 via MR-HRC + R2-LVC (float)."""
    c, s, _ = mr_hrc_f(z, sched)
    return r2_lvc_f(c, s, sched.lvc_js)


def sigmoid_mr_f(x, sched: MRSchedule = PAPER_SCHEDULE) -> torch.Tensor:
    """sigmoid(x) for |x| <= 1 via the paper pipeline (float)."""
    t = tanh_mr_f(x * 0.5, sched)
    return 0.5 + 0.5 * t


# --------------------------------------------------------------------------
# Fixed-point (bit-accurate) implementations
# --------------------------------------------------------------------------
def r2_hrc_q(x, y, z, sched: MRSchedule, cfg: FixedConfig):
    """Fixed-point radix-2 HRC. x/y in cfg.fmt, z in cfg.zfmt (int32 lanes)."""
    return eng.radix2_sweep_q(x, y, z, sched.r2_js, HYPERBOLIC, ROTATION, cfg)


def r4_hrc_q(x, y, z, sched: MRSchedule, cfg: FixedConfig):
    """Fixed-point radix-4 HRC with SRT digit selection."""
    return eng.radix4_sweep_q(x, y, z, sched.r4_js, HYPERBOLIC, ROTATION, cfg)


def mr_hrc_q(z_q, sched: MRSchedule = PAPER_SCHEDULE, cfg: FixedConfig = PAPER_FIXED):
    """Fixed-point MR-HRC of angle codes ``z_q`` (cfg.fmt). Returns
    (cosh_q, sinh_q, residual_q[z-format])."""
    return eng.rotate_q(z_q, sched.rotation, cfg)


def r2_lvc_q(x, y, sched: MRSchedule, cfg: FixedConfig):
    """Fixed-point linear vectoring. Result z in cfg.zfmt codes."""
    return eng.vector_q(x, y, sched.division, cfg)


def tanh_mr_q(z_q, sched: MRSchedule = PAPER_SCHEDULE, cfg: FixedConfig = PAPER_FIXED):
    """Fixed-point tanh(z) for |z| <= 0.5. In/out: cfg.fmt codes."""
    c, s, _ = mr_hrc_q(z_q, sched, cfg)
    t = r2_lvc_q(c, s, sched, cfg)
    if cfg.z_guard:      # z-format -> datapath format
        t = fp.shr(t, cfg.z_guard, cfg.fmt, rounding=cfg.out_round)
    return t


def sigmoid_mr_q(x_q, sched: MRSchedule = PAPER_SCHEDULE, cfg: FixedConfig = PAPER_FIXED):
    """Fixed-point sigmoid(x) for |x| <= 1. In/out: cfg.fmt codes.
    sigma = 1/2 + 1/2 * tanh(x/2): the halving and the output scale are
    single right-shifts, the offset one add of a constant."""
    z = fp.shr(x_q.to(torch.int32), 1, cfg.fmt, rounding=cfg.shift_round)
    t = tanh_mr_q(z, sched, cfg)
    half = 1 << (cfg.fmt.frac_bits - 1)                       # 0.5 in fmt
    t2 = fp.shr(t, 1, cfg.fmt, rounding=cfg.out_round)        # tanh/2
    return fp.add(t2, half, cfg.fmt)


# --------------------------------------------------------------------------
# Float-in/float-out fixed-point wrappers
# --------------------------------------------------------------------------
def sigmoid_fixed(x, sched: MRSchedule = PAPER_SCHEDULE, cfg: FixedConfig = PAPER_FIXED,
                  clamp: bool = True):
    """float -> Q2.14 -> MR-HRC sigmoid -> float. Domain |x| <= 1 (clamped)."""
    if clamp:
        x = x.clamp(-1.0, 1.0)
    yq = sigmoid_mr_q(fp.quantize(x, cfg.fmt), sched, cfg)
    return fp.dequantize(yq, cfg.fmt).to(x.dtype)


def tanh_fixed(z, sched: MRSchedule = PAPER_SCHEDULE, cfg: FixedConfig = PAPER_FIXED,
               clamp: bool = True):
    """float -> Q2.14 -> MR-HRC tanh -> float. Domain |z| <= 0.5 (clamped)."""
    if clamp:
        z = z.clamp(-0.5, 0.5)
    tq = tanh_mr_q(fp.quantize(z, cfg.fmt), sched, cfg)
    return fp.dequantize(tq, cfg.fmt).to(z.dtype)


# --------------------------------------------------------------------------
# Introspection helpers (tests & benchmarks)
# --------------------------------------------------------------------------
def r2_residual_f(z, sched: MRSchedule = PAPER_SCHEDULE):
    """|residual angle| after the radix-2 stage only (float)."""
    x = torch.full_like(z, sched.x0)
    y = torch.zeros_like(z)
    _, _, zr = r2_hrc_f(x, y, z, sched.r2_js)
    return zr.abs()


def shift_add_op_count(sched: MRSchedule = PAPER_SCHEDULE) -> dict:
    """Static resource model: adds/shifts/compares per evaluation (Table-1
    analog): 3 adders and 2 fixed shifts per R2-HRC stage, the 5-way digit
    mux (2 compares) on R4-HRC, 2 adders + 1 shift per LVC stage, one add +
    two shifts at the output, one shift at the input."""
    n_r2, n_r4, n_lvc = len(sched.r2_js), len(sched.r4_js), len(sched.lvc_js)
    adds = 3 * n_r2 + 3 * n_r4 + 2 * n_lvc + 1
    shifts = 2 * n_r2 + 2 * n_r4 + 1 * n_lvc + 3
    compares = 1 * n_r2 + 4 * n_r4 + 1 * n_lvc
    rom_bits = (n_r2 + 2 * n_r4) * 16
    return dict(adds=adds, shifts=shifts, compares=compares,
                rom_bits=rom_bits, iterations=sched.num_iterations(),
                multipliers=0, dividers=0, dsp=0)
