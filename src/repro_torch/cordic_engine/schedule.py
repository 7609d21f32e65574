"""Iteration schedules for the generalized mixed-radix CORDIC engine.

Two schedule types live here:

* ``MRSchedule`` — the paper's bundled pipeline schedule (radix-2 HRC +
  radix-4 HRC rotation stages followed by the R2-LVC division stage). It is
  the historical type every paper-facing module imports from
  ``repro.core.cordic``; that module now just re-exports it from here.
* ``CordicSchedule`` — the generalization: one *single-stage* schedule for a
  mode-parameterized CORDIC sweep (``mode`` in {circular, linear,
  hyperbolic}), with a radix-2 iteration list (repeats allowed — the
  textbook hyperbolic j=4/j=13 repetitions are just repeated entries) and an
  optional radix-4 tail (hyperbolic rotation only, the paper's trick).

The per-iteration "angle" is mode-dependent:

    circular    alpha_j = atan(2^-j)       gain_j = sqrt(1 + 2^-2j)
    linear      alpha_j = 2^-j             gain_j = 1
    hyperbolic  alpha_j = atanh(2^-j)      gain_j = sqrt(1 - 2^-2j)

Convergence ranges are the usual sums of the remaining angles; the
properties below compute them so callers can assert domain contracts.
"""
from __future__ import annotations

import dataclasses
import math

CIRCULAR = "circular"
LINEAR = "linear"
HYPERBOLIC = "hyperbolic"
MODES = (CIRCULAR, LINEAR, HYPERBOLIC)

ROTATION = "rotation"
VECTORING = "vectoring"
DIRECTIONS = (ROTATION, VECTORING)


def angle_r2(mode: str, j: int) -> float:
    """The elementary rotation angle alpha_j for a radix-2 iteration."""
    if mode == CIRCULAR:
        return math.atan(2.0 ** (-j))
    if mode == LINEAR:
        return 2.0 ** (-j)
    if mode == HYPERBOLIC:
        return math.atanh(2.0 ** (-j))
    raise ValueError(f"unknown mode {mode!r}")


def angle_r4(mode: str, j: int, mag: int) -> float:
    """Radix-4 angle for digit magnitude `mag` in {1, 2} (hyperbolic only)."""
    if mode != HYPERBOLIC:
        raise NotImplementedError("radix-4 stages are hyperbolic-only")
    return math.atanh(mag * 4.0 ** (-j))


# --------------------------------------------------------------------------
# The generalized single-stage schedule
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class CordicSchedule:
    """One CORDIC sweep: mode + radix-2 iterations (+ optional radix-4 tail).

    ``r2_js`` may contain repeated indices (hyperbolic convergence repeats).
    ``r4_js`` is only legal for hyperbolic mode (SRT digit set {-2..2}).
    """

    mode: str
    r2_js: tuple
    r4_js: tuple = ()

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"mode {self.mode!r} not in {MODES}")
        if self.r4_js and self.mode != HYPERBOLIC:
            raise ValueError("radix-4 stages require hyperbolic mode")

    @property
    def gain(self) -> float:
        """Cumulative radix-2 stage gain K (radix-4 tail is scale-free)."""
        p = 1.0
        for j in self.r2_js:
            if self.mode == CIRCULAR:
                p *= math.sqrt(1.0 + 2.0 ** (-2 * j))
            elif self.mode == HYPERBOLIC:
                p *= math.sqrt(1.0 - 2.0 ** (-2 * j))
        return p

    @property
    def x0(self) -> float:
        """Initial x that folds the gain away (rotation-mode unit start)."""
        return 1.0 / self.gain

    @property
    def angle_range(self) -> float:
        """Max convergent |z0| (rotation) / |y0/x0| accumulation (vectoring)."""
        r = sum(angle_r2(self.mode, j) for j in self.r2_js)
        r += sum(angle_r4(self.mode, j, 2) for j in self.r4_js)
        return r

    @property
    def resolution(self) -> float:
        """Smallest elementary angle — the terminal residual scale."""
        last = min(angle_r2(self.mode, j) for j in self.r2_js)
        if self.r4_js:
            last = min(last, angle_r4(self.mode, max(self.r4_js), 1))
        return last

    def num_iterations(self) -> int:
        return len(self.r2_js) + len(self.r4_js)


def _hyp_vectoring_js(first: int = 1, last: int = 14) -> tuple:
    """Textbook hyperbolic schedule with the convergence repeats (4, 13, 40…)."""
    js = []
    for j in range(first, last + 1):
        js.append(j)
        if j in (4, 13, 40):
            js.append(j)
    return tuple(js)


#: Paper rotation schedule: R2-HRC j=2..9 then R4-HRC j=4..7 (gap-free by SRT).
HYP_ROTATION = CordicSchedule(HYPERBOLIC, tuple(range(2, 10)), tuple(range(4, 8)))
#: Hyperbolic vectoring for atanh/log: j=1..14 with repeats at 4 and 13.
HYP_VECTORING = CordicSchedule(HYPERBOLIC, _hyp_vectoring_js())
#: Linear vectoring (division) to 2^-14: j=1..14 (the paper's R2-LVC).
LIN_VECTORING = CordicSchedule(LINEAR, tuple(range(1, 15)))
#: Linear rotation (multiplication): the SAME stage list as the R2-LVC
#: divide, run in rotation direction so y accumulates x * z0 for
#: |z0| < sum 2^-j. Aliased, not copied — tuning the linear stage list can
#: never split the divide and multiply datapaths.
LIN_ROTATION = LIN_VECTORING
#: Circular rotation for sin/cos: j=0..13, range sum atan(2^-j) ~ 1.743 > pi/4.
CIRC_ROTATION = CordicSchedule(CIRCULAR, tuple(range(0, 14)))


# --------------------------------------------------------------------------
# Format-sized schedules (Q2.20 / Q2.29 accuracy studies)
# --------------------------------------------------------------------------
def hyp_rotation_for(frac_bits: int) -> CordicSchedule:
    """Paper-style mixed-radix rotation sized to a frac_bits datapath:
    the fixed R2 prologue j=2..9 (residual ~6.1e-3, inside the R4 admissible
    range) and an R4 tail extended until the smallest elementary angle
    reaches the format resolution (j up to ceil(frac_bits/2))."""
    return CordicSchedule(HYPERBOLIC, tuple(range(2, 10)),
                          tuple(range(4, (frac_bits + 1) // 2 + 1)))


def hyp_vectoring_for(frac_bits: int) -> CordicSchedule:
    """Hyperbolic vectoring j=1..frac_bits with the textbook repeats."""
    return CordicSchedule(HYPERBOLIC, _hyp_vectoring_js(1, frac_bits))


def lin_vectoring_for(frac_bits: int) -> CordicSchedule:
    """Linear vectoring to 2^-frac_bits (one digit per fraction bit)."""
    return CordicSchedule(LINEAR, tuple(range(1, frac_bits + 1)))


#: Linear rotation (multiply) sizing: same stages as the divide, by design.
lin_rotation_for = lin_vectoring_for


def mr_schedule_for(frac_bits: int) -> MRSchedule:
    """The bundled sigmoid/tanh pipeline schedule sized to frac_bits."""
    return MRSchedule(r2_js=tuple(range(2, 10)),
                      r4_js=tuple(range(4, (frac_bits + 1) // 2 + 1)),
                      lvc_js=tuple(range(1, frac_bits + 1)))


# --------------------------------------------------------------------------
# The paper's bundled pipeline schedule (moved verbatim from core/cordic.py)
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class MRSchedule:
    """Iteration schedule for the MR-HRC + R2-LVC pipeline.

    The defaults are exactly the paper's: radix-2 j=2..9, radix-4 j=4..7,
    and (the paper leaves LVC unspecified) LVC j=1..14 for a 16-bit result.
    """

    r2_js: tuple = tuple(range(2, 10))
    r4_js: tuple = tuple(range(4, 8))
    lvc_js: tuple = tuple(range(1, 15))

    @property
    def r2_gain(self) -> float:
        """K_h — the constant radix-2 stage gain, folded into x0 = 1/K_h."""
        p = 1.0
        for j in self.r2_js:
            p *= math.sqrt(1.0 - 2.0 ** (-2 * j))
        return p

    @property
    def x0(self) -> float:
        return 1.0 / self.r2_gain

    @property
    def r2_range(self) -> float:
        """Convergence range of the radix-2 stage (paper eq. (5))."""
        return sum(math.atanh(2.0 ** (-j)) for j in self.r2_js)

    @property
    def r4_range(self) -> float:
        """Admissible input range of the radix-4 stage (paper eq. (6))."""
        return sum(math.atanh(2.0 * 4.0 ** (-j)) for j in self.r4_js)

    @property
    def r4_gain_bounds(self) -> tuple:
        """(min, max) cumulative radix-4 gain over all digit sequences."""
        lo = 1.0
        for j in self.r4_js:
            lo *= math.sqrt(1.0 - 4.0 * 4.0 ** (-2 * j))
        return lo, 1.0

    def num_iterations(self) -> int:
        return len(self.r2_js) + len(self.r4_js) + len(self.lvc_js)

    # ---- bridges into the generalized engine ------------------------------
    @property
    def rotation(self) -> CordicSchedule:
        """The hyperbolic-rotation half as a generalized schedule."""
        return CordicSchedule(HYPERBOLIC, self.r2_js, self.r4_js)

    @property
    def division(self) -> CordicSchedule:
        """The linear-vectoring half as a generalized schedule."""
        return CordicSchedule(LINEAR, self.lvc_js)


PAPER_SCHEDULE = MRSchedule()

#: Pure radix-2 baseline ("conventional R2-HRC"): same accuracy floor needs
#: j=2..14 *with* the textbook repetition of j=4 and j=13 for gap-free
#: convergence (repeats make the per-step convergence inequality hold).
R2_BASELINE_SCHEDULE = MRSchedule(
    r2_js=(2, 3, 4, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 13, 14),
    r4_js=(),
    lvc_js=tuple(range(1, 15)),
)
