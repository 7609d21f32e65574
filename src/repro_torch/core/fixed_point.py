"""Bit-accurate fixed-point (Q-format) arithmetic on int32 torch lanes.

Port of ``repro.core.fixed_point``. The paper's datapath is a 16-bit
two's-complement pipeline; values are carried in int32 lanes and masked
back to ``total_bits`` after every arithmetic op, which makes the emulation
bit-exact with respect to a 16-bit register file, wraparound included.
Shifts are arithmetic with truncation (a two's-complement ``>>``) unless
``rounding="nearest"`` adds the half-ULP bias first.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class QFormat:
    """A signed two's-complement fixed-point format with `total_bits` storage
    and `frac_bits` fractional bits."""

    total_bits: int = 16
    frac_bits: int = 14

    @property
    def int_bits(self) -> int:  # excluding sign
        return self.total_bits - self.frac_bits - 1

    @property
    def scale(self) -> int:
        return 1 << self.frac_bits

    @property
    def min_int(self) -> int:
        return -(1 << (self.total_bits - 1))

    @property
    def max_int(self) -> int:
        return (1 << (self.total_bits - 1)) - 1

    @property
    def resolution(self) -> float:
        return 1.0 / self.scale

    def __str__(self) -> str:  # e.g. Q2.14
        return f"Q{self.int_bits + 1}.{self.frac_bits}"


#: The paper's 16-bit format.
Q2_14 = QFormat(total_bits=16, frac_bits=14)
#: Wider internal formats used for sensitivity studies.
Q2_20 = QFormat(total_bits=22, frac_bits=20)
Q2_29 = QFormat(total_bits=31, frac_bits=29)


#: Optional saturation observer: ``callable(fmt_str, clipped, total)``,
#: called by `quantize` with the count of codes that clip at the format
#: boundary. None (the default) costs one ``is None`` check.
_SAT_OBSERVER = None


def set_saturation_observer(observer):
    """Install (or clear, with None) the saturation observer; returns the
    previous one so scopes can nest."""
    global _SAT_OBSERVER
    prev = _SAT_OBSERVER
    _SAT_OBSERVER = observer
    return prev


def _note_saturation(scaled: torch.Tensor, fmt: QFormat) -> None:
    """Count boundary clips of a quantize. ``scaled`` is the rounded float
    code before the saturate, so values far outside int32 count exactly."""
    if _SAT_OBSERVER is None:
        return
    clipped = int(((scaled > fmt.max_int) | (scaled < fmt.min_int)).sum())
    _SAT_OBSERVER(str(fmt), clipped, int(scaled.numel()))


def wrap(v: torch.Tensor, fmt: QFormat) -> torch.Tensor:
    """Mask an int32 lane back to `fmt.total_bits` two's complement."""
    n = fmt.total_bits
    mask = (1 << n) - 1
    half = 1 << (n - 1)
    return ((v + half) & mask) - half


def sat(v: torch.Tensor, fmt: QFormat) -> torch.Tensor:
    """Saturate instead of wrapping (used at quantization boundaries)."""
    return v.clamp(fmt.min_int, fmt.max_int)


#: float bounds whose int32 conversion is defined (a saturating convert)
_I32_LO, _I32_HI = -2.0 ** 31, 2.0 ** 31 - 128.0


def quantize(x: torch.Tensor, fmt: QFormat = Q2_14,
             rounding: str = "nearest") -> torch.Tensor:
    """float -> fixed-point integer code (int32 lane), saturating. "nearest"
    rounds half to even."""
    scaled = x * float(fmt.scale)
    if rounding == "nearest":
        q = torch.round(scaled)
    elif rounding == "floor":
        q = torch.floor(scaled)
    else:
        raise ValueError(f"unknown rounding {rounding!r}")
    _note_saturation(q, fmt)
    # convert first, then saturate, as the reference does: a Q2.29 bound
    # is not a float32 value, so clamping in float would overshoot it
    qi = q.to(torch.float32).clamp(_I32_LO, _I32_HI).to(torch.int32)
    return sat(qi, fmt)


def dequantize(v: torch.Tensor, fmt: QFormat = Q2_14) -> torch.Tensor:
    """fixed-point integer code -> float32."""
    return v.to(torch.float32) * fmt.resolution


def const(x: float, fmt: QFormat = Q2_14) -> int:
    """Quantize a python scalar to an int32 constant (round half to even)."""
    q = int(np.round(x * fmt.scale))
    return max(fmt.min_int, min(fmt.max_int, q))


def add(a: torch.Tensor, b, fmt: QFormat = Q2_14) -> torch.Tensor:
    return wrap(a + b, fmt)


def sub(a: torch.Tensor, b, fmt: QFormat = Q2_14) -> torch.Tensor:
    return wrap(a - b, fmt)


def shr(v: torch.Tensor, s: int, fmt: QFormat = Q2_14,
        rounding: str = "trunc") -> torch.Tensor:
    """Arithmetic right shift by a static amount: "trunc" is a plain
    two's-complement ``>> s`` (floor); "nearest" adds the half-ULP bias."""
    if s == 0:
        return v
    if rounding == "nearest":
        v = v + (1 << (s - 1))
    return wrap(v >> s, fmt)


def shl(v: torch.Tensor, s: int, fmt: QFormat = Q2_14) -> torch.Tensor:
    """Left shift (wrapping, as hardware would)."""
    if s == 0:
        return v
    return wrap(v << s, fmt)


def requantize(v: torch.Tensor, src: QFormat, dst: QFormat,
               rounding: str = "trunc") -> torch.Tensor:
    """Convert between Q formats (shift of the binary point)."""
    ds = src.frac_bits - dst.frac_bits
    if ds >= 0:
        out = shr(v, ds, dst, rounding=rounding) if ds else v
    else:
        out = v << (-ds)
    return wrap(out, dst)
