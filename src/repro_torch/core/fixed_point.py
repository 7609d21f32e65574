"""Bit-accurate fixed-point (Q-format) arithmetic on int32 torch lanes.

The paper's datapath is a 16-bit two's-complement pipeline; values are
carried in int32 lanes and masked back to ``total_bits`` after every
arithmetic op, which makes the emulation bit-exact with respect to a 16-bit
register file, wraparound included. Port of the parts of
``repro.core.fixed_point`` the kernels need.
"""
from __future__ import annotations

import dataclasses

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


def wrap(v: torch.Tensor, fmt: QFormat) -> torch.Tensor:
    """Mask an int32 lane back to `fmt.total_bits` two's complement."""
    n = fmt.total_bits
    mask = (1 << n) - 1
    half = 1 << (n - 1)
    return ((v + half) & mask) - half


def quantize(x: torch.Tensor, fmt: QFormat = Q2_14) -> torch.Tensor:
    """float -> fixed-point integer code (int32 lane), round half to even,
    saturating."""
    q = torch.round(x.to(torch.float32) * float(fmt.scale))
    return q.clamp(fmt.min_int, fmt.max_int).to(torch.int32)


def dequantize(v: torch.Tensor, fmt: QFormat = Q2_14) -> torch.Tensor:
    """fixed-point integer code -> float32."""
    return v.to(torch.float32) * fmt.resolution
