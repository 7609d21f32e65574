"""Quantized paged-KV formats: per-block scaled fixed-point storage with a
CORDIC linear-rotation dequant (port of ``repro.core.kv_quant``).

``cfg.kv_quant`` selects the storage format of the K/V block pools:

    "none"  full-width pools
    "int8"  Q8.0 codes in int8 lanes: 4x fewer pool bytes than float32
    "q2_14" the paper's 16-bit Q2.14 format in int16 lanes: 2x fewer

Every pool block carries one float32 scale per kv head (shape
``(num_blocks, 1, KH, 1)``, broadcastable against the ``(num_blocks,
block_len, KH, hd)`` code pool), chosen from the block's per-head amax, so
an in-range write never clips; ``fixed_point.quantize`` feeds the
saturation observer when an explicitly chosen scale does clip.

Dequantization is the CORDIC linear-rotation multiply
(``functions.multiply_float``): code * resolution gives the block-relative
value, and the scale multiply runs as a frexp-reduced shift-add sweep. It
is elementwise and deterministic, so the gather attend, the decode kernel
(``csrc/paged_decode.cu``) and its plain version dequantize to the same
floats.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core import fixed_point as fp
from repro_torch.cordic_engine import functions as F

#: cfg.kv_quant values the engine accepts.
KV_QUANT_IMPLS = ("none", "int8", "q2_14")

#: int8 KV codes: 1 sign bit + 7 integer bits, no fraction; the scale
#: carries the dynamic range (prints as "Q8.0" in saturation metrics).
INT8 = fp.QFormat(total_bits=8, frac_bits=0)

#: positive floor of amax-derived scales (float32 tiny): an all-zero block
#: quantizes to zero codes instead of dividing by zero.
_TINY = torch.finfo(torch.float32).tiny


@dataclasses.dataclass(frozen=True)
class KVQuantSpec:
    """One quantized-KV storage format: the Q format of the codes and the
    integer lane dtype the pool stores them in."""

    name: str
    fmt: fp.QFormat
    code_dtype: torch.dtype

    @property
    def fmt_max(self) -> float:
        """Largest representable magnitude (max code in value units);
        amax-derived scales map a block's amax here."""
        return self.fmt.max_int * self.fmt.resolution

    @property
    def code_bits(self) -> int:
        """Storage bits per pool element (the lane width)."""
        return torch.iinfo(self.code_dtype).bits


_SPECS = {
    "int8": KVQuantSpec("int8", INT8, torch.int8),
    "q2_14": KVQuantSpec("q2_14", fp.Q2_14, torch.int16),
}


def spec_for(name: Optional[str]) -> Optional[KVQuantSpec]:
    """The KVQuantSpec of a cfg.kv_quant value; None for "none"/None.
    Unknown names raise."""
    if name is None or name == "none":
        return None
    spec = _SPECS.get(name)
    if spec is None:
        raise ValueError(f"unknown kv_quant {name!r}; expected one of "
                         f"{KV_QUANT_IMPLS}")
    return spec


def scale_for_amax(amax: torch.Tensor, spec: KVQuantSpec) -> torch.Tensor:
    """amax -> float32 scale mapping the amax onto the format's max code,
    floored at float32 tiny. The reference divides by the constant
    ``fmt_max``; jitted XLA rewrites that division as a product with its
    float32 reciprocal, which rounds differently, and the port follows the
    jitted form."""
    inv = float(torch.tensor(1.0 / spec.fmt_max, dtype=torch.float32))
    return torch.clamp_min(amax.to(torch.float32) * inv, _TINY)


def block_scale(x: torch.Tensor, spec: KVQuantSpec) -> torch.Tensor:
    """Per-block-per-head scale of ``(..., L, KH, hd)`` blocks: the amax over
    the position and feature axes, head axis kept; ``(..., 1, KH, 1)``
    float32."""
    amax = x.to(torch.float32).abs().amax(dim=(-3, -1), keepdim=True)
    return scale_for_amax(amax, spec)


def quantize(x: torch.Tensor, spec: KVQuantSpec, scale: torch.Tensor) -> torch.Tensor:
    """float K/V -> integer codes in the spec's lane dtype, through
    ``fixed_point.quantize`` (round half to even, saturating, observed)."""
    return fp.quantize(x / scale, spec.fmt).to(spec.code_dtype)


def dequantize(codes: torch.Tensor, spec: KVQuantSpec,
               scale: torch.Tensor) -> torch.Tensor:
    """Integer codes and their scale -> float32, the scale multiply on the
    CORDIC linear-rotation datapath."""
    return F.multiply_float(fp.dequantize(codes, spec.fmt),
                            torch.as_tensor(scale, dtype=torch.float32))
