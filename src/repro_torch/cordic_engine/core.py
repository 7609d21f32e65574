"""Datapath quantization config of the CORDIC engine (the part of
``repro.cordic_engine.core`` the kernels need: ``FixedConfig`` and
``PAPER_FIXED``). The generic float/fixed sweeps come with ROADMAP A.2.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.fixed_point import Q2_14, QFormat


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
