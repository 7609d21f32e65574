"""Decode-path token choice (port of ``repro/serve/sampling.py``, greedy
part).

Greedy is argmax over the raw logits (first index on ties, as jnp.argmax).
Temperature / top-k sampling needs a bit-exact threefry ``fold_in`` and the
CORDIC temperature path, and raises until ROADMAP A.7.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling configuration.

    ``temperature`` — softmax temperature; <= 0 means greedy.
    ``top_k``       — keep the k highest logits (0 = full vocab).
    ``greedy``      — force argmax regardless of temperature.
    """

    temperature: float = 1.0
    top_k: int = 0
    greedy: bool = False

    def resolved(self) -> Tuple[float, int, bool]:
        """(temperature, top_k, greedy) with temperature<=0 folded into
        greedy and the temperature kept strictly positive for 1/T."""
        greedy = bool(self.greedy) or float(self.temperature) <= 0.0
        temp = 1.0 if greedy else float(self.temperature)
        return temp, int(self.top_k), greedy


def check_greedy(params: SamplingParams) -> None:
    if not params.resolved()[2]:
        raise NotImplementedError(
            "temperature / top-k sampling is not ported yet (ROADMAP A.7: "
            "threefry fold_in and the CORDIC temperature path); use greedy")


def greedy_tokens(logits: torch.Tensor) -> torch.Tensor:
    """(B, V) logits -> (B,) int32 argmax."""
    return torch.argmax(logits, dim=-1).to(torch.int32)
