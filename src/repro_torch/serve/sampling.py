"""Decode-path token sampling on the CORDIC datapath (port of
``repro/serve/sampling.py``).

Temperature scaling rides the shift-add engine, as in the JAX sampler:
1/T is the R2-LVC linear-vectoring divide (``functions.reciprocal_fixed``)
and logits/T the linear-rotation multiply (``functions.multiply_fixed``);
``impl="exact"`` keeps the float division as an oracle.

A sampled row draws ``argmax(top_k(logits/T) + gumbel)`` with its own
Threefry key (serve/prng.py), which is ``jax.random.categorical``'s draw
bit for bit; a greedy row takes argmax of the raw logits (the first index
on ties, as ``jnp.argmax``). A row's token depends only on its own logits,
key and knobs, never on the rest of the batch. ``temperature <= 0``
resolves to greedy.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch.cordic_engine import functions as F
from repro_torch.serve import prng

NEG_INF = -1e30


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


def greedy_tokens(logits: torch.Tensor) -> torch.Tensor:
    """(B, V) logits -> (B,) int32 argmax."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def scale_by_temperature(logits: torch.Tensor, temperature: torch.Tensor,
                         impl: str = "cordic") -> torch.Tensor:
    """logits (B, V) / T (B,) through the CORDIC engine: 1/T from the
    R2-LVC divide, then the linear-rotation multiply."""
    t = temperature.to(logits.device, torch.float32)[:, None]
    if impl == "exact":
        return logits / t
    return F.multiply_fixed(logits, F.reciprocal_fixed(t))


def top_k_mask(logits: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """All but the k (B,) largest entries of each row set to NEG_INF; the
    threshold is the k-th largest value of the sorted row, so ties at it
    all survive; k <= 0 keeps the whole row."""
    v = logits.shape[-1]
    kk = torch.where(k > 0, k, torch.full_like(k, v)).clamp(1, v).to(torch.int64)
    thr = torch.sort(logits, dim=-1).values.gather(-1, (v - kk)[:, None])
    return torch.where(logits >= thr, logits, torch.full_like(logits, NEG_INF))


def sample_batched(logits: torch.Tensor, keys: torch.Tensor,
                   temperatures: torch.Tensor, top_ks: torch.Tensor,
                   greedy: torch.Tensor, impl: str = "cordic") -> torch.Tensor:
    """(B, V) float32 logits + per-row keys (B, 2), temperatures (B,),
    top_ks (B,), greedy (B,) bool -> (B,) int32 tokens: greedy rows argmax
    the raw logits, the others draw from categorical(top_k(logits / T))."""
    dev = logits.device
    keys, temperatures, top_ks, greedy = (
        t.to(dev) for t in (keys, temperatures, top_ks, greedy))
    scaled = top_k_mask(scale_by_temperature(logits, temperatures, impl), top_ks)
    noise = prng.gumbel(keys, logits.shape[-1:])
    drawn = torch.argmax(noise + scaled, dim=-1)
    return torch.where(greedy, torch.argmax(logits, dim=-1), drawn).to(torch.int32)


def sample_one(logits: torch.Tensor, key: torch.Tensor, temperature: float,
               top_k: int, greedy: bool, impl: str = "cordic") -> int:
    """One row: (V,) logits -> token id (``sample_batched`` of one row)."""
    return int(sample_batched(
        logits[None], key[None], torch.tensor([temperature]),
        torch.tensor([top_k]), torch.tensor([greedy]), impl)[0])


def request_key(base_key: torch.Tensor, rid, step) -> torch.Tensor:
    """The key of token ``step`` of request ``rid``:
    fold_in(fold_in(base, rid), step), so a request's stream does not
    depend on its slot or its batch (step 0 is the prefill's token).
    ``rid`` and ``step`` may be (B,) tensors: then (B, 2) keys."""
    rid = torch.as_tensor(rid, dtype=torch.int64, device=base_key.device)
    step = torch.as_tensor(step, dtype=torch.int64, device=base_key.device)
    return prng.fold_in(prng.fold_in(base_key.expand(rid.shape + (2,)), rid), step)
