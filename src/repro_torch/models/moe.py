"""Mixture-of-Experts FFN (port of ``repro/models/moe.py``): GShard-style
one-hot dispatch and combine with a per-group capacity factor.

The formulation defines the numbers and is kept exactly: tokens dispatch in
per-sequence groups (G = batch rows), each expert queue holds
``C = max(ceil(S * K * capacity_factor / E), 4)`` tokens per group (S: the
dispatch width, the bucket width at prefill, 1 at decode), queue positions
come from a cumsum over the flattened (S*K) axis, s-major and k-minor, and
tokens past C are dropped. Dispatch and combine tensors are one-hots in
``x.dtype`` with the gate values cast to it; the expert einsums run over
(G, E, C, d), so every expert's weights are read at every apply (at decode
too). Those einsums are plain matrix products (``torch.einsum``), as the
JAX package leaves them to XLA.

Router scores: ``"softmax"`` (float32, exp(x - max) / sum) or ``"sigmoid"``
(the registry's ``sigmoid`` of ``cfg.act_impl``, range "reduce", then
normalised). Top-k keeps the lower expert index first on equal scores, as
``jax.lax.top_k`` does (a stable descending sort). The expert SiLU is the
registry's ``silu`` of ``cfg.act_impl``: for ``cordic_pallas`` that is ``x *
sigmoid_wide(x)`` through ``act_2d`` with sigma rounded to ``x.dtype``
before the product, neither the fused ``silu_mul_2d`` nor ``act_2d``'s
``silu`` op, which round differently in bfloat16.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
from torch import nn

from repro_torch.core.activations import get_activation
from repro_torch.models import mlp as mlpm


class MoE(nn.Module):
    """router (d, E), w_gate/w_up (E, d, f), w_down (E, f, d) and, with
    shared experts, ``shared``: a SwiGLU of width d_ff_expert *
    num_shared_experts (the JAX ``moe_spec``)."""

    def __init__(self, cfg, *, dtype, device, gen=None):
        super().__init__()
        m, d = cfg.moe, cfg.d_model
        E, f = m.num_experts, m.d_ff_expert
        self.router = mlpm.leaf((d, E), gen, dtype, device, 0.02)
        self.w_gate = mlpm.leaf((E, d, f), gen, dtype, device)
        self.w_up = mlpm.leaf((E, d, f), gen, dtype, device)
        self.w_down = mlpm.leaf((E, f, d), gen, dtype, device)
        self.shared = (mlpm.SwiGLU(d, f * m.num_shared_experts, dtype=dtype,
                                   device=device, gen=gen)
                       if m.num_shared_experts else None)


def router_scores(p: MoE, x: torch.Tensor, cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (T, d) -> (scores (T, E) float32, logits (T, E) float32)."""
    m = cfg.moe
    logits = x.to(torch.float32) @ p.router.to(torch.float32)
    if m.router_score == "softmax":
        e = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
        return e / e.sum(dim=-1, keepdim=True), logits
    if m.router_score == "sigmoid":
        s = get_activation("sigmoid", cfg.act_impl, range_mode="reduce")(logits)
        return s / (s.sum(dim=-1, keepdim=True) + 1e-9), logits
    raise ValueError(m.router_score)


def top_k(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest along the last axis, the lower
    index first among equal scores (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def capacity(S: int, cfg) -> int:
    """Per-group expert capacity C = max(ceil(S * K * cap / E), 4)."""
    m = cfg.moe
    return max(int(math.ceil(S * m.top_k * m.capacity_factor / m.num_experts)), 4)


def route(scores: torch.Tensor, cfg):
    """scores (G,S,E) -> (gate_vals (G,S,K) f32, gate_idx (G,S,K), pos_in_e
    (G,S,K) queue positions, keep (G,S,K) bool), the GShard queueing."""
    m = cfg.moe
    G, S, E = scores.shape
    gate_vals, gate_idx = top_k(scores, m.top_k)
    if m.normalize_gates:
        gate_vals = gate_vals / (gate_vals.sum(dim=-1, keepdim=True) + 1e-9)
    C = capacity(S, cfg)
    onehot = nn.functional.one_hot(gate_idx, E).to(torch.int32)   # (G,S,K,E)
    flat = onehot.reshape(G, S * m.top_k, E)
    pos = torch.cumsum(flat, dim=1, dtype=torch.int32) * flat - 1   # (G,S*K,E)
    pos_in_e = (pos.reshape(G, S, m.top_k, E) * onehot).sum(-1)     # (G,S,K)
    keep = (pos_in_e < C) & (pos_in_e >= 0)
    return gate_vals, gate_idx, pos_in_e, keep


def moe_apply(p: MoE, x: torch.Tensor, cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B,S,d) -> (y (B,S,d), aux loss float32). GShard dispatch with the
    capacity factor, in per-sequence groups (G = B)."""
    m = cfg.moe
    B, S, d = x.shape
    E = m.num_experts
    dt = x.dtype

    scores, _ = router_scores(p, x.reshape(B * S, d), cfg)
    scores = scores.reshape(B, S, E)
    gate_vals, gate_idx, pos_in_e, keep = route(scores, cfg)
    C = capacity(S, cfg)

    # dispatch/combine (G,S,K,E,C) one-hots in x.dtype, summed over K
    slot = torch.where(keep, pos_in_e, torch.full_like(pos_in_e, C)).long()
    disp = (nn.functional.one_hot(gate_idx, E).to(dt)[..., None]
            * nn.functional.one_hot(slot, C + 1).to(dt)[..., None, :-1])
    combine = disp * gate_vals[..., None, None].to(dt)
    disp_t = disp.sum(dim=2)                                  # (G,S,E,C)
    combine_t = combine.sum(dim=2)

    xe = torch.einsum("gsec,gsd->gecd", disp_t, x)            # (G,E,C,d)
    act = get_activation("silu", cfg.act_impl, range_mode="reduce")
    g = torch.einsum("gecd,edf->gecf", xe, p.w_gate.to(dt))
    u = torch.einsum("gecd,edf->gecf", xe, p.w_up.to(dt))
    h = act(g) * u
    ye = torch.einsum("gecf,efd->gecd", h, p.w_down.to(dt))
    y = torch.einsum("gsec,gecd->gsd", combine_t, ye)         # (G,S,d)

    # load-balancing aux loss (Switch/GShard form); jnp.mean of x.dtype
    # sums in float32 and rounds the mean back to x.dtype
    me = scores.mean(dim=(0, 1))                              # (E,)
    ce = disp_t.sum(dim=-1).to(torch.float32).mean(dim=(0, 1)).to(dt)
    aux = E * (me * ce.to(torch.float32)).sum() * m.aux_loss_coef

    if p.shared is not None:
        sp = p.shared
        gs = x @ sp.w_gate.to(dt)
        us = x @ sp.w_up.to(dt)
        y = y + (act(gs) * us) @ sp.w_down.to(dt)
    return y, aux
