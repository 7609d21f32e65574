"""AdamW written out (no ``torch.optim``), port of ``repro/optim/adamw.py``.

Parameters, gradients and both moments are dicts of tensors with the same
keys; the state mirrors the parameters. The update runs under
``torch.no_grad`` in the JAX formula order, with weight decay on every leaf
as JAX applies it. Unlike the JAX function it writes the new parameters and
moments into the given tensors, in place: at Yi-9B width a functional update
would hold a second copy of the parameters and both moments (12 bytes per
parameter) at its peak.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple

import torch

Tensors = Dict[str, torch.Tensor]


class AdamWState(NamedTuple):
    step: torch.Tensor      # int32 scalar
    mu: Tensors
    nu: Tensors


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def init(params: Tensors) -> AdamWState:
    dev = next(iter(params.values())).device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      mu={k: torch.zeros_like(p) for k, p in params.items()},
                      nu={k: torch.zeros_like(p) for k, p in params.items()})


def global_norm(tree: Tensors) -> torch.Tensor:
    return torch.sqrt(sum(l.to(torch.float32).square().sum()
                          for l in tree.values()))


def _clip_scale(gn: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / gn.clamp_min(1e-12), max=1.0)


def clip_by_global_norm(grads: Tensors, max_norm: float):
    gn = global_norm(grads)
    scale = _clip_scale(gn, max_norm)
    return {k: (g * scale).to(g.dtype) for k, g in grads.items()}, gn


@torch.no_grad()
def apply_updates(params: Tensors, state: AdamWState, grads: Tensors,
                  cfg: AdamWConfig, lr_scale=1.0):
    """One AdamW step. Returns (params, new state, {"grad_norm"}); params
    and moments are updated in place (see the module docstring)."""
    gn = global_norm(grads)
    scale = _clip_scale(gn, cfg.grad_clip)
    step = state.step + 1
    stepf = step.to(torch.float32)
    b1t = 1.0 - cfg.b1 ** stepf
    b2t = 1.0 - cfg.b2 ** stepf
    lr = cfg.lr * lr_scale
    for k, p in params.items():
        g = grads[k]
        gf = (g * scale).to(g.dtype).to(torch.float32)
        m, v = state.mu[k], state.nu[k]
        m.mul_(cfg.b1).add_((1 - cfg.b1) * gf)           # b1 m + (1-b1) g
        v.mul_(cfg.b2).add_((1 - cfg.b2) * gf.square())  # b2 v + (1-b2) g^2
        delta = (m / b1t) / (torch.sqrt(v / b2t) + cfg.eps) \
            + cfg.weight_decay * p.to(torch.float32)
        p.copy_((p.to(torch.float32) - lr * delta).to(p.dtype))
    return params, AdamWState(step, state.mu, state.nu), {"grad_norm": gn}
