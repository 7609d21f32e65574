"""SwiGLU MLP wired to the CORDIC kernels (port of ``repro/models/mlp.py``).

``act_impl="cordic_pallas"`` runs the fused ``silu_mul`` epilogue (the CUDA
kernel on the card, its plain version on the CPU). The registry of the other
act_impls (``exact``, ``cordic_float``, ``cordic_fixed``) and the GELU MLP
come with ROADMAP A.3.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.kernels import ops as kops
from repro_torch.models import common as cm


class SwiGLU(nn.Module):
    """w_gate, w_up (d, d_ff) and w_down (d_ff, d), as the JAX spec."""

    def __init__(self, d: int, d_ff: int, *, dtype: torch.dtype,
                 device: torch.device, gen: torch.Generator = None):
        super().__init__()
        for name, shape in (("w_gate", (d, d_ff)), ("w_up", (d, d_ff)),
                            ("w_down", (d_ff, d))):
            w = (cm.init_normal(shape, gen, dtype, device) if gen is not None
                 else torch.empty(shape, dtype=dtype, device=device))
            setattr(self, name, nn.Parameter(w, requires_grad=False))


def swiglu_apply(p: SwiGLU, x: torch.Tensor, cfg) -> torch.Tensor:
    if cfg.act_impl != "cordic_pallas":
        raise NotImplementedError(
            f"act_impl={cfg.act_impl!r} is not ported yet (ROADMAP A.3: the "
            "activation registry); the port runs act_impl='cordic_pallas'")
    g = x @ p.w_gate.to(x.dtype)
    u = x @ p.w_up.to(x.dtype)
    h = kops.silu_mul(g, u)
    return h @ p.w_down.to(x.dtype)
