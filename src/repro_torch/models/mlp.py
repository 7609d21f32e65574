"""MLP blocks (SwiGLU / GELU) wired to the CORDIC activation registry (port
of ``repro/models/mlp.py``).

``act_impl`` selects how the sigmoid/tanh-family nonlinearities are
evaluated (``core/activations.py``): "exact", "cordic_float",
"cordic_fixed" (paper-faithful Q2.14, plain torch) or "cordic_pallas" (the
CUDA kernels, which also run the fused ``silu_mul`` epilogue of the SwiGLU).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.core.activations import get_activation
from repro_torch.kernels import ops as kops
from repro_torch.models import common as cm


def leaf(shape, gen, dtype, device, std=None) -> nn.Parameter:
    """A frozen weight: N(0, std^2) drawn from ``gen`` (the fan-in rule when
    std is None), or storage to load into when ``gen`` is None."""
    w = (cm.init_normal(shape, gen, dtype, device, std) if gen is not None
         else torch.empty(shape, dtype=dtype, device=device))
    return nn.Parameter(w, requires_grad=False)


class SwiGLU(nn.Module):
    """w_gate, w_up (d, d_ff) and w_down (d_ff, d), as the JAX spec."""

    def __init__(self, d: int, d_ff: int, *, dtype: torch.dtype,
                 device: torch.device, gen: torch.Generator = None):
        super().__init__()
        for name, shape in (("w_gate", (d, d_ff)), ("w_up", (d, d_ff)),
                            ("w_down", (d_ff, d))):
            setattr(self, name, leaf(shape, gen, dtype, device))


def swiglu_apply(p: SwiGLU, x: torch.Tensor, cfg) -> torch.Tensor:
    g = x @ p.w_gate.to(x.dtype)
    u = x @ p.w_up.to(x.dtype)
    if cfg.act_impl == "cordic_pallas":
        h = kops.silu_mul(g, u)
    else:
        h = get_activation("silu", cfg.act_impl, range_mode="reduce")(g) * u
    return h @ p.w_down.to(x.dtype)


class GeluMLP(nn.Module):
    """w_in (d, d_ff), b_in (d_ff,), w_out (d_ff, d), b_out (d,), as the JAX
    ``gelu_mlp_spec`` (biases start at zero)."""

    def __init__(self, d: int, d_ff: int, *, dtype: torch.dtype,
                 device: torch.device, gen: torch.Generator = None):
        super().__init__()
        self.w_in = leaf((d, d_ff), gen, dtype, device)
        self.b_in = nn.Parameter(torch.zeros(d_ff, dtype=dtype, device=device),
                                 requires_grad=False)
        self.w_out = leaf((d_ff, d), gen, dtype, device)
        self.b_out = nn.Parameter(torch.zeros(d, dtype=dtype, device=device),
                                  requires_grad=False)


def gelu_mlp_apply(p: GeluMLP, x: torch.Tensor, cfg) -> torch.Tensor:
    """GELU MLP (musicgen-style). With a CORDIC impl the tanh-approx GELU
    routes its tanh through the MR-HRC pipeline."""
    act = get_activation("gelu_tanh" if cfg.act_impl != "exact" else "gelu",
                         cfg.act_impl, range_mode="reduce")
    h = act(x @ p.w_in.to(x.dtype) + p.b_in.to(x.dtype))
    return h @ p.w_out.to(x.dtype) + p.b_out.to(x.dtype)
