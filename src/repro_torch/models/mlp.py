"""MLP blocks (SwiGLU / GELU) wired to the CORDIC activation registry (port
of ``repro/models/mlp.py``).

``act_impl`` selects how the sigmoid/tanh-family nonlinearities are
evaluated (``core/activations.py``): "exact", "cordic_float",
"cordic_fixed" (paper-faithful Q2.14, plain torch) or "cordic_pallas" (the
CUDA kernels, which also run the fused ``silu_mul`` epilogue of the SwiGLU).

Under tensor parallelism (distributed/sharding.py) a rank holds a column
slice of ``w_gate/w_up`` (``w_in/b_in``) and the matching row slice of
``w_down`` (``w_out``): its down product is a partial sum, reduced over
the model axis (``b_out`` added once, after the sum). Under grad the
input's gradient is summed over the model axis too (``shd.to_ranks``).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.core.activations import get_activation
from repro_torch.distributed import sharding as shd
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


def swiglu_apply(p: SwiGLU, x: torch.Tensor, cfg, ops=cm.LIBRARY) -> torch.Tensor:
    """The SwiGLU FFN; ``ops`` the products (``cm.Products``)."""
    cut = shd.is_cut(p, "w_down")
    x = shd.to_ranks(x) if cut else x
    g = ops.matmul(x, p.w_gate.to(x.dtype))
    u = ops.matmul(x, p.w_up.to(x.dtype))
    if cfg.act_impl == "cordic_pallas":
        h = kops.silu_mul(g, u)
    else:
        h = get_activation("silu", cfg.act_impl, range_mode="reduce")(g) * u
    y = ops.matmul(h, p.w_down.to(x.dtype))
    return shd.row_sum(y) if cut else y


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


def gelu_mlp_apply(p: GeluMLP, x: torch.Tensor, cfg, ops=cm.LIBRARY) -> torch.Tensor:
    """GELU MLP (musicgen-style). With a CORDIC impl the tanh-approx GELU
    routes its tanh through the MR-HRC pipeline; ``ops`` the products."""
    act = get_activation("gelu_tanh" if cfg.act_impl != "exact" else "gelu",
                         cfg.act_impl, range_mode="reduce")
    cut = shd.is_cut(p, "w_out")
    x = shd.to_ranks(x) if cut else x
    h = act(ops.matmul(x, p.w_in.to(x.dtype)) + p.b_in.to(x.dtype))
    y = ops.matmul(h, p.w_out.to(x.dtype))
    if cut:
        y = shd.row_sum(y)
    return y + p.b_out.to(x.dtype)
