"""Int8 error-feedback gradient compression (port of
``repro/distributed/compression.py``).

Gradients are quantized to int8 with a per-tensor scale before the
data-parallel reduction; the quantization residual is carried in an
error-feedback buffer and added back the next step (EF-SGD / 1-bit-Adam
lineage), which keeps convergence unbiased to first order. On one device
the reduction is the identity, so ``compress_grads`` models the end-to-end
numerics of a compressed reduction: quantize -> dequantize with error
feedback, applied to the gradients right before the optimizer (what the
trainer's ``compress`` flag runs). ``psum_compressed`` is the explicit
collective over ``torch.distributed`` (int8 payload held in int32, int32
accumulation, one shared scale), for runtimes that own their reductions.

Rounding, as jitted XLA:CPU computes the JAX functions (held bit for bit by
tests/test_torch_train_archs.py): ``max|x| / 127 + 1e-30`` is a multiply by
float32(1/127) fused with the add (one rounding); the codes are
``round(x / scale)``, a true division (the scale is computed, not a
constant), half to even, clipped to +-127; the residual ``gf - q * scale``
is fused (one rounding).
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.core import numerics as nx

Tensors = Dict[str, torch.Tensor]

#: float32(1/127): XLA's rewrite of the division by the constant 127
_INV_127 = float(np.float32(1.0 / 127.0))
#: elements a piece of the fused residual: its float64 temporaries stay
#: ~0.5 GB for a full-width expert weight of ~420M elements
_PIECE = 1 << 24


def quantize_int8(x: torch.Tensor, amax=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x float32 -> (int8 codes, float32 scalar scale); ``amax``: the
    whole leaf's max |x| when ``x`` is a rank's slice of it."""
    scale = nx.fma(x.abs().amax() if amax is None else amax, _INV_127, 1e-30)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def _residual(q: torch.Tensor, s: torch.Tensor, gf: torch.Tensor) -> torch.Tensor:
    """gf - q * s with one rounding (the fused multiply-add), in pieces."""
    out = torch.empty_like(gf)
    qv, gv, ov = q.view(-1), gf.view(-1), out.view(-1)
    for lo in range(0, qv.numel(), _PIECE):
        sl = slice(lo, lo + _PIECE)
        ov[sl] = nx.fma(qv[sl].to(torch.float32), -s, gv[sl])
    return out


def init_error_state(params: Tensors) -> Tensors:
    """Zero float32 error-feedback buffers, one per parameter."""
    return {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()}


def _one(g: torch.Tensor, e: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    gf = (g.to(torch.float32) + e).contiguous()
    q, s = quantize_int8(gf)
    return dequantize_int8(q, s).to(g.dtype), _residual(q, s, gf)


def compress_grads(grads: Tensors, err_state: Tensors) -> Tuple[Tensors, Tensors]:
    """Error-feedback int8 round trip. Returns (grads', new error state)."""
    out = {k: _one(g, err_state[k]) for k, g in grads.items()}
    return {k: v[0] for k, v in out.items()}, {k: v[1] for k, v in out.items()}


@torch.no_grad()
def compress_grads_(grads: Tensors, err_state: Tensors, amax_max=None) -> None:
    """``compress_grads`` written into the given tensors, leaf by leaf: the
    train step's form, which at full width holds no second copy of the
    gradients and the buffers (8 bytes a parameter). On a mesh each
    gradient is a rank's slice of the whole (reduced) leaf: ``amax_max``
    takes the vector of every leaf's local max |g + e| and returns the
    whole leaves' (a MAX all-reduce over the model axis, one for every
    leaf: a whole leaf's is alike on every rank), so the scale, the codes
    and the residuals are the whole leaf's. The gradients are float32 (the
    master weights'): g + e is formed in them."""
    if amax_max is None:
        for k, g in grads.items():
            deq, err = _one(g, err_state[k])
            g.copy_(deq)
            err_state[k].copy_(err)
        return
    for k, g in grads.items():          # g + e, in place (float32 leaves)
        g.copy_(g.to(torch.float32) + err_state[k])
    amax = amax_max(torch.stack([g.abs().amax() for g in grads.values()]))
    for (k, g), a in zip(grads.items(), amax):
        q, s = quantize_int8(g, a)
        err_state[k].copy_(_residual(q, s, g))
        g.copy_(dequantize_int8(q, s).to(g.dtype))


def psum_compressed(x: torch.Tensor, group=None) -> torch.Tensor:
    """Mean over the ranks of ``group`` with an int8 payload and int32
    accumulation (the JAX ``psum_compressed`` inside ``shard_map``): a MAX
    all-reduce of each rank's amax gives every rank one scale, then the
    codes ``clip(round(x / scale), -127, 127)`` (in int32) are summed and
    ``total * scale / n`` comes back, float32. The scale rounds as
    ``quantize_int8``'s does under jit (one fused multiply-add)."""
    import torch.distributed as dist

    n = dist.get_world_size(group)
    amax = x.to(torch.float32).abs().amax().reshape(1)
    dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
    scale = nx.fma(amax[0], _INV_127, 1e-30)
    q = torch.clamp(torch.round(x.to(torch.float32) / scale), -127, 127).to(torch.int32)
    dist.all_reduce(q, group=group)
    return q.to(torch.float32) * scale / n
