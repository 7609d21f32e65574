"""Front door to the CORDIC kernels (port of ``repro/kernels/ops.py``).

Shape-polymorphic wrappers: an input of any rank is flattened (the TPU's
(rows, 1024) padding is gone) and handed to the kernel wrapper, which takes
the kernel for a CUDA tensor and the plain PyTorch version for a CPU one.
Serving needs no gradient; the ``autograd.Function`` twins of the JAX
``custom_jvp`` rules come with the training slice (ROADMAP A.4).
"""
from __future__ import annotations

import torch

from repro_torch.cordic_engine.core import PAPER_FIXED
from repro_torch.cordic_engine.schedule import PAPER_SCHEDULE
from repro_torch.kernels import cordic_act as K
from repro_torch.kernels import paged_attention as PA
from repro_torch.kernels import softmax_cordic as SM


def _elementwise(x: torch.Tensor, op: str, sched, cfg,
                 max_doublings: int) -> torch.Tensor:
    y = K.act_2d(x.contiguous().view(-1), op, sched=sched, cfg=cfg,
                 max_doublings=max_doublings)
    return y.view(x.shape)


def sigmoid(x, sched=PAPER_SCHEDULE, cfg=PAPER_FIXED, max_doublings=3):
    """Sigmoid with the paper's |x| <= 1 clamp contract."""
    return _elementwise(x, "sigmoid", sched, cfg, max_doublings)


def sigmoid_wide(x, sched=PAPER_SCHEDULE, cfg=PAPER_FIXED, max_doublings=3):
    """Sigmoid with dyadic range extension to |x| <= 2^max_doublings."""
    return _elementwise(x, "sigmoid_wide", sched, cfg, max_doublings)


def tanh(x, sched=PAPER_SCHEDULE, cfg=PAPER_FIXED, max_doublings=3):
    """tanh with the paper's |z| <= 0.5 clamp contract."""
    return _elementwise(x, "tanh", sched, cfg, max_doublings)


def silu(x, sched=PAPER_SCHEDULE, cfg=PAPER_FIXED, max_doublings=3):
    """x * sigmoid(x), wide-range, in one kernel pass."""
    return _elementwise(x, "silu", sched, cfg, max_doublings)


def silu_mul(gate, up, sched=PAPER_SCHEDULE, cfg=PAPER_FIXED, max_doublings=3):
    """Fused SwiGLU combiner up * gate * sigmoid(gate); equal shapes."""
    if gate.shape != up.shape:
        raise ValueError(f"silu_mul: shapes differ {gate.shape} {up.shape}")
    y = K.silu_mul_2d(gate.contiguous().view(-1), up.contiguous().view(-1),
                      sched=sched, cfg=cfg, max_doublings=max_doublings)
    return y.view(gate.shape)


def softmax(x, axis: int = -1, sched=PAPER_SCHEDULE, cfg=PAPER_FIXED):
    """CORDIC softmax along ``axis`` (computed in float32, returned in
    x.dtype). -1e30 masked lanes come out exactly 0."""
    xm = torch.movedim(x, axis, -1)
    lead, c = xm.shape[:-1], xm.shape[-1]
    y2 = SM.softmax_2d(xm.reshape(-1, c).to(torch.float32).contiguous(),
                       sched=sched, cfg=cfg)
    return torch.movedim(y2.view(*lead, c).to(x.dtype), -1, axis)


def paged_attend_gqa(q, k_pool, v_pool, tables, k_len, *, scale,
                     softmax_impl: str = "exact", kv_dtype=None,
                     kv_quant: str = "none", k_scale_pool=None,
                     v_scale_pool=None, sched=PAPER_SCHEDULE, cfg=PAPER_FIXED):
    """Block-walking paged GQA decode attend (kernels/paged_attention.py)."""
    return PA.gqa_decode(q, k_pool, v_pool, tables, k_len, scale=scale,
                         softmax_impl=softmax_impl, kv_dtype=kv_dtype,
                         kv_quant=kv_quant, k_scale_pool=k_scale_pool,
                         v_scale_pool=v_scale_pool, sched=sched, cfg=cfg)
