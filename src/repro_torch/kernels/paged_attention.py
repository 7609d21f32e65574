"""Paged GQA decode attention: plain PyTorch version and the CUDA kernel.

Port of ``gqa_decode`` / ``canonical_kv_dtype`` of
``repro/kernels/paged_attention.py``. One query row per slot walks its own
block table up to ``k_len`` and attends the live K/V blocks in place; the
kernel (``csrc/paged_decode.cu``) runs a (slot, kv-head) grid and loops over
live blocks only.

Softmax (``softmax_impl``):

    "exact"          one sweep, online (flash-decoding) rescaling, exp
    "cordic_pallas"  three sweeps: row max, CORDIC e^u row sum, lane-exact
                     R2-LVC probabilities (``softmax_cordic`` stages)

Summation orders are fixed and shared by the kernel and the plain version:
scores are left-to-right sums over head_dim, block sums and P.V sums run
left to right over a block's lanes. With ``-fmad=false`` the two agree bit
for bit on ``cordic_pallas``; against the JAX kernel, whose dots XLA orders,
outputs agree to f32 round-off (the reference's own ATOL 2e-5).

Not ported yet: ``cordic_fixed`` (``functions.exp_fixed/divide_fixed``,
ROADMAP B.5), the quantized-pool branch (``kv_quant``, ROADMAP B.6) and
``mla_decode`` (ROADMAP B.7).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.cordic_engine.core import PAPER_FIXED, FixedConfig
from repro_torch.cordic_engine.schedule import PAPER_SCHEDULE, MRSchedule
from repro_torch.kernels import build
from repro_torch.kernels.softmax_cordic import _lane_exp, _lane_probs, _seq_sum

NEG_INF = -1e30
IMPLS = ("exact", "cordic_pallas")


def _impl(softmax_impl: Optional[str]) -> str:
    impl = "exact" if softmax_impl is None else softmax_impl
    if impl == "cordic_fixed":
        raise NotImplementedError(
            "paged decode with softmax_impl='cordic_fixed' is not ported yet "
            "(ROADMAP B.5: the functions.exp_fixed/divide_fixed branch)")
    if impl not in IMPLS:
        raise ValueError(f"unknown softmax_impl {softmax_impl!r}")
    return impl


def canonical_kv_dtype(kv_dtype) -> Optional[torch.dtype]:
    """Validate the ``kv_dtype`` cast seam: a float dtype (or its name), or
    None. Integer pool storage is ``kv_quant``'s job, not kv_dtype's."""
    if kv_dtype is None:
        return None
    dt = kv_dtype
    if isinstance(kv_dtype, str):
        dt = getattr(torch, kv_dtype, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown kv_dtype {kv_dtype!r}; expected a float "
                         "dtype such as torch.float32 / torch.bfloat16")
    if not dt.is_floating_point:
        raise ValueError(
            f"kv_dtype {dt} is not a float dtype — kv_dtype is the storage-"
            "rounding cast applied to K/V before scoring; select integer "
            "pool storage with kv_quant instead")
    return dt


def _seq_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q (B,KH,G,hd) . k (B,L,KH,hd) -> (B,KH,G,L), summed left to right
    over head_dim."""
    kt = k.permute(0, 2, 1, 3)                                # (B,KH,L,hd)
    s = torch.zeros(q.shape[:3] + (k.shape[1],), dtype=torch.float32,
                    device=q.device)
    for d in range(q.shape[-1]):
        s = s + q[..., d:d + 1] * kt[:, :, None, :, d]
    return s


def _seq_pv(p: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """p (B,KH,G,L) . v (B,L,KH,hd) -> (B,KH,G,hd), summed left to right
    over the block's lanes."""
    acc = torch.zeros(p.shape[:3] + (v.shape[-1],), dtype=torch.float32,
                      device=p.device)
    for l in range(v.shape[1]):
        acc = acc + p[..., l:l + 1] * v[:, l, :, None, :]
    return acc


def gqa_decode_plain(q, k_pool, v_pool, tables, k_len, *, scale: float,
                     softmax_impl: str = "exact", kv_dtype=None,
                     sched: MRSchedule = PAPER_SCHEDULE,
                     cfg: FixedConfig = PAPER_FIXED) -> torch.Tensor:
    """Plain PyTorch version of the block-walking decode (same block order,
    same sums as the kernel)."""
    impl = _impl(softmax_impl)
    kvd = canonical_kv_dtype(kv_dtype) or canonical_kv_dtype(k_pool.dtype)
    B, KH, G, hd = q.shape
    L = k_pool.shape[1]
    M = tables.shape[1]
    qf = q.to(torch.float32)
    klen = k_len.to(torch.int64)
    m = torch.full((B, KH, G, 1), NEG_INF, dtype=torch.float32, device=q.device)
    l_sum = torch.zeros_like(m)
    acc = torch.zeros((B, KH, G, hd), dtype=torch.float32, device=q.device)
    lane = torch.arange(L, device=q.device)
    for pas in range(1 if impl == "exact" else 3):
        for c in range(M):
            live = (c * L < klen)[:, None, None, None]             # (B,1,1,1)
            if not bool(live.any()):
                continue
            blk = tables[:, c].to(torch.int64)
            kb = k_pool[blk].to(kvd).to(torch.float32)             # (B,L,KH,hd)
            s = _seq_scores(qf, kb) * scale
            valid = (c * L + lane)[None, :] < klen[:, None]         # (B,L)
            s = torch.where(valid[:, None, None, :], s,
                            torch.full_like(s, NEG_INF))
            mx = s.amax(dim=-1, keepdim=True)
            if impl == "exact":
                vb = v_pool[blk].to(kvd).to(torch.float32)
                m_new = torch.maximum(m, mx)
                alpha = torch.exp(m - m_new)
                ef = torch.exp(s - m_new)
                l_new = l_sum * alpha + _seq_sum(ef)
                acc_new = acc * alpha + _seq_pv(ef, vb)
                m = torch.where(live, m_new, m)
                l_sum = torch.where(live, l_new, l_sum)
                acc = torch.where(live, acc_new, acc)
            elif pas == 0:
                m = torch.where(live, torch.maximum(m, mx), m)
            elif pas == 1:
                ef = _lane_exp(s - m, sched, cfg)
                l_sum = torch.where(live, l_sum + _seq_sum(ef), l_sum)
            else:
                vb = v_pool[blk].to(kvd).to(torch.float32)
                pr = _lane_probs(s - m, l_sum, sched, cfg)
                acc = torch.where(live, acc + _seq_pv(pr, vb), acc)
    return acc / l_sum if impl == "exact" else acc


def gqa_decode(q, k_pool, v_pool, tables, k_len, *, scale: float,
               softmax_impl: str = "exact", kv_dtype=None,
               kv_quant: str = "none", k_scale_pool=None, v_scale_pool=None,
               sched: MRSchedule = PAPER_SCHEDULE,
               cfg: FixedConfig = PAPER_FIXED) -> torch.Tensor:
    """Paged GQA decode attend.

    q (B,KH,G,hd) float32/bfloat16; pools (N,L,KH,hd) float32 (block 0 is
    scratch); tables (B,M) int32; k_len (B,) int32 >= 1. ``kv_dtype`` is
    the storage-rounding cast replayed on each K/V block (None: the pool's
    dtype). Returns (B,KH,G,hd) float32.
    """
    if kv_quant not in (None, "none") or k_scale_pool is not None \
            or v_scale_pool is not None:
        raise NotImplementedError(
            "quantized paged pools are not ported yet (ROADMAP B.6)")
    impl = _impl(softmax_impl)
    if q.device.type == "cpu":
        return gqa_decode_plain(q, k_pool, v_pool, tables, k_len, scale=scale,
                                softmax_impl=impl, kv_dtype=kv_dtype,
                                sched=sched, cfg=cfg)
    kvd = canonical_kv_dtype(kv_dtype) or canonical_kv_dtype(k_pool.dtype)
    B, KH, G, hd = q.shape
    N, L = k_pool.shape[:2]
    M = tables.shape[1]
    if q.dtype not in build.DTYPE_CODE or kvd not in build.DTYPE_CODE:
        raise TypeError(f"gqa_decode: q {q.dtype} / kv_dtype {kvd} not "
                        "supported (float32 or bfloat16)")
    if k_pool.dtype != torch.float32 or v_pool.dtype != torch.float32:
        raise TypeError("gqa_decode: the kernel takes float32 pools")
    if k_pool.shape != (N, L, KH, hd) or v_pool.shape != k_pool.shape:
        raise ValueError(f"gqa_decode: pools {tuple(k_pool.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if tables.dtype != torch.int32 or k_len.dtype != torch.int32 \
            or tables.shape[0] != B or k_len.shape != (B,):
        raise ValueError("gqa_decode: tables (B,M) and k_len (B,) are int32")
    ts = (q, k_pool, v_pool, tables, k_len)
    if any(t.device != q.device or not t.is_contiguous() for t in ts):
        raise ValueError("gqa_decode: inputs must be contiguous on one device")
    out = torch.empty((B, KH, G, hd), dtype=torch.float32, device=q.device)
    rc = build.library("paged_decode").paged_gqa_decode(
        q.data_ptr(), build.DTYPE_CODE[q.dtype], k_pool.data_ptr(),
        v_pool.data_ptr(), tables.data_ptr(), k_len.data_ptr(), out.data_ptr(),
        B, KH, G, hd, L, M, float(scale), IMPLS.index(impl),
        build.DTYPE_CODE[kvd], build.params_ptr(sched, cfg), build.stream_ptr(q))
    build.check(rc, "gqa_decode")
    build.count("gqa_decode")
    return out
