"""Paged decode attention, GQA and MLA: plain PyTorch versions and the
CUDA kernels.

Port of ``gqa_decode``, ``mla_decode`` and ``canonical_kv_dtype`` of
``repro/kernels/paged_attention.py``. One query row per slot walks its own
block table up to ``k_len`` and attends the live blocks in place; the
kernels (``csrc/paged_decode.cu``) loop over live blocks only, GQA on a
(slot, kv-head) grid, MLA on a (slot, head-group) grid (the latent and rope
pools have no head axis, so one staged block serves every head of a group).

Softmax (``softmax_impl``):

    "exact"          one sweep, online (flash-decoding) rescaling, exp
    "cordic_pallas"  three sweeps: row max, CORDIC e^u row sum, lane-exact
                     R2-LVC probabilities (``softmax_cordic`` stages)
    "cordic_fixed"   the same three sweeps on the function library's lanes:
                     ``functions.exp_fixed`` in the sum and
                     ``divide_fixed(exp_fixed(u), S)`` in the probabilities,
                     as ``functions.softmax_fixed`` computes them (masked
                     lanes of a live block clip at e^-80, no lane flushes)

Summation orders are fixed and shared by the kernels and the plain
versions: a GQA score is a left-to-right sum over head_dim; an MLA score is
``(sum_R qe*c + sum_P qr*r) * scale``, each sum taken as ``MLA_SPLIT``
strided partials (partial t sums elements t, t + MLA_SPLIT, ... left to
right, one thread each) added left to right; block sums and P.V sums run
left to right over a block's lanes. With ``-fmad=false`` kernel and plain
agree bit for bit on both CORDIC impls; against the JAX kernels, whose dots
XLA orders, outputs agree to f32 round-off (the reference's own ATOL 2e-5).

Not ported yet: the quantized-pool branch of ``gqa_decode`` (``kv_quant``,
ROADMAP B.6).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.cordic_engine import functions as F
from repro_torch.cordic_engine.core import PAPER_FIXED, FixedConfig
from repro_torch.cordic_engine.schedule import PAPER_SCHEDULE, MRSchedule
from repro_torch.kernels import build
from repro_torch.kernels.softmax_cordic import _lane_exp, _lane_probs, _seq_sum

NEG_INF = -1e30
#: softmax impls, in the order of the kernels' impl codes
IMPLS = ("exact", "cordic_pallas", "cordic_fixed")


def _impl(softmax_impl: Optional[str]) -> str:
    impl = "exact" if softmax_impl is None else softmax_impl
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


def _walk(tables, k_len, L: int, impl: str):
    """The block walk of both decodes: (pass, block ids (B,), live rows
    (B,), valid lanes (B,L)) for every pass and every table column some row
    still covers (c * L < k_len), in the kernels' order."""
    klen = k_len.to(torch.int64)
    lane = torch.arange(L, device=tables.device)
    for pas in range(1 if impl == "exact" else 3):
        for c in range(tables.shape[1]):
            live = c * L < klen
            if bool(live.any()):
                yield (pas, tables[:, c].to(torch.int64), live,
                       (c * L + lane)[None, :] < klen[:, None])


def _pass_update(s, live, pas, impl, state, contract, sched, cfg):
    """One block of the softmax accumulation shared by both decodes (the
    JAX ``_pass_update``). s (..., L) masked scores; live broadcastable to
    s[..., :1]; state (running max, running sum, accumulator);
    contract(p) -> the block's weighted-value sum. ``exact``: the online
    (flash-decoding) recurrence; the CORDIC impls: pass 0 the row max,
    pass 1 the CORDIC e^u row sum, pass 2 the lane-exact probabilities
    (``cordic_fixed`` through the function library, which takes the
    reference's default schedules)."""
    m, l_sum, acc = state
    if impl == "exact":
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        ef = torch.exp(s - m_new)
        return (torch.where(live, m_new, m),
                torch.where(live, l_sum * alpha + _seq_sum(ef), l_sum),
                torch.where(live, acc * alpha + contract(ef), acc))
    if pas == 0:
        return torch.where(live, torch.maximum(m, s.amax(dim=-1, keepdim=True)), m), \
            l_sum, acc
    if pas == 1:
        e = (F.exp_fixed(s - m, cfg=cfg) if impl == "cordic_fixed"
             else _lane_exp(s - m, sched, cfg))
        return m, torch.where(live, l_sum + _seq_sum(e), l_sum), acc
    if impl == "cordic_fixed":
        pr = F.divide_fixed(F.exp_fixed(s - m, cfg=cfg), l_sum, cfg=cfg)
    else:
        pr = _lane_probs(s - m, l_sum, sched, cfg)
    return m, l_sum, torch.where(live, acc + contract(pr), acc)


def _kernel_sched(impl: str, sched: MRSchedule) -> MRSchedule:
    """The schedule whose ROM the kernel gets: ``cordic_fixed`` runs
    ``exp_fixed``/``divide_fixed`` with their default schedules
    (HYP_ROTATION, LIN_VECTORING: PAPER_SCHEDULE's two halves), whatever
    ``sched`` the caller passed, as the reference does."""
    return PAPER_SCHEDULE if impl == "cordic_fixed" else sched


def _init_state(lead, width, device):
    m = torch.full(lead + (1,), NEG_INF, dtype=torch.float32, device=device)
    return (m, torch.zeros_like(m),
            torch.zeros(lead + (width,), dtype=torch.float32, device=device))


def gqa_decode_plain(q, k_pool, v_pool, tables, k_len, *, scale: float,
                     softmax_impl: str = "exact", kv_dtype=None,
                     sched: MRSchedule = PAPER_SCHEDULE,
                     cfg: FixedConfig = PAPER_FIXED) -> torch.Tensor:
    """Plain PyTorch version of the block-walking decode (same block order,
    same sums as the kernel)."""
    impl = _impl(softmax_impl)
    kvd = canonical_kv_dtype(kv_dtype) or canonical_kv_dtype(k_pool.dtype)
    B, KH, G, hd = q.shape
    qf = q.to(torch.float32)
    state = _init_state((B, KH, G), hd, q.device)
    for pas, blk, live, valid in _walk(tables, k_len, k_pool.shape[1], impl):
        kb = k_pool[blk].to(kvd).to(torch.float32)                 # (B,L,KH,hd)
        s = _seq_scores(qf, kb) * scale
        s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG_INF))
        state = _pass_update(
            s, live[:, None, None, None], pas, impl, state,
            lambda p: _seq_pv(p, v_pool[blk].to(kvd).to(torch.float32)),
            sched, cfg)
    _, l_sum, acc = state
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
        build.DTYPE_CODE[kvd], build.params_ptr(_kernel_sched(impl, sched), cfg),
        build.stream_ptr(q))
    build.check(rc, "gqa_decode")
    build.count("gqa_decode")
    return out


# ---------------------------------------------------------------------------
# MLA decode (absorbed form)
# ---------------------------------------------------------------------------
#: strided partials of an MLA score sum (the kernel's threads per score)
MLA_SPLIT = 16


def _split_dot(q: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """q (B,H,n) . c (B,L,n) -> (B,H,L) in the kernel's order: MLA_SPLIT
    strided partials, partial t summing elements t, t + MLA_SPLIT, ... left
    to right, then the partials added left to right."""
    B, H, n = q.shape
    part = torch.zeros((B, H, c.shape[1], MLA_SPLIT), dtype=torch.float32,
                       device=q.device)
    for i in range(0, n, MLA_SPLIT):
        w = min(MLA_SPLIT, n - i)
        part[..., :w] = part[..., :w] + (q[:, :, None, i:i + w]
                                         * c[:, None, :, i:i + w])
    s = part[..., 0]
    for t in range(1, MLA_SPLIT):
        s = s + part[..., t]
    return s


def _seq_latent(p: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """p (B,H,L) . c (B,L,R) -> (B,H,R), summed left to right over the
    block's lanes."""
    acc = torch.zeros(p.shape[:2] + (c.shape[-1],), dtype=torch.float32,
                      device=p.device)
    for l in range(c.shape[1]):
        acc = acc + p[..., l:l + 1] * c[:, l, None, :]
    return acc


def mla_decode_plain(q_eff, q_rope, c_pool, r_pool, tables, k_len, *,
                     scale: float, softmax_impl: str = "exact",
                     sched: MRSchedule = PAPER_SCHEDULE,
                     cfg: FixedConfig = PAPER_FIXED) -> torch.Tensor:
    """Plain PyTorch version of the block-walking MLA decode (same block
    order, same sums as the kernel)."""
    impl = _impl(softmax_impl)
    B, H, R = q_eff.shape
    qe = q_eff.to(torch.float32)
    qr = q_rope.to(torch.float32)
    state = _init_state((B, H), R, qe.device)
    for pas, blk, live, valid in _walk(tables, k_len, c_pool.shape[1], impl):
        cb = c_pool[blk].to(torch.float32)                          # (B,L,R)
        rb = r_pool[blk].to(torch.float32)                          # (B,L,P)
        s = (_split_dot(qe, cb) + _split_dot(qr, rb)) * scale      # (B,H,L)
        s = torch.where(valid[:, None, :], s, torch.full_like(s, NEG_INF))
        state = _pass_update(s, live[:, None, None], pas, impl, state,
                             lambda p: _seq_latent(p, cb), sched, cfg)
    _, l_sum, acc = state
    return acc / l_sum if impl == "exact" else acc


#: heads per CTA of the MLA decode kernel (grid: slots x ceil(H / this))
MLA_HEADS_PER_CTA = 4


def mla_decode(q_eff, q_rope, c_pool, r_pool, tables, k_len, *, scale: float,
               softmax_impl: str = "exact",
               sched: MRSchedule = PAPER_SCHEDULE,
               cfg: FixedConfig = PAPER_FIXED) -> torch.Tensor:
    """Paged absorbed-form MLA decode: scores against the compressed latent
    and the shared rope key, output accumulated in the latent space.

    q_eff (B,H,R) absorbed queries (q_nope @ wk_b), q_rope (B,H,P), float32
    or bfloat16; c_pool (N,L,R) and r_pool (N,L,P) float32 (block 0 is
    scratch); tables (B,M) int32; k_len (B,) int32 >= 1. Returns (B,H,R)
    float32 latent outputs (the wv_b projection stays outside, as in
    models.attention)."""
    impl = _impl(softmax_impl)
    if q_eff.device.type == "cpu":
        return mla_decode_plain(q_eff, q_rope, c_pool, r_pool, tables, k_len,
                                scale=scale, softmax_impl=impl, sched=sched,
                                cfg=cfg)
    B, H, R = q_eff.shape
    P = q_rope.shape[-1]
    N, L = c_pool.shape[:2]
    M = tables.shape[1]
    if q_eff.dtype not in build.DTYPE_CODE or q_rope.dtype != q_eff.dtype:
        raise TypeError(f"mla_decode: q_eff {q_eff.dtype} / q_rope "
                        f"{q_rope.dtype} not supported (one of float32, "
                        "bfloat16)")
    if c_pool.dtype != torch.float32 or r_pool.dtype != torch.float32:
        raise TypeError("mla_decode: the kernel takes float32 pools")
    if (q_rope.shape != (B, H, P) or c_pool.shape != (N, L, R)
            or r_pool.shape != (N, L, P)):
        raise ValueError(f"mla_decode: q_eff {tuple(q_eff.shape)}, q_rope "
                         f"{tuple(q_rope.shape)}, pools {tuple(c_pool.shape)} "
                         f"{tuple(r_pool.shape)} do not match")
    if tables.dtype != torch.int32 or k_len.dtype != torch.int32 \
            or tables.shape[0] != B or k_len.shape != (B,):
        raise ValueError("mla_decode: tables (B,M) and k_len (B,) are int32")
    ts = (q_eff, q_rope, c_pool, r_pool, tables, k_len)
    if any(t.device != q_eff.device or not t.is_contiguous() for t in ts):
        raise ValueError("mla_decode: inputs must be contiguous on one device")
    out = torch.empty((B, H, R), dtype=torch.float32, device=q_eff.device)
    rc = build.library("paged_decode").paged_mla_decode(
        q_eff.data_ptr(), q_rope.data_ptr(), build.DTYPE_CODE[q_eff.dtype],
        c_pool.data_ptr(), r_pool.data_ptr(), tables.data_ptr(),
        k_len.data_ptr(), out.data_ptr(), B, H, R, P, L, M,
        MLA_HEADS_PER_CTA, float(scale), IMPLS.index(impl),
        build.params_ptr(_kernel_sched(impl, sched), cfg),
        build.stream_ptr(q_eff))
    build.check(rc, "mla_decode")
    build.count("mla_decode")
    return out
