"""Paged decode attention, GQA and MLA: plain PyTorch versions and the
CUDA kernels.

Port of ``gqa_decode``, ``mla_decode`` and ``canonical_kv_dtype`` of
``repro/kernels/paged_attention.py``. One query row per slot walks its own
block table up to ``k_len`` and attends the live blocks in place. The plain
versions compute what the JAX kernels (``_gqa_kernel``, ``_mla_kernel``,
``_pass_update``) compute walking the blocks in table order once per
softmax pass: every lane's score and probability at once, each sum that
crosses blocks folded block by block in table order. The CUDA
kernels (``csrc/paged_decode.cu``) keep each output row's arithmetic order
but run everything except the folds in parallel, in four launches that
share a workspace (``gqa_plan`` / ``mla_plan``: grids and workspace from
the static shapes alone, never from ``k_len``):

    score    (table chunks, KH, B) CTAs: K staged and dequantized once, the
             scores of every live lane (MLA: (table chunks, head groups,
             B), the latent staged once per head group)
    softmax  one CTA per query row: row max, the lanes' e^u and block sums
             in parallel, the row sum folded in table order, the
             probabilities from the kept e^u; the row's lanes pass through
             shared memory ``softmax_tile`` blocks at a time (a row of at
             most that many blocks is staged once)
    pv       (table chunks, KH, B) CTAs (MLA: (table chunks, R / 128, B)):
             V staged once, each block's P.V sums
    fold     one CTA per row and 128 columns: the P.V sums folded in table
             order

Softmax (``softmax_impl``):

    "exact"          one sweep, online (flash-decoding) rescaling, exp
    "cordic_pallas"  three sweeps: row max, CORDIC e^u row sum, lane-exact
                     R2-LVC probabilities (``softmax_cordic`` stages)
    "cordic_fixed"   the same three sweeps on the function library's lanes:
                     ``functions.exp_fixed`` in the sum and
                     ``divide_fixed(exp_fixed(u), S)`` in the probabilities,
                     as ``functions.softmax_fixed`` computes them (masked
                     lanes of a live block clip at e^-80, no lane flushes)

Summation orders are fixed per output row and shared by the kernels and
the plain versions. A score's dot runs in jitted XLA:CPU's order for the
JAX kernel's einsum at this geometry (``dot_order``, ROADMAP C.4: one
fused multiply-add chain, or 2, 4 or 8 strided partials of fused
multiply-adds combined as a tree or by halves, picked by the rows, the
block length and, for GQA, the KV heads); a GQA score is that dot times
the scale, then the mask; an MLA score is ``(sum_R qe*c + sum_P qr*r) *
scale``, each sum in that order. A block's P.V sums run in XLA:CPU's
order for the kernel's second einsum (``pv_order``: a fused chain over
the block's lanes, for DeepSeek's R 512 in Eigen's pieces of 64 or 128
lanes added left to right, 4 strided partials at the JAX suite's narrow
widths). Block sums run left to right over a block's lanes; the row sum
and the accumulator fold block by block in table order (``exact``: ``l =
fma(l, alpha, bs)``, ``acc = fma(acc, alpha, pv)``, alpha from the running
max, as XLA fuses the reference's folds; the CORDIC impls ``acc = acc +
pv``). The row max is order-free. With ``-fmad=false`` (every fused
multiply-add written as one) kernel and plain agree bit for bit on every
impl. Where both the score order and the P.V order are mapped, the CORDIC
impls' outputs equal the JAX kernel's bit for bit (quantized pools
included); ``exact``'s differ only by its exponential (torch's and
CUDA's ``exp`` against XLA's own), within the reference's ATOL 2e-5.

Quantized pools (``gqa_decode(kv_quant="int8" | "q2_14")``): the pools hold
int8/int16 codes and ``k_scale_pool``/``v_scale_pool`` (N,1,KH,1) float32
the per-block per-head scales; each live block is dequantized by
``kv_quant.dequantize`` (the CORDIC linear-rotation multiply, exact in
every step but the sweep's adds, which both sides take in one order) and
then takes the ``kv_dtype`` round, so kernel and plain stay bit-equal.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.cordic_engine import functions as F
from repro_torch.cordic_engine.core import PAPER_FIXED, FixedConfig
from repro_torch.core import kv_quant as kvq
from repro_torch.core.numerics import fma
from repro_torch.cordic_engine.schedule import PAPER_SCHEDULE, MRSchedule
from repro_torch.kernels import build
from repro_torch.kernels import cost
from repro_torch.kernels.softmax_cordic import _lane_exp, _lane_probs

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


#: table columns the plain versions score and contract at once: bounds
#: their transients (MLA's float64 products: B * H * PLAIN_COLS * L * R)
PLAIN_COLS = 16


@dataclasses.dataclass(frozen=True)
class DotOrder:
    """How jitted XLA:CPU sums one decode score's dot (ROADMAP C.4), which
    the plain versions and the kernels replay. ``partials`` 1: one
    sequential chain of fused multiply-adds over the width; 2, 4 or 8:
    that many strided partials, partial t adding the products of elements
    t, t + partials, ... left to right as fused multiply-adds, then
    combined: "tree" adds neighbours, ((p0 + p1) + (p2 + p3)) + ...,
    "halve" the upper half onto the lower, ((p0 + p4) + (p2 + p6)) + ((p1
    + p5) + (p3 + p7)). ``mapped`` False: a geometry whose order was not
    found; it takes a chain, and its scores agree with the JAX kernel's to
    f32 round-off only. ``chunk`` (the P.V dots, ``pv_order``): the
    contraction runs in pieces of that many lanes from lane 0, each piece
    summed as above from 0 and added left to right onto the sum of the
    pieces before it (Eigen's k-blocks); 0: one piece."""
    partials: int
    combine: str = "tree"
    mapped: bool = True
    chunk: int = 0

    @property
    def code(self) -> int:
        """The kernels' order argument: 2 * partials + (combine == "halve")."""
        return 2 * self.partials + (self.combine == "halve")


#: block lengths the dot orders were mapped over
DOT_ORDER_MAX_L = 256


def dot_order(kind: str, rows: int, width: int, L: int, heads: int = 2) -> DotOrder:
    """The order jitted XLA:CPU takes for a decode kernel's score dot:
    ``gqa``, ``einsum("hgd,lhd->hgl")`` with rows = G, width = head_dim and
    ``heads`` = KH; ``mla``, ``einsum("hr,lr->hl")`` (and its rope twin)
    with rows = H, width = the contraction. Mapped on the JAX kernels run
    in interpret mode, eager and jitted, at every geometry the engine
    reaches (tests/test_torch_paged_attention.py); the choice depends on
    the dot's shape, not its values:

      one row (G 1, MLA H 1): GQA over two or more KV heads a chain at
          blocks of 1 and 4-128 lanes that are powers of two (at other
          lengths the first KV head's last lane takes another order now
          and then: unmapped); one KV head (a vector by a matrix, which
          LLVM vectorizes and the backend reorders) a chain up to width
          16, else unmapped, as MLA
      L 1: 8 partials, "halve" below 8 rows, "tree" at 8 and 16 rows
          (GQA over two or more KV heads), else unmapped
      L 2-3: a chain up to 3 rows, else 4 partials
      GQA, L 4-16: 4 partials; L >= 17: a chain
      MLA, L 4-24: 4 partials; then by ceil(L / 16) mod 4: 1 and 3 give 4
          partials, 2 gives 2, 0 a chain (L 25-32: 2, 33-48: 4, 49-64: a
          chain, 65-80: 4, ...)

    Past DOT_ORDER_MAX_L lanes a block is unmapped."""
    if kind not in ("gqa", "mla"):
        raise ValueError(f"unknown decode kind {kind!r}")
    chain, unmapped = DotOrder(1), DotOrder(1, mapped=False)
    if L > DOT_ORDER_MAX_L:
        return unmapped
    if rows == 1:
        if kind == "gqa" and heads == 1 and width <= 16:
            return chain
        ok = kind == "gqa" and heads > 1 and L in (1, 4, 8, 16, 32, 64, 128)
        return chain if ok else unmapped
    if L == 1:
        if (kind == "gqa" and heads == 1) or width % 8 or 8 < rows < 16 or rows > 16:
            return unmapped
        return DotOrder(8, "tree" if rows >= 8 else "halve")
    if L <= 3:
        return chain if rows <= 3 else DotOrder(4)
    if kind == "gqa":
        return DotOrder(4) if L <= 16 else chain
    if L <= 24:
        return DotOrder(4)
    return (DotOrder(4), DotOrder(2), DotOrder(4), chain)[(-(-L // 16) - 1) % 4]


def pv_order(kind: str, rows: int, width: int, L: int, heads: int = 2) -> DotOrder:
    """The order jitted XLA:CPU takes for a decode kernel's P.V dot, the
    contraction over a block's L lanes: ``gqa``, ``einsum("hgl,lhd->hgd")``
    with rows = G, width = head_dim and ``heads`` = KH; ``mla``,
    ``einsum("hl,lr->hr")`` with rows = H, width = the latent rank R.
    Mapped like ``dot_order`` (on jitted einsums at every L of 1-256 and on
    the JAX kernels in interpret mode, eager and jitted:
    tests/test_torch_paged_attention.py), and like it a function of the
    shape alone; its own map, since the output is hd or R wide here:

      L 1: one product (every order agrees)
      GQA, head_dim 64 or more (every arch's): a fused chain at every L
          (but G 12 over 8 KV heads at L 170, where some element takes
          another order: unmapped)
      MLA, R 512 (DeepSeek's kv_lora_rank) over two or more heads: Eigen's
          blocked product: a chain up to L 64, then chains of 64 lanes
          (L + H <= 256) or 128 lanes (past it), added left to right
      MLA, R 32 or 64, or one head (a vector by a matrix): a chain
      head_dim 8 / R 16 (the JAX suite's geometries): a chain at L 2-3, 4
          strided partials as a tree at L a multiple of 4, else unmapped
      GQA head_dim 16 or 32 over one query row: a chain up to L 48

    Other widths, and past DOT_ORDER_MAX_L lanes, are unmapped (a chain)."""
    if kind not in ("gqa", "mla"):
        raise ValueError(f"unknown decode kind {kind!r}")
    chain, unmapped = DotOrder(1), DotOrder(1, mapped=False)
    if L > DOT_ORDER_MAX_L:
        return unmapped
    if L == 1:
        return chain
    if width <= 16 and (width == 8 if kind == "gqa" else width == 16):
        if L <= 3:
            return chain
        return DotOrder(4) if L % 4 == 0 else unmapped
    if kind == "gqa":
        if width >= 64:
            return unmapped if (rows, heads, L) == (12, 8, 170) else chain
        return chain if rows == 1 and width in (16, 32) and L <= 48 else unmapped
    if rows == 1 or width in (32, 64):
        return chain
    if width == 512:
        return chain if L <= 64 else DotOrder(1, chunk=64 if L + rows <= 256 else 128)
    return unmapped


def _xla_pv(p: torch.Tensor, v: torch.Tensor, order: DotOrder) -> torch.Tensor:
    """sum_l p[..., l] * v[..., l, :] (p (..., L) and v (..., L, W)
    broadcast) in ``order``: each fused multiply-add in float64 and rounded
    once, as ``_xla_dot``; the pieces of ``order.chunk`` lanes added left to
    right in float32."""
    prod = p.double()[..., :, None] * v.double()
    L, P = prod.shape[-2], order.partials
    total = None
    for c0 in range(0, L, order.chunk or L):
        piece = prod[..., c0:c0 + (order.chunk or L), :]
        n = piece.shape[-2]
        if n % P:                    # a +0 product leaves a partial's bits
            piece = torch.cat([piece, piece.new_zeros(piece.shape[:-2] + (P - n % P,)
                                                      + piece.shape[-1:])], dim=-2)
        piece = piece.unflatten(-2, (-1, P))               # (..., n / P, P, W)
        part = torch.zeros(piece.shape[:-3] + piece.shape[-2:], dtype=torch.float32,
                           device=p.device)
        for j in range(piece.shape[-3]):
            part = (part.double() + piece[..., j, :, :]).to(torch.float32)
        while part.shape[-2] > 1:
            h = part.shape[-2] // 2
            part = (part[..., :h, :] + part[..., h:, :] if order.combine == "halve"
                    else part[..., 0::2, :] + part[..., 1::2, :])
        total = part[..., 0, :] if total is None else total + part[..., 0, :]
    return total


def _xla_dot(q: torch.Tensor, k: torch.Tensor, order: DotOrder) -> torch.Tensor:
    """sum(q * k) over the last axis (q and k broadcast) in ``order``: each
    fused multiply-add in float64 and rounded once (a float32 product is
    exact there), as ``kernels/cordic_act.py``'s ``_fma_*`` do."""
    prod = q.double() * k.double()
    n, P = prod.shape[-1], order.partials
    prod = prod.reshape(prod.shape[:-1] + (n // P, P))
    part = torch.zeros(prod.shape[:-2] + (P,), dtype=torch.float32, device=q.device)
    for j in range(n // P):
        part = (part.double() + prod[..., j, :]).to(torch.float32)
    while part.shape[-1] > 1:
        h = part.shape[-1] // 2
        part = (part[..., :h] + part[..., h:] if order.combine == "halve"
                else part[..., 0::2] + part[..., 1::2])
    return part[..., 0]


def _live_columns(tables, k_len, L: int):
    """The walk's table columns, those some row still covers (c * L <
    k_len): their block ids (B, C), each row's live columns (B, C) and
    valid lanes (B, C, L)."""
    klen = k_len.to(torch.int64)
    C = min(tables.shape[1], max(0, -(-int(klen.max()) // L))) if klen.numel() else 0
    lane = torch.arange(C * L, device=tables.device).view(C, L)
    return (tables[:, :C].to(torch.int64), lane[None, :, 0] < klen[:, None],
            lane[None] < klen[:, None, None])


def _seq_sum(x: torch.Tensor) -> torch.Tensor:
    """Left-to-right float32 sum over the last axis (keepdim): a block's
    sum, in the order the decode kernels take it."""
    acc = torch.zeros(x.shape[:-1] + (1,), dtype=x.dtype, device=x.device)
    for i in range(x.shape[-1]):
        acc = acc + x[..., i:i + 1]
    return acc


def _block_softmax(s, live, impl, contract, width, sched, cfg):
    """The softmax accumulation of both decodes (the JAX ``_pass_update``
    over the block walk) on every live lane's masked score s (lead..., C,
    L); live (broadcastable to lead..., C): the row covers the column;
    contract(p, c0, c1) -> the weighted-value sum of each block of columns
    c0..c1 (lead..., c1 - c0, width), p (lead..., c1 - c0, L). ``exact``:
    the online (flash-decoding) recurrence, block by block, each fold a
    fused multiply-add; the CORDIC
    impls: the row max, the CORDIC e^u of every lane and the block sums
    folded into the row sum in table order, then the lane-exact
    probabilities, whose blocks' P.V sums fold in table order
    (``cordic_fixed`` through the function library, which takes the
    reference's default schedules). Returns the (lead..., width) output."""
    lead, C = s.shape[:-2], s.shape[-2]
    m = torch.full(lead + (1,), NEG_INF, dtype=torch.float32, device=s.device)
    l_sum = torch.zeros_like(m)
    acc = torch.zeros(lead + (width,), dtype=torch.float32, device=s.device)
    if impl == "exact":
        for c in range(C):
            lv, sc = live[..., c:c + 1], s[..., c, :]
            m_new = torch.maximum(m, sc.amax(dim=-1, keepdim=True))
            alpha = torch.exp(m - m_new)
            ef = torch.exp(sc - m_new)
            # XLA fuses both folds of the reference (_pass_update) into a
            # multiply-add
            l_sum = torch.where(lv, fma(l_sum, alpha, _seq_sum(ef)), l_sum)
            acc = torch.where(lv, fma(acc, alpha, contract(ef[..., None, :], c, c + 1)[..., 0, :]),
                              acc)
            m = torch.where(lv, m_new, m)
        return acc / l_sum
    if C:                                # the row max: order-free
        m = torch.maximum(m, s.amax(dim=(-2, -1))[..., None])
    u = s - m[..., None]
    e = (F.exp_fixed(u, cfg=cfg) if impl == "cordic_fixed"
         else _lane_exp(u, sched, cfg))
    bs = _seq_sum(e)
    for c in range(C):
        l_sum = torch.where(live[..., c:c + 1], l_sum + bs[..., c, :], l_sum)
    if impl == "cordic_fixed":
        pr = F.divide_fixed(e, l_sum[..., None], cfg=cfg)
    else:
        pr = _lane_probs(u, l_sum[..., None], sched, cfg)
    for c0 in range(0, C, PLAIN_COLS):
        c1 = min(C, c0 + PLAIN_COLS)
        pv = contract(pr[..., c0:c1, :], c0, c1)
        for c in range(c0, c1):
            acc = torch.where(live[..., c:c + 1], acc + pv[..., c - c0, :], acc)
    return acc


def _kernel_sched(impl: str, sched: MRSchedule) -> MRSchedule:
    """The schedule whose ROM the kernel gets: ``cordic_fixed`` runs
    ``exp_fixed``/``divide_fixed`` with their default schedules
    (HYP_ROTATION, LIN_VECTORING: PAPER_SCHEDULE's two halves), whatever
    ``sched`` the caller passed, as the reference does."""
    return PAPER_SCHEDULE if impl == "cordic_fixed" else sched


def _quant_args(k_pool, kv_quant, k_scale_pool, v_scale_pool, kv_dtype):
    """(spec or None, kv_dtype) of a decode call, validated as the JAX
    kernel does: ``kv_quant`` and both scale pools come together (checked
    before the kv_dtype resolution, so an integer pool without kv_quant
    names the real mismatch); under quantization kv_dtype defaults to
    float32, else to the pool's dtype."""
    spec = kvq.spec_for(kv_quant)
    if (spec is not None) != (k_scale_pool is not None
                              and v_scale_pool is not None):
        raise ValueError(
            f"kv_quant and the scale pools come together: kv_quant={kv_quant!r} "
            f"with k_scale_pool {'set' if k_scale_pool is not None else 'missing'}")
    kvd = canonical_kv_dtype(kv_dtype)
    if kvd is None:
        kvd = torch.float32 if spec is not None else canonical_kv_dtype(k_pool.dtype)
    return spec, kvd


def gqa_decode_plain(q, k_pool, v_pool, tables, k_len, *, scale: float,
                     softmax_impl: str = "exact", kv_dtype=None,
                     kv_quant: str = "none", k_scale_pool=None,
                     v_scale_pool=None, sched: MRSchedule = PAPER_SCHEDULE,
                     cfg: FixedConfig = PAPER_FIXED) -> torch.Tensor:
    """Plain PyTorch version of the block-walking decode (same block order,
    same sums as the kernel)."""
    impl = _impl(softmax_impl)
    spec, kvd = _quant_args(k_pool, kv_quant, k_scale_pool, v_scale_pool,
                            kv_dtype)

    B, KH, G, hd = q.shape
    L = k_pool.shape[1]
    blks, live, valid = _live_columns(tables, k_len, L)

    def blocks(pool, scales, c0, c1):
        blk = blks[:, c0:c1]
        vals = (pool[blk] if spec is None
                else kvq.dequantize(pool[blk], spec, scales[blk]))
        return vals.to(kvd).to(torch.float32)                  # (B,C',L,KH,hd)

    def pv(p, c0, c1):
        """p (B,KH,G,C',L) . V -> (B,KH,G,C',hd), each block's sums in
        ``pv_order``."""
        v = blocks(v_pool, v_scale_pool, c0, c1).permute(0, 3, 1, 2, 4)
        return _xla_pv(p, v[:, :, None], pv_ord)

    qf = q.to(torch.float32)[:, :, :, None, :]                  # (B,KH,G,1,hd)
    order = dot_order("gqa", G, hd, L, heads=KH)
    pv_ord = pv_order("gqa", G, hd, L, heads=KH)
    C = blks.shape[1]
    s = torch.cat([_xla_dot(qf, blocks(k_pool, k_scale_pool, c0, min(C, c0 + PLAIN_COLS))
                            .flatten(1, 2).permute(0, 2, 1, 3)[:, :, None], order)
                   for c0 in range(0, C, PLAIN_COLS)], dim=-1) if C else \
        torch.zeros((B, KH, G, 0), device=q.device)
    s = s.view(B, KH, G, C, L) * scale
    s = torch.where(valid[:, None, None], s, torch.full_like(s, NEG_INF))
    return _block_softmax(s, live[:, None, None], impl, pv, hd, sched, cfg)


#: pool storage codes of the C interface: float32 pools, int8 and int16 codes
POOL_CODE = {torch.float32: 0, torch.int8: 1, torch.int16: 2}

#: blocks of one score / pv CTA at most (csrc kMaxChunk); a slot's table
#: is cut into at most CTAS_PER_SLOT chunks until that cap
MAX_CHUNK, CTAS_PER_SLOT = 4, 64
#: heads of an MLA score CTA: fewer at short tables (more CTAs), all of a
#: group at long ones (the latent staged once per group)
MLA_SCORE_HEADS = (4, 16)
#: lanes of a row a softmax CTA holds in shared memory at once (8192: a
#: row of up to 8192 keys is staged once; a longer one passes through in
#: tiles, once per softmax pass)
SOFTMAX_TILE_LANES = 8192
#: the kernels' fixed layout (csrc/paged_decode.cu): value columns of an
#: MLA pv CTA and of a fold CTA, the padding of an MLA score CTA's staged
#: latent and rope rows. The
#: entry points check the workspace they are given against their own size
#: (csrc ``workspace_floats``), and a launch past the shared memory limit
#: fails, so a drift between the two sides raises rather than writes out
#: of bounds.
_PV_COLS, _FOLD_COLS, _PAD = 128, 128, 4
#: dynamic shared memory a CTA may have on Hopper (bytes)
_SMEM_MAX = 232448


@dataclasses.dataclass(frozen=True)
class DecodePlan:
    """The four launches of one decode call and its workspace, from the
    static shapes alone (no host read of ``k_len``): each grid (x, y, z),
    the blocks of a score / pv CTA, the heads of a score CTA (GQA: the G
    rows of a kv head), the blocks a softmax CTA holds in shared memory at
    once, the workspace in float32 words, each phase's dynamic shared
    memory in bytes, the score dots' order (``dot_order``) and the P.V
    dots' (``pv_order``). Score and
    pv CTAs past a slot's live blocks exit at once on the card."""
    score_grid: Tuple[int, int, int]
    chunk: int
    score_heads: int
    softmax_tile: int
    softmax_grid: Tuple[int, int, int]
    pv_grid: Tuple[int, int, int]
    fold_grid: Tuple[int, int, int]
    workspace_floats: int
    smem: Tuple[int, int, int, int]
    order: DotOrder = DotOrder(1)
    pv_order: DotOrder = DotOrder(1)

    @property
    def ctas(self) -> Tuple[int, int, int, int]:
        """CTAs launched by each phase (score, softmax, pv, fold)."""
        return tuple(math.prod(g) for g in (self.score_grid, self.softmax_grid,
                                            self.pv_grid, self.fold_grid))

    def live_score_ctas(self, k_len: Sequence[int], L: int) -> int:
        """Score CTAs that find live blocks for these lengths (a report;
        the wrappers never read ``k_len`` on the host)."""
        M = self.score_grid[0] * self.chunk
        return self.score_grid[1] * sum(
            -(-min(M, -(-max(int(k), 1) // L)) // self.chunk) for k in k_len)


def _chunk(M: int) -> int:
    return min(MAX_CHUNK, max(1, -(-M // CTAS_PER_SLOT)))


def _workspace(rows: int, M: int, L: int, width: int) -> int:
    """Scores / lane weights, the pass-1 codes and exponents (rows, M*L)
    each, the exact impl's block factors (rows, M) and row sums (rows,),
    and each block's P.V sums (rows, M, width)."""
    return rows * (3 * M * L + M + 1 + M * width)


def _softmax_tile(L: int, M: int, tile_lanes: Optional[int]) -> int:
    """Blocks of a softmax tile: ``tile_lanes`` (default SOFTMAX_TILE_LANES)
    lanes, at least one block, at most the table."""
    lanes = SOFTMAX_TILE_LANES if tile_lanes is None else tile_lanes
    return min(M, max(1, lanes // L))


def _checked(plan: DecodePlan, what: str, widths) -> DecodePlan:
    if any(w % 4 for w in widths):
        raise ValueError(f"{what}: widths {widths} must be multiples of 4 "
                         "(the kernels load 16 bytes at a time)")
    if max(plan.smem) > _SMEM_MAX:
        raise ValueError(f"{what}: a CTA would need {max(plan.smem)} bytes of "
                         f"shared memory (at most {_SMEM_MAX}); plan {plan}")
    return plan


@functools.lru_cache(maxsize=256)
def gqa_plan(B: int, KH: int, G: int, hd: int, L: int, M: int,
             tile_lanes: Optional[int] = None) -> DecodePlan:
    """The launches of ``gqa_decode`` for q (B,KH,G,hd), L-lane blocks and
    M-wide tables; ``tile_lanes`` sets the softmax tile (default
    SOFTMAX_TILE_LANES). Cached: a serve asks for the same plan every
    layer of every step."""
    chunk = _chunk(M)
    tile = _softmax_tile(L, M, tile_lanes)
    blocks = (-(-M // chunk), KH, B)
    return _checked(DecodePlan(
        score_grid=blocks, chunk=chunk, score_heads=G, softmax_tile=tile,
        softmax_grid=(KH * G, B, 1),
        pv_grid=blocks, fold_grid=(KH * G * -(-hd // _FOLD_COLS), B, 1),
        workspace_floats=_workspace(B * KH * G, M, L, hd),
        smem=(4 * (G + chunk * L) * (hd + 1), 4 * (tile * L + 3 * M),
              4 * chunk * L * (hd + G), 4 * M),
        order=dot_order("gqa", G, hd, L, heads=KH),
        pv_order=pv_order("gqa", G, hd, L, heads=KH)),
        "gqa_decode", (hd,))


@functools.lru_cache(maxsize=256)
def mla_plan(B: int, H: int, R: int, P: int, L: int, M: int,
             tile_lanes: Optional[int] = None) -> DecodePlan:
    """The launches of ``mla_decode`` for q_eff (B,H,R), q_rope (B,H,P),
    L-lane blocks and M-wide tables; ``tile_lanes`` as in ``gqa_plan``."""
    chunk = _chunk(M)
    tile = _softmax_tile(L, M, tile_lanes)
    hs = min(H, MLA_SCORE_HEADS[chunk > 1])
    order = dot_order("mla", H, math.gcd(R, P), L)
    return _checked(DecodePlan(
        score_grid=(-(-M // chunk), -(-H // hs), B), chunk=chunk, score_heads=hs,
        softmax_tile=tile, softmax_grid=(H, B, 1),
        pv_grid=(-(-M // chunk), -(-R // _PV_COLS), B),
        fold_grid=(H * -(-R // _FOLD_COLS), B, 1),
        workspace_floats=_workspace(B * H, M, L, R),
        smem=(4 * (hs * (R + P) + L * (R + P + 2 * _PAD)
                   + 2 * hs * L * (order.partials + 1)),
              4 * (tile * L + 3 * M),
              4 * chunk * L * (_PV_COLS + H), 4 * M),
        order=order, pv_order=pv_order("mla", H, R, L)),
        "mla_decode", (R, P))


def _check_operands(what, device, ts, pools) -> None:
    """Every operand contiguous on one device; the pools 16-byte aligned
    (the kernels load four elements at a time)."""
    if any(t.device != device or not t.is_contiguous() for t in ts):
        raise ValueError(f"{what}: inputs must be contiguous on one device")
    if any(t.data_ptr() % 16 for t in pools):
        raise ValueError(f"{what}: the pools must be 16-byte aligned")


@cost.booked("gqa_decode", lambda q, k_pool, v_pool, tables, k_len, softmax_impl="exact",
             sched=PAPER_SCHEDULE, k_scale_pool=None, **_: cost.gqa_decode_work(
                 q, k_pool, tables, k_len, _impl(softmax_impl), sched, k_scale_pool))
def gqa_decode(q, k_pool, v_pool, tables, k_len, *, scale: float,
               softmax_impl: str = "exact", kv_dtype=None,
               kv_quant: str = "none", k_scale_pool=None, v_scale_pool=None,
               sched: MRSchedule = PAPER_SCHEDULE,
               cfg: FixedConfig = PAPER_FIXED,
               plan: Optional[DecodePlan] = None) -> torch.Tensor:
    """Paged GQA decode attend.

    q (B,KH,G,hd) float32/bfloat16; pools (N,L,KH,hd) float32 (block 0 is
    scratch), or under ``kv_quant`` int8/int16 codes with (N,1,KH,1)
    float32 scale pools; tables (B,M) int32; k_len (B,) int32 >= 1.
    ``kv_dtype`` is the storage-rounding cast replayed on each K/V block
    (None: the pool's dtype, float32 under kv_quant); on the card,
    quantized pools take a kv_dtype equal to q's dtype. ``plan``: the
    launches on the card (default ``gqa_plan`` of the shapes; one with a
    smaller softmax tile gives the same output). Returns (B,KH,G,hd)
    float32.
    """
    impl = _impl(softmax_impl)
    spec, kvd = _quant_args(k_pool, kv_quant, k_scale_pool, v_scale_pool,
                            kv_dtype)
    if q.device.type == "cpu":
        return gqa_decode_plain(q, k_pool, v_pool, tables, k_len, scale=scale,
                                softmax_impl=impl, kv_dtype=kvd,
                                kv_quant=kv_quant, k_scale_pool=k_scale_pool,
                                v_scale_pool=v_scale_pool, sched=sched, cfg=cfg)
    B, KH, G, hd = q.shape
    N, L = k_pool.shape[:2]
    M = tables.shape[1]
    if q.dtype not in build.DTYPE_CODE or kvd not in build.DTYPE_CODE:
        raise TypeError(f"gqa_decode: q {q.dtype} / kv_dtype {kvd} not "
                        "supported (float32 or bfloat16)")
    pool_dtype = torch.float32 if spec is None else spec.code_dtype
    if spec is not None and kvd != q.dtype:
        raise TypeError(f"gqa_decode: the kernel takes quantized pools with "
                        f"kv_dtype equal to the query dtype, got q {q.dtype} / "
                        f"kv_dtype {kvd}")
    if k_pool.dtype != pool_dtype or v_pool.dtype != pool_dtype:
        raise TypeError(f"gqa_decode: kv_quant={kv_quant!r} takes "
                        f"{pool_dtype} pools, got {k_pool.dtype}/{v_pool.dtype}")
    if k_pool.shape != (N, L, KH, hd) or v_pool.shape != k_pool.shape:
        raise ValueError(f"gqa_decode: pools {tuple(k_pool.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if tables.dtype != torch.int32 or k_len.dtype != torch.int32 \
            or tables.shape[0] != B or k_len.shape != (B,):
        raise ValueError("gqa_decode: tables (B,M) and k_len (B,) are int32")
    ts = [q, k_pool, v_pool, tables, k_len]
    if spec is not None:
        for sp in (k_scale_pool, v_scale_pool):
            if sp.dtype != torch.float32 or sp.shape != (N, 1, KH, 1):
                raise ValueError(f"gqa_decode: scale pools are ({N}, 1, {KH}, 1) "
                                 f"float32, got {tuple(sp.shape)} {sp.dtype}")
        ts += [k_scale_pool, v_scale_pool]
    _check_operands("gqa_decode", q.device, ts, (k_pool, v_pool))
    plan = plan or gqa_plan(B, KH, G, hd, L, M)
    out = torch.empty((B, KH, G, hd), dtype=torch.float32, device=q.device)
    ws = torch.empty(plan.workspace_floats, dtype=torch.float32, device=q.device)
    if q.device.type == "meta":
        return out                       # the dry run: checked, not launched
    rc = build.library("paged_decode").paged_gqa_decode(
        q.data_ptr(), build.DTYPE_CODE[q.dtype], k_pool.data_ptr(),
        v_pool.data_ptr(), POOL_CODE[pool_dtype],
        0 if spec is None else k_scale_pool.data_ptr(),
        0 if spec is None else v_scale_pool.data_ptr(),
        1.0 if spec is None else float(spec.fmt.resolution),
        tables.data_ptr(), k_len.data_ptr(), out.data_ptr(), ws.data_ptr(),
        ws.numel(), B, KH, G, hd, L, M, plan.chunk, plan.softmax_tile, plan.order.code,
        plan.pv_order.code, plan.pv_order.chunk, float(scale), IMPLS.index(impl), build.DTYPE_CODE[kvd],
        build.params_ptr(_kernel_sched(impl, sched), cfg), build.stream_ptr(q))
    build.check(rc, "gqa_decode")
    build.count("gqa_decode")
    return out


# ---------------------------------------------------------------------------
# MLA decode (absorbed form)
# ---------------------------------------------------------------------------
def mla_decode_plain(q_eff, q_rope, c_pool, r_pool, tables, k_len, *,
                     scale: float, softmax_impl: str = "exact",
                     sched: MRSchedule = PAPER_SCHEDULE,
                     cfg: FixedConfig = PAPER_FIXED) -> torch.Tensor:
    """Plain PyTorch version of the block-walking MLA decode (same block
    order, same sums as the kernel)."""
    impl = _impl(softmax_impl)
    B, H, R = q_eff.shape
    L = c_pool.shape[1]
    qe = q_eff.to(torch.float32)
    qr = q_rope.to(torch.float32)
    blks, live, valid = _live_columns(tables, k_len, L)

    def latent(c0, c1):
        return c_pool[blks[:, c0:c1]].to(torch.float32)        # (B,C',L,R)

    def pv(p, c0, c1):
        """p (B,H,C',L) . c -> (B,H,C',R), each block's sums in
        ``pv_order``."""
        return _xla_pv(p, latent(c0, c1)[:, None], pv_ord)

    order = dot_order("mla", H, math.gcd(R, qr.shape[-1]), L)
    pv_ord = pv_order("mla", H, R, L)
    C = blks.shape[1]
    parts = []
    for c0 in range(0, C, PLAIN_COLS):
        c1 = min(C, c0 + PLAIN_COLS)
        rb = r_pool[blks[:, c0:c1]].to(torch.float32)           # (B,C',L,P)
        parts.append(_xla_dot(qe[:, :, None], latent(c0, c1).flatten(1, 2)[:, None], order)
                     + _xla_dot(qr[:, :, None], rb.flatten(1, 2)[:, None], order))
    s = torch.cat(parts, dim=-1) if parts else torch.zeros((B, H, 0), device=qe.device)
    s = s.view(B, H, C, L) * scale
    s = torch.where(valid[:, None], s, torch.full_like(s, NEG_INF))
    return _block_softmax(s, live[:, None], impl, pv, R, sched, cfg)


@cost.booked("mla_decode", lambda q_eff, q_rope, c_pool, r_pool, tables, k_len,
             softmax_impl="exact", sched=PAPER_SCHEDULE, **_: cost.mla_decode_work(
                 q_eff, q_rope, c_pool, tables, k_len, _impl(softmax_impl), sched))
def mla_decode(q_eff, q_rope, c_pool, r_pool, tables, k_len, *, scale: float,
               softmax_impl: str = "exact",
               sched: MRSchedule = PAPER_SCHEDULE,
               cfg: FixedConfig = PAPER_FIXED,
               plan: Optional[DecodePlan] = None) -> torch.Tensor:
    """Paged absorbed-form MLA decode: scores against the compressed latent
    and the shared rope key, output accumulated in the latent space.

    q_eff (B,H,R) absorbed queries (q_nope @ wk_b), q_rope (B,H,P), float32
    or bfloat16; c_pool (N,L,R) and r_pool (N,L,P) float32 (block 0 is
    scratch); tables (B,M) int32; k_len (B,) int32 >= 1. Returns (B,H,R)
    float32 latent outputs (the wv_b projection stays outside, as in
    models.attention). ``plan``: as in ``gqa_decode`` (default
    ``mla_plan``)."""
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
    _check_operands("mla_decode", q_eff.device, ts, (c_pool, r_pool))
    plan = plan or mla_plan(B, H, R, P, L, M)
    out = torch.empty((B, H, R), dtype=torch.float32, device=q_eff.device)
    ws = torch.empty(plan.workspace_floats, dtype=torch.float32,
                     device=q_eff.device)
    if q_eff.device.type == "meta":
        return out                       # the dry run: checked, not launched
    rc = build.library("paged_decode").paged_mla_decode(
        q_eff.data_ptr(), q_rope.data_ptr(), build.DTYPE_CODE[q_eff.dtype],
        c_pool.data_ptr(), r_pool.data_ptr(), tables.data_ptr(),
        k_len.data_ptr(), out.data_ptr(), ws.data_ptr(), ws.numel(), B, H, R, P,
        L, M, plan.score_heads, plan.chunk, plan.softmax_tile, plan.order.code,
        plan.pv_order.code, plan.pv_order.chunk, float(scale), IMPLS.index(impl),
        build.params_ptr(_kernel_sched(impl, sched), cfg),
        build.stream_ptr(q_eff))
    build.check(rc, "mla_decode")
    build.count("mla_decode")
    return out
