"""GQA and MLA attention (port of ``repro/models/attention.py``).

Prefill and no-cache passes attend over dense shapes (``causal_attention``,
``_attend_rows``); a paged decode step either gathers its table
(``paged_attend_impl="gather"``) or walks its live blocks with a CUDA
decode kernel (``"pallas"``, kernels/paged_attention.py): ``gqa_decode``
for GQA, ``mla_decode`` for MLA (absorbed form against the compressed
latent and rope-key pools).

The paged KV plane is updated in place: ``_pool_write`` scatters new K/V
into the global pools with ``index_put_`` where the JAX code returns new
pools (``paged_pool_view``/``paged_pool_merge`` have no counterpart). A
layer's cache is a dict {"k_pool", "v_pool", "tables", "lens"} (GQA) or
{"c_kv_pool", "k_rope_pool", "tables", "lens"} (MLA); every layer shares
one ``tables`` and one ``lens`` tensor, and the model advances ``lens``
once per apply (models/transformer.py).

Under ``cfg.kv_quant`` ("int8", "q2_14"; core/kv_quant.py) the GQA pools
hold integer codes and two more leaves, "k_scale_pool" and
"v_scale_pool", hold each block's per-head float32 scale:
``_pool_write_quant`` quantizes at write, the gather attend dequantizes
through ``_pool_gather_dequant``, the decode kernel inside its block walk.

The dense KV plane (``kv_impl="dense"``) holds one max_len buffer per
slot: {"k", "v", "idx"} (GQA) or {"c_kv", "k_rope", "idx"} (MLA), float32
as the JAX engine allocates them, with one (slots,) position vector
``idx`` shared by every layer. ``_dense_write`` writes the S new positions
of each row in place at its own ``idx`` (clamped into the buffer, as
``dynamic_update_slice``), and the attend is the paged gather path's with
the buffer in place of the gathered table: ``_attend_rows`` with a per-row
``k_len`` for prefill and GQA decode, ``_mla_absorbed_decode`` for MLA
decode. One batched decode serves every slot, where the JAX engine
``vmap``s a batch-1 decode over them; each row computes what its batch-1
decode does.

``cfg.pad_heads_to`` pads the KV heads up to a multiple (``padded_heads``)
and the query heads follow as H' = KH' * G, so head counts divide a wide
model axis; leaves, caches and pools take the padded counts. Padded heads
whose k/v projections are zero attend over zero values and add nothing
through ``wo``, so the forward is exact.

``cfg.score_dtype="bf16_mxu"`` keeps the attend's operands in their storage
dtype and accumulates in float32 (the JAX ``preferred_element_type``):
a bfloat16 product is exact in float32, so the port upcasts the operands
and multiplies in float32 (TF32 off on the card), and casts the
probabilities to the values' dtype before P.V. The paged decode kernels
score in float32 only and refuse it.

Under tensor parallelism (distributed/sharding.py) a rank holds its slice
of the heads: it attends with its query heads (and its KV heads, or, when
the KV heads do not divide tp, the whole KV heads' ones its query heads
read), and its ``wo`` product is a partial sum, reduced over the model
axis.

``cfg.kv_shard="seq_model"`` cuts the dense caches by position instead
(``shd.seq_cut``; the JAX flash-decode sequence parallelism): rank r holds
the positions [r T/tp, (r+1) T/tp) of every row with every KV head (GQA's
k/v, MLA's c_kv/k_rope, Zamba2's shared block). The parameters keep their
head cut. A step (``_gqa_seq_apply``, ``_mla_seq_apply``) gathers the
queries (and the new K/V, or MLA's absorbed queries) over the heads,
writes each new position on the rank that owns it, scores every head
against the rank's positions with the mask in global positions, takes the
split softmax (``_split_softmax``: the max reduced, for the CORDIC
datapaths the 32-lane window sums gathered, so the probabilities are the
whole row's bit for bit), sums the rank's P.V partial over the model axis
in float32, and keeps its own heads for the row-parallel ``wo``. MLA's
prefill decompresses the rank's positions with every head's ``wkv_b``
(gathered for the step), as tp 1 decompresses the whole buffer.

Under the heads cut, a batch the data axes do not divide is whole on every
data rank and its dense caches' positions are cut over the data axes
(``kv_shard`` resolved to "seq_data", ``shd.seq_axis``; the JAX default
``cache_spec``): data rank d holds the positions [d T/dp, (d+1) T/dp) of
its model rank's KV heads. The step writes each new position on its owner,
scores the rank's own heads against its span, takes the split softmax and
sums the P.V partial over the data group (``_seq_attend`` with ``axis=
"data"``; no head gather), and goes on through the row-parallel ``wo``
over the model group as the heads cut does.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
from torch import nn

from repro_torch.cordic_engine import functions as F
from repro_torch.core import kv_quant as kvq
from repro_torch.core import numerics as nx
from repro_torch.distributed import sharding as shd
from repro_torch.kernels import ops as kops
from repro_torch.kernels import softmax_cordic as SM
from repro_torch.models import common as cm

NEG_INF = -1e30


def _softmax_fn(impl: Optional[str]):
    """Row softmax selected by cfg.softmax_impl.

    "exact"         exp(x - max) / sum, as jax.nn.softmax computes it
    "cordic_pallas" the CORDIC softmax kernel (kernels/softmax_cordic.py)
    "cordic_fixed"  the same Q2.14 math in plain torch (functions.softmax)
    """
    if impl in (None, "exact"):
        def exact(s, axis=-1):
            e = torch.exp(s - s.amax(dim=axis, keepdim=True))
            return e / e.sum(dim=axis, keepdim=True)
        return exact
    if impl == "cordic_pallas":
        return lambda s, axis=-1: kops.softmax(s, axis)
    if impl == "cordic_fixed":
        return lambda s, axis=-1: F.softmax(s, axis)
    raise ValueError(f"unknown softmax_impl {impl!r}")


def _split_softmax(impl: Optional[str], s: torch.Tensor, mesh,
                   axis: str = "model") -> torch.Tensor:
    """``_softmax_fn(impl)`` over the last axis of rows whose positions are
    cut over ``mesh``'s ``axis`` ("model" or "data"), ``s`` (..., span)
    float32 this rank's span (spans in rank order). The max is reduced exactly; "exact" sums
    its partial sums over the axis (another order than the whole row's);
    the CORDIC datapaths gather the spans' 32-lane window sums and finish
    the row sum's later levels on every rank, which is the whole row's
    order (kernels/softmax_cordic.py), so each probability is the whole
    row's bit for bit."""
    shape = s.shape
    x = s.reshape(-1, shape[-1]).contiguous()
    if impl in (None, "exact"):
        m = shd.reduce_(x.amax(dim=-1, keepdim=True), mesh, axis, op="max")
        e = torch.exp(x - m)
        return (e / shd.reduce_(e.sum(dim=-1, keepdim=True), mesh, axis)).view(shape)
    if impl == "cordic_pallas":
        m = shd.reduce_(SM.softmax_split_max(x), mesh, axis, op="max")
        w = torch.cat(shd.all_gather(SM.softmax_split_windows(x, m), mesh, axis), dim=-1)
        return SM.softmax_split_probs(x, m, w).view(shape)
    if impl == "cordic_fixed":
        m = shd.reduce_(x.amax(dim=-1, keepdim=True), mesh, axis, op="max")
        e = F.exp_fixed(x - m)
        w = torch.cat(shd.all_gather(nx.window_sums(e), mesh, axis), dim=-1)
        return F.divide_fixed(e, nx.xla_sum(w, -1, keepdim=True)).view(shape)
    raise ValueError(f"unknown softmax_impl {impl!r}")


SCORE_DTYPES = ("f32", "bf16_mxu")


def _mxu(score_dtype: str) -> bool:
    """True for "bf16_mxu" (storage-dtype operands, float32 accumulation),
    False for "f32" (operands cast to float32)."""
    if score_dtype not in SCORE_DTYPES:
        raise ValueError(f"unknown score_dtype {score_dtype!r}, not in {SCORE_DTYPES}")
    return score_dtype == "bf16_mxu"


def _scores(q, k, scale, score_dtype, ops=cm.LIBRARY):
    """(B,S,KH,G,D) x (B,T,KH,D) -> (B,KH,G,S,T) float32 scores. Both
    score dtypes multiply in float32: for bf16_mxu the float32 image of a
    bfloat16 operand is exact, and so are its products."""
    _mxu(score_dtype)
    return ops.einsum("bqhgd,bkhd->bhgqk", q.float(), k.float()) * scale


def _pv(p, v, score_dtype, ops=cm.LIBRARY):
    """Probabilities (B,KH,G,S,T) float32 against values (B,T,KH,Dv): under
    bf16_mxu the probabilities are cast to v's dtype first."""
    if _mxu(score_dtype):
        p = p.to(v.dtype)
    return ops.einsum("bhgqk,bkhd->bqhgd", p.float(), v.float())


# ---------------------------------------------------------------------------
# Causal attention cores
# ---------------------------------------------------------------------------
def _attend_block(q, k, v, q_pos, k_pos, scale, score_dtype: str = "f32",
                  softmax_impl: str = "exact"):
    """q (B,c,KH,G,D), k/v (B,T,KH,D) -> (B,c,KH,G,D), full-row softmax."""
    s = _scores(q, k, scale, score_dtype)
    mask = k_pos[None, :] <= q_pos[:, None]                    # (c, T)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = _softmax_fn(softmax_impl)(s, axis=-1)
    return _pv(p, v, score_dtype)


def causal_attention(q, k, v, *, q_offset=0, k_len=None, chunk: int = 1024,
                     score_dtype: str = "f32", softmax_impl: str = "exact"):
    """Causal attention with query chunking. q (B,S,KH,G,D); k/v (B,T,KH,D)."""
    B, S, KH, G, D = q.shape
    T = k.shape[1]
    scale = 1.0 / math.sqrt(D)
    dev = q.device
    k_pos = torch.arange(T, device=dev)
    if k_len is not None:
        k_pos = torch.where(k_pos < k_len, k_pos, torch.full_like(k_pos, T + 1))
    if S <= chunk:
        q_pos = q_offset + torch.arange(S, device=dev)
        o = _attend_block(q, k, v, q_pos, k_pos, scale, score_dtype, softmax_impl)
        return o.to(q.dtype)
    assert S % chunk == 0, (S, chunk)
    outs = []
    for i in range(S // chunk):
        q_pos = q_offset + i * chunk + torch.arange(chunk, device=dev)
        outs.append(_attend_block(q[:, i * chunk:(i + 1) * chunk], k, v, q_pos,
                                  k_pos, scale, score_dtype, softmax_impl))
    return torch.cat(outs, dim=1).to(q.dtype)


def _attend_rows(q, k, v, q_pos, k_len, scale, score_dtype: str = "f32",
                 softmax_impl: str = "exact", ops=cm.LIBRARY):
    """_attend_block with per-row positions: q (B,S,KH,G,D), k/v
    (B,T,KH,Dv), q_pos (B,S), k_len (B,); ``ops`` the products
    (``cm.Products``)."""
    s = _scores(q, k, scale, score_dtype, ops)
    k_pos = torch.arange(k.shape[1], device=q.device)
    mask = ((k_pos[None, None, :] < k_len[:, None, None])
            & (k_pos[None, None, :] <= q_pos[:, :, None]))      # (B,S,T)
    s = torch.where(mask[:, None, None], s, torch.full_like(s, NEG_INF))
    p = _softmax_fn(softmax_impl)(s, axis=-1)
    return _pv(p, v, score_dtype, ops)


# ---------------------------------------------------------------------------
# Paged KV plumbing
# ---------------------------------------------------------------------------
def _paged_attend_impl(cfg) -> str:
    impl = getattr(cfg, "paged_attend_impl", "gather")
    if impl not in ("gather", "pallas"):
        raise ValueError(f"unknown paged_attend_impl {impl!r}")
    if impl == "pallas" and cfg.score_dtype != "f32":
        raise ValueError(
            "paged_attend_impl='pallas' supports score_dtype='f32' only "
            f"(got {cfg.score_dtype!r}); use the gather path for "
            "bf16_mxu scoring")
    return impl


def _pool_write(pool, tables, lens, new) -> None:
    """Write S new positions per row into the block pool, in place.

    pool (N, L, *f), tables (B, M) int32, lens (B,) int32, new (B, S, *f).
    S == 1: one element per row at position ``lens`` (vacant slots carry an
    all-zero table, so their write lands in scratch block 0). S % L == 0:
    whole blocks from the block-aligned position ``lens``. Table indices
    clip to the table, as the JAX ``take_along_axis(mode="clip")``.
    """
    B, S = new.shape[:2]
    L = pool.shape[1]
    M = tables.shape[1]
    lens = lens.to(torch.int64)
    if S == 1:
        col = (lens // L).clamp(0, M - 1)[:, None]
        blk = tables.to(torch.int64).gather(1, col)[:, 0]
        pool.index_put_((blk, lens % L), new[:, 0].to(pool.dtype))
        return
    assert S % L == 0, f"prefill width {S} not a multiple of block_len {L}"
    nb = S // L
    idx = (lens // L)[:, None] + torch.arange(nb, device=pool.device)[None, :]
    blk = tables.to(torch.int64).gather(1, idx.clamp(0, M - 1))
    blocks = new.reshape((B * nb, L) + tuple(new.shape[2:])).to(pool.dtype)
    pool.index_put_((blk.reshape(-1),), blocks)


def _pool_write_quant(pool, scale_pool, tables, lens, new, spec) -> None:
    """_pool_write for a quantized pool, in place: codes against
    per-block-per-head amax scales.

    pool (N, L, KH, hd) integer codes; scale_pool (N, 1, KH, 1) float32.
    S % L == 0 (prefill): each written block takes a fresh scale from its
    own per-head amax, the bucket padding included. S == 1 (decode): a
    fresh block (``lens % L == 0``) takes the new element's scale; otherwise
    the scale is ``max(old, need)`` and the block's codes are re-quantized
    by ``round(code * old / new)`` (ratio <= 1; exactly 1.0, so codes
    survive bit for bit, when the scale does not grow). The block's old
    scale and codes are read before anything is written. Vacant slots land
    in scratch block 0, as in ``_pool_write``.
    """
    B, S = new.shape[:2]
    L = pool.shape[1]
    M = tables.shape[1]
    fmt = spec.fmt
    lens = lens.to(torch.int64)
    tables = tables.to(torch.int64)
    if S == 1:
        blk = tables.gather(1, (lens // L).clamp(0, M - 1)[:, None])[:, 0]
        elem = new[:, 0].to(torch.float32)                         # (B,KH,hd)
        need = kvq.scale_for_amax(elem.abs().amax(dim=-1)[:, None, :, None], spec)
        old = scale_pool[blk]                                      # (B,1,KH,1)
        cur = pool[blk].to(torch.float32)                          # (B,L,KH,hd)
        fresh = (lens % L == 0)[:, None, None, None]
        new_scale = torch.where(fresh, need, torch.maximum(old, need))
        resc = torch.clamp(torch.round(cur * (old / new_scale)),
                           fmt.min_int, fmt.max_int).to(pool.dtype)
        code = kvq.quantize(elem, spec, new_scale[:, 0])           # (B,KH,hd)
        pool.index_put_((blk,), resc)
        pool.index_put_((blk, lens % L), code)
        scale_pool.index_put_((blk,), new_scale)
        return
    assert S % L == 0, f"prefill width {S} not a multiple of block_len {L}"
    nb = S // L
    idx = (lens // L)[:, None] + torch.arange(nb, device=pool.device)[None, :]
    blk = tables.gather(1, idx.clamp(0, M - 1)).reshape(-1)
    blocks = new.reshape((B * nb, L) + tuple(new.shape[2:])).to(torch.float32)
    scales = kvq.block_scale(blocks, spec)                         # (B*nb,1,KH,1)
    pool.index_put_((blk,), kvq.quantize(blocks, spec, scales))
    scale_pool.index_put_((blk,), scales)


def _pool_gather(pool, tables):
    """(N, L, *f) pool + (B, M) tables -> (B, M*L, *f), the full table."""
    B, M = tables.shape
    L = pool.shape[1]
    return pool[tables.to(torch.int64)].reshape((B, M * L) + tuple(pool.shape[2:]))


def _pool_gather_dequant(pool, scale_pool, tables, spec):
    """_pool_gather for a quantized pool: codes and per-block scales through
    the same table, CORDIC-dequantized elementwise -> (B, M*L, KH, hd)
    float32, from the same (code, scale) pairs the decode kernel reads."""
    L = pool.shape[1]
    scales = _pool_gather(scale_pool, tables).repeat_interleave(L, dim=1)
    return kvq.dequantize(_pool_gather(pool, tables), spec, scales)


def _dense_write(buf, idx, new, lo: int = 0, total: Optional[int] = None) -> None:
    """Write S new positions per row into a dense buffer, in place: buf
    (B, T, *f), idx (B,) int32, new (B, S, *f). Row b lands at positions
    clamp(idx[b], 0, T - S) + [0, S), as ``dynamic_update_slice`` clamps
    its start (a vacant slot's idx runs on past the buffer).

    A span of the positions (``kv_shard="seq_model"`` or "seq_data"): ``buf`` holds the
    global positions [lo, lo + T) of rows ``total`` long. The start clamps
    in global positions, then each new position is written only where it
    falls in the span. S <= T: the S positions land at their positions
    modulo T, distinct slots, the ones outside the span rewritten with
    their old values; a wider prefill rewrites the whole span, each slot
    from its new position or its old value (no data-dependent shapes, so
    no host sync and meta tensors pass)."""
    B, S = new.shape[:2]
    T = buf.shape[1]
    total = T if total is None else total
    dev = buf.device
    start = idx.to(torch.int64).clamp(0, total - S)
    new = new.to(buf.dtype)
    if total == T:
        pos = start[:, None] + torch.arange(S, device=dev)[None, :]
        rows = torch.arange(B, device=dev)[:, None].expand(B, S)
        buf.index_put_((rows, pos), new)
        return
    feat = (1,) * (new.dim() - 2)
    if S <= T:
        pos = start[:, None] + torch.arange(S, device=dev)[None, :] - lo
        rows = torch.arange(B, device=dev)[:, None].expand(B, S)
        slot = pos % T
        own = ((pos >= 0) & (pos < T)).view((B, S) + feat)
        buf.index_put_((rows, slot), torch.where(own, new, buf[rows, slot]))
        return
    j = lo + torch.arange(T, device=dev)[None, :] - start[:, None]          # (B, T)
    own = ((j >= 0) & (j < S)).view((B, T) + feat)
    rows = torch.arange(B, device=dev)[:, None].expand(B, T)
    buf.copy_(torch.where(own, new[rows, j.clamp(0, S - 1)], buf))


def _span(buf, mesh, axis: str = "model"):
    """(first global position, row length) of a rank's span ``buf`` (B, T/n,
    ...) of positions cut over ``mesh``'s ``axis`` (n ranks)."""
    if axis == "data":
        return mesh.data_rank * buf.shape[1], buf.shape[1] * mesh.dp
    return mesh.model_rank * buf.shape[1], buf.shape[1] * mesh.tp


def _heads_gathered(t, dim: int, heads: int, mesh):
    """``t`` with its ``dim`` (this rank's heads) gathered over the model
    axis to ``heads`` (as it is when whole), in float32 on the wire (exact)."""
    if t.shape[dim] == heads:
        return t
    moved = t.movedim(dim, -1)
    full = shd.gather_heads(moved.float().contiguous(), 1, mesh)
    return full.to(t.dtype).movedim(-1, dim)


def _own_heads(o, heads_local: int, mesh):
    """This rank's slice of a whole-heads activation (B, S, H, ...) (all of
    it when the rank's heads are whole)."""
    if o.shape[2] == heads_local:
        return o
    return o.narrow(2, mesh.model_rank * heads_local, heads_local)


def _seq_attend(qg, k, v, positions, k_len, lo, scale, score_dtype, softmax_impl, mesh,
                axis: str = "model"):
    """``_attend_rows`` over a span of the positions cut over ``mesh``'s
    ``axis``: q (B,S,KH,G,D) the heads the span holds, k/v (B,Tl,KH,Dv) the
    rank's positions [lo, lo + Tl), the mask in global positions; the
    rank's P.V partial summed over the axis in float32 -> (B,S,KH,G,Dv)
    float32."""
    s = _scores(qg, k, scale, score_dtype)
    k_pos = lo + torch.arange(k.shape[1], device=qg.device)
    mask = ((k_pos[None, None, :] < k_len[:, None, None])
            & (k_pos[None, None, :] <= positions[:, :, None]))   # (B,S,Tl)
    s = torch.where(mask[:, None, None], s, torch.full_like(s, NEG_INF))
    p = _split_softmax(softmax_impl, s, mesh, axis)
    return shd.reduce_(_pv(p, v, score_dtype).contiguous(), mesh, axis)


def _dense_idx(batch: int, device, idx) -> torch.Tensor:
    return (idx if idx is not None else
            torch.zeros((batch,), dtype=torch.int32, device=device))


def gqa_init_cache(cfg, batch: int, max_len: int, dtype=torch.float32, *,
                   device, idx: Optional[torch.Tensor] = None,
                   kv_heads: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """One GQA layer's dense cache: (batch, max_len, KH, hd) K/V buffers
    (KH padded, or ``kv_heads``: a rank's share) and the (batch,) positions
    ``idx``, which the caller may share across layers."""
    shape = (batch, max_len, kv_heads or padded_heads(cfg)[1], cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "idx": _dense_idx(batch, device, idx)}


def gqa_init_paged_cache(cfg, slots: int, num_blocks: int, block_len: int,
                         max_blocks: int, dtype=torch.float32, *, device,
                         tables: Optional[torch.Tensor] = None,
                         lens: Optional[torch.Tensor] = None,
                         kv_heads: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """One layer's paged cache: (num_blocks, block_len, KH, hd) K/V pools
    (block 0 is scratch; KH padded, or ``kv_heads``: a rank's share) plus
    the per-slot tables and lengths, which the caller may share across
    layers. Under ``cfg.kv_quant`` the pools hold codes in the format's
    lane dtype, and "k_scale_pool"/"v_scale_pool" (num_blocks, 1, KH, 1)
    float32 hold the per-block per-head scales, starting at 1.0: a rank's
    scales follow its codes' heads."""
    spec = kvq.spec_for(getattr(cfg, "kv_quant", "none"))
    KH, hd = kv_heads or padded_heads(cfg)[1], cfg.head_dim
    shape = (num_blocks, block_len, KH, hd)
    pool_dtype = dtype if spec is None else spec.code_dtype
    cache = {
        "k_pool": torch.zeros(shape, dtype=pool_dtype, device=device),
        "v_pool": torch.zeros(shape, dtype=pool_dtype, device=device),
        **_slot_rows(slots, max_blocks, device, tables, lens),
    }
    if spec is not None:
        for name in ("k_scale_pool", "v_scale_pool"):
            cache[name] = torch.ones((num_blocks, 1, KH, 1), dtype=torch.float32,
                                     device=device)
    return cache


def _slot_rows(slots, max_blocks, device, tables, lens) -> Dict[str, torch.Tensor]:
    """The per-slot block tables and lengths (zeros unless shared ones are
    given)."""
    return {
        "tables": (tables if tables is not None else
                   torch.zeros((slots, max_blocks), dtype=torch.int32, device=device)),
        "lens": (lens if lens is not None else
                 torch.zeros((slots,), dtype=torch.int32, device=device)),
    }


# ---------------------------------------------------------------------------
# GQA
# ---------------------------------------------------------------------------
def padded_heads(cfg):
    """(H', KH') after ``cfg.pad_heads_to``: the KV heads pad up to the
    multiple and the query heads follow as H' = KH' * G (G the arch's group
    size), which keeps the kv-major q -> kv mapping of the real heads."""
    H, KH = cfg.num_heads, cfg.num_kv_heads
    p = cfg.pad_heads_to
    if p and p > 1:
        G = H // KH
        KH = -(-KH // p) * p
        H = KH * G
    return H, KH


class GQAttention(nn.Module):
    """wq (d,H,hd), wk/wv (d,KH,hd), wo (H,hd,d) and, with ``cfg.qkv_bias``,
    bq (H,hd), bk/bv (KH,hd), as the JAX spec (H, KH padded)."""

    def __init__(self, cfg, *, dtype: torch.dtype, device: torch.device,
                 gen: torch.Generator = None):
        super().__init__()
        d, hd = cfg.d_model, cfg.head_dim
        H, KH = padded_heads(cfg)
        for name, shape in (("wq", (d, H, hd)), ("wk", (d, KH, hd)),
                            ("wv", (d, KH, hd)), ("wo", (H, hd, d))):
            w = (cm.init_normal(shape, gen, dtype, device) if gen is not None
                 else torch.empty(shape, dtype=dtype, device=device))
            setattr(self, name, nn.Parameter(w, requires_grad=False))
        if cfg.qkv_bias:
            # zeros, as the JAX spec initialises them
            for name, heads in (("bq", H), ("bk", KH), ("bv", KH)):
                setattr(self, name, nn.Parameter(
                    torch.zeros((heads, hd), dtype=dtype, device=device),
                    requires_grad=False))


def _project(x, w, ops=cm.LIBRARY):
    """einsum("bsd,dhk->bshk") as one matrix product."""
    B, S, d = x.shape
    return ops.matmul(x, w.to(x.dtype).reshape(d, -1)).view(B, S, *w.shape[1:])


def _out_project(o, wo, ops=cm.LIBRARY):
    """einsum("bshk,hkd->bsd") as one matrix product."""
    B, S = o.shape[:2]
    return ops.matmul(o.reshape(B, S, -1), wo.to(o.dtype).reshape(-1, wo.shape[-1]))


def _row_parallel(p, y):
    """``y`` of a ``wo`` product: summed over the model axis when the rank
    holds a slice of the heads (a partial sum), else as it is."""
    return shd.row_sum(y) if shd.is_cut(p, "wo") else y


def _column_parallel(p, x):
    """The block's input as the rank's heads read it: under grad its
    gradient is summed over the model axis when the heads are cut."""
    return shd.to_ranks(x) if shd.is_cut(p, "wo") else x


def _gqa_groups(p: GQAttention, cfg):
    """(G, kv) of this rank's attend: G query heads per attended KV head,
    and ``kv`` None when the rank's K/V heads are its own (whole, or cut
    with the query heads), else the index (a slice, or per query head a
    tensor) of the whole K/V heads its query heads read."""
    Hp, KHp = padded_heads(cfg)
    G = cfg.num_heads // cfg.num_kv_heads
    Hl = p.wq.shape[1]
    if Hl == Hp or p.wk.shape[1] < KHp:
        return G, None
    first = shd.active_serving_mesh().model_rank * Hl
    lo, hi = first // G, (first + Hl - 1) // G
    if Hl % G == 0:
        return G, slice(lo, hi + 1)
    if G % Hl == 0:
        return Hl, slice(lo, lo + 1)
    return 1, torch.tensor([(first + j) // G for j in range(Hl)])


def _kv_heads_for(t, kv):
    """The KV heads (dim 2) of ``t`` that this rank's query heads read."""
    if kv is None:
        return t
    return t[:, :, kv] if isinstance(kv, slice) else t.index_select(2, kv.to(t.device))


def _gqa_paged_apply(p: GQAttention, x, cfg, cache, q, k, v):
    """Paged continuation of gqa_apply. Writes the S new K/V positions into
    the pools in place, then attends: decode (S == 1) through the decode
    kernel (``paged_attend_impl="pallas"``) or the table gather; prefill
    (S == bucket width) through the gather and ``_attend_rows``, with the
    cache's products (``cm.products_of``). The caller advances
    ``cache["lens"]``."""
    B, S, _ = x.shape
    hd = cfg.head_dim
    ops = cm.products_of(cache)
    G, kv = _gqa_groups(p, cfg)
    KH = q.shape[2] // G
    lens, tables = cache["lens"], cache["tables"]

    positions = lens.to(torch.int64)[:, None] + torch.arange(S, device=x.device)[None, :]
    q = cm.apply_rope(q, positions, cfg.rope_theta)
    k = cm.apply_rope(k, positions, cfg.rope_theta)
    kp, vp = cache["k_pool"], cache["v_pool"]
    kv_quant = getattr(cfg, "kv_quant", "none")
    spec = kvq.spec_for(kv_quant)
    ks = vs = None
    if spec is None:
        _pool_write(kp, tables, lens, k)
        _pool_write(vp, tables, lens, v)
    else:
        ks, vs = cache["k_scale_pool"], cache["v_scale_pool"]
        _pool_write_quant(kp, ks, tables, lens, k, spec)
        _pool_write_quant(vp, vs, tables, lens, v, spec)
    qg = q.reshape(B, S, KH, G, hd)

    if S == 1 and _paged_attend_impl(cfg) == "pallas":
        assert kv is None, "the decode kernel attends a rank's own KV heads"
        o = kops.paged_attend_gqa(
            qg[:, 0].contiguous(), kp, vp, tables, (lens + 1).to(torch.int32),
            scale=1.0 / math.sqrt(hd),
            softmax_impl=getattr(cfg, "softmax_impl", "exact"),
            kv_dtype=x.dtype, kv_quant=kv_quant, k_scale_pool=ks,
            v_scale_pool=vs)[:, None]
    else:
        if spec is None:
            k_full = _pool_gather(kp, tables).to(x.dtype)
            v_full = _pool_gather(vp, tables).to(x.dtype)
        else:
            k_full = _pool_gather_dequant(kp, ks, tables, spec).to(x.dtype)
            v_full = _pool_gather_dequant(vp, vs, tables, spec).to(x.dtype)
        k_full, v_full = _kv_heads_for(k_full, kv), _kv_heads_for(v_full, kv)
        o = _attend_rows(qg, k_full, v_full, positions, lens.to(torch.int64) + S,
                         1.0 / math.sqrt(hd), cfg.score_dtype,
                         getattr(cfg, "softmax_impl", "exact"), ops)
    o = o.to(qg.dtype).reshape(B, S, KH * G, hd)
    return _row_parallel(p, _out_project(o, p.wo, ops))


def _gqa_dense_apply(p: GQAttention, x, cfg, cache, q, k, v):
    """Dense continuation of gqa_apply: writes the S new K/V positions of
    each row at its ``idx`` in place, then attends over the whole buffer
    masked past ``idx + S`` (the paged gather path with the buffer in place
    of the gather); under ``kv_shard="seq_data"`` the buffer is the data
    rank's span, attended through the split softmax over the data group.
    The caller advances ``cache["idx"]``."""
    axis = shd.seq_axis(cfg)
    if axis == "model":
        return _gqa_seq_apply(p, x, cfg, cache, q, k, v)
    B, S, _ = x.shape
    hd = cfg.head_dim
    G, kv = _gqa_groups(p, cfg)
    KH = q.shape[2] // G
    idx = cache["idx"].to(torch.int64)
    positions = idx[:, None] + torch.arange(S, device=x.device)[None, :]
    q = cm.apply_rope(q, positions, cfg.rope_theta)
    k = cm.apply_rope(k, positions, cfg.rope_theta)
    mesh = shd.active_serving_mesh() if axis else None
    lo, total = _span(cache["k"], mesh, axis) if axis else (0, None)
    _dense_write(cache["k"], cache["idx"], k, lo, total)
    _dense_write(cache["v"], cache["idx"], v, lo, total)
    qg = q.reshape(B, S, KH, G, hd)
    args = (qg, _kv_heads_for(cache["k"], kv).to(x.dtype),
            _kv_heads_for(cache["v"], kv).to(x.dtype), positions, idx + S)
    impl = getattr(cfg, "softmax_impl", "exact")
    o = (_seq_attend(*args, lo, 1.0 / math.sqrt(hd), cfg.score_dtype, impl, mesh, axis)
         if axis else
         _attend_rows(*args, 1.0 / math.sqrt(hd), cfg.score_dtype, impl))
    o = o.to(qg.dtype).reshape(B, S, KH * G, hd)
    return _row_parallel(p, _out_project(o, p.wo))


def _gqa_seq_apply(p: GQAttention, x, cfg, cache, q, k, v):
    """_gqa_dense_apply with the buffers' positions cut over the model axis
    (``kv_shard="seq_model"``, module docstring): every head's queries and
    new K/V gathered, the new positions written where they fall in the
    rank's span, every head scored against the span, the split softmax,
    the P.V partial summed over the axis in float32, the rank's heads
    through the row-parallel ``wo``."""
    mesh = shd.active_serving_mesh()
    B, S, _ = x.shape
    hd = cfg.head_dim
    H, KH = padded_heads(cfg)
    Hl = q.shape[2]
    idx = cache["idx"].to(torch.int64)
    positions = idx[:, None] + torch.arange(S, device=x.device)[None, :]
    q = _heads_gathered(cm.apply_rope(q, positions, cfg.rope_theta), 2, H, mesh)
    k = _heads_gathered(cm.apply_rope(k, positions, cfg.rope_theta), 2, KH, mesh)
    v = _heads_gathered(v, 2, KH, mesh)
    lo, total = _span(cache["k"], mesh)
    _dense_write(cache["k"], cache["idx"], k, lo, total)
    _dense_write(cache["v"], cache["idx"], v, lo, total)
    o = _seq_attend(q.reshape(B, S, KH, H // KH, hd), cache["k"].to(x.dtype),
                    cache["v"].to(x.dtype), positions, idx + S, lo,
                    1.0 / math.sqrt(hd), cfg.score_dtype,
                    getattr(cfg, "softmax_impl", "exact"), mesh)
    o = _own_heads(o.to(x.dtype).reshape(B, S, H, hd), Hl, mesh)
    return _row_parallel(p, _out_project(o, p.wo))


def gqa_apply(p: GQAttention, x, cfg, *, cache: Optional[dict] = None):
    """x (B,S,d) -> (B,S,d). Without a cache: causal attention over x.
    With a paged cache: see _gqa_paged_apply; a dense one: _gqa_dense_apply."""
    B, S, d = x.shape
    hd = cfg.head_dim
    x = _column_parallel(p, x)
    ops = cm.products_of(cache)
    q = _project(x, p.wq, ops)
    k = _project(x, p.wk, ops)
    v = _project(x, p.wv, ops)
    if cfg.qkv_bias:
        # after the projections, before RoPE, on every path
        q = q + p.bq.to(x.dtype)
        k = k + p.bk.to(x.dtype)
        v = v + p.bv.to(x.dtype)
    if cache is not None:
        if "k_pool" in cache:
            return _gqa_paged_apply(p, x, cfg, cache, q, k, v)
        return _gqa_dense_apply(p, x, cfg, cache, q, k, v)
    positions = torch.arange(S, device=x.device)[None, :]
    q = cm.apply_rope(q, positions, cfg.rope_theta)
    k = cm.apply_rope(k, positions, cfg.rope_theta)
    G, kv = _gqa_groups(p, cfg)
    H = q.shape[2]
    o = causal_attention(q.reshape(B, S, H // G, G, hd), _kv_heads_for(k, kv),
                         _kv_heads_for(v, kv), chunk=cfg.attn_chunk,
                         score_dtype=cfg.score_dtype,
                         softmax_impl=getattr(cfg, "softmax_impl", "exact"))
    return _row_parallel(p, _out_project(o.reshape(B, S, H, hd), p.wo))


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2)
# ---------------------------------------------------------------------------
class MLAttention(nn.Module):
    """wq (d,H,nope+rope), wkv_a (d,R+rope), kv_norm (R,), wkv_b
    (R,H,nope+v), wo (H,v,d), as the JAX ``mla_spec``."""

    def __init__(self, cfg, *, dtype: torch.dtype, device: torch.device,
                 gen: torch.Generator = None):
        super().__init__()
        m = cfg.mla
        d, H = cfg.d_model, cfg.num_heads
        for name, shape in (
                ("wq", (d, H, m.qk_nope_dim + m.qk_rope_dim)),
                ("wkv_a", (d, m.kv_lora_rank + m.qk_rope_dim)),
                ("wkv_b", (m.kv_lora_rank, H, m.qk_nope_dim + m.v_dim)),
                ("wo", (H, m.v_dim, d))):
            w = (cm.init_normal(shape, gen, dtype, device) if gen is not None
                 else torch.empty(shape, dtype=dtype, device=device))
            setattr(self, name, nn.Parameter(w, requires_grad=False))
        self.kv_norm = nn.Parameter(
            torch.ones(m.kv_lora_rank, dtype=dtype, device=device),
            requires_grad=False)


def mla_init_cache(cfg, batch: int, max_len: int, dtype=torch.float32, *,
                   device, idx: Optional[torch.Tensor] = None
                   ) -> Dict[str, torch.Tensor]:
    """One MLA layer's dense cache: the compressed latent (batch, max_len,
    kv_lora_rank), the rope key (batch, max_len, qk_rope_dim) and the
    (batch,) positions ``idx`` (shareable across layers)."""
    m = cfg.mla
    return {"c_kv": torch.zeros((batch, max_len, m.kv_lora_rank), dtype=dtype,
                                device=device),
            "k_rope": torch.zeros((batch, max_len, m.qk_rope_dim), dtype=dtype,
                                  device=device),
            "idx": _dense_idx(batch, device, idx)}


def mla_init_paged_cache(cfg, slots: int, num_blocks: int, block_len: int,
                         max_blocks: int, dtype=torch.float32, *, device,
                         tables: Optional[torch.Tensor] = None,
                         lens: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """One MLA layer's paged cache: block pools over the compressed latent
    (num_blocks, block_len, kv_lora_rank) and the shared rope key
    (num_blocks, block_len, qk_rope_dim), block 0 scratch, plus the per-slot
    tables and lengths (shareable across layers)."""
    if getattr(cfg, "kv_quant", "none") not in (None, "none"):
        raise ValueError("kv_quant applies to GQA paged pools only; MLA "
                         "layers store the compressed latent unquantized")
    m = cfg.mla
    return {
        "c_kv_pool": torch.zeros((num_blocks, block_len, m.kv_lora_rank),
                                 dtype=dtype, device=device),
        "k_rope_pool": torch.zeros((num_blocks, block_len, m.qk_rope_dim),
                                   dtype=dtype, device=device),
        **_slot_rows(slots, max_blocks, device, tables, lens),
    }


def _mla_project_q(p: MLAttention, x, cfg, positions, ops=cm.LIBRARY):
    m = cfg.mla
    q = _project(x, p.wq, ops)                                # (B,S,H,nope+rope)
    q_nope, q_rope = q[..., :m.qk_nope_dim], q[..., m.qk_nope_dim:]
    return q_nope, cm.apply_rope(q_rope, positions, cfg.rope_theta)


def _mla_compress(p: MLAttention, x, cfg, positions, ops=cm.LIBRARY):
    """(c_kv (B,S,R) rmsnormed, k_rope (B,S,rope) RoPE'd), in x.dtype."""
    m = cfg.mla
    kv = ops.matmul(x, p.wkv_a.to(x.dtype))
    c_kv, k_rope = kv[..., :m.kv_lora_rank], kv[..., m.kv_lora_rank:]
    c_kv = cm.rmsnorm(p.kv_norm, c_kv)
    k_rope = cm.apply_rope(k_rope[:, :, None, :], positions, cfg.rope_theta)[:, :, 0]
    return c_kv, k_rope


def _mla_split_wkv_b(p: MLAttention, cfg, dtype):
    m = cfg.mla
    wkv_b = p.wkv_b.to(dtype)
    return wkv_b[..., :m.qk_nope_dim], wkv_b[..., m.qk_nope_dim:]


def _mla_scale(cfg) -> float:
    m = cfg.mla
    return 1.0 / math.sqrt(m.qk_nope_dim + m.qk_rope_dim)


def _mla_absorbed_decode(q_nope, q_rope, cc, cr, wk_b, wv_b, scale, valid,
                         score_dtype, softmax_impl):
    """Absorbed-form single-query MLA decode against a compressed buffer:
    q_nope/q_rope (B,1,H,.), cc/cr (B,T,.), ``valid`` broadcastable to the
    (B,H,1,T) score mask. Returns o (B,1,H,v_dim) float32. Under bf16_mxu
    the buffers take the queries' dtype for the scores and the
    probabilities the latent buffer's for P.C, as in JAX."""
    q_eff = torch.einsum("bshk,lhk->bshl", q_nope, wk_b)          # (B,1,H,R)
    s = _mla_absorbed_scores(q_eff, q_rope, cc, cr, scale, valid, score_dtype)
    o_lat = _mla_pc(_softmax_fn(softmax_impl)(s, axis=-1), cc, score_dtype)
    return torch.einsum("bshl,lhv->bshv", o_lat, wv_b.to(torch.float32))


def _mla_absorbed_scores(q_eff, q_rope, cc, cr, scale, valid, score_dtype):
    """The absorbed form's masked scores (B,H,1,T) float32 of q_eff
    (B,1,H,R) and q_rope against the latent and rope-key buffers."""
    if _mxu(score_dtype):
        cc, cr = cc.to(q_eff.dtype), cr.to(q_rope.dtype)
    s = (torch.einsum("bshl,btl->bhst", q_eff.float(), cc.float())
         + torch.einsum("bshk,btk->bhst", q_rope.float(), cr.float())) * scale
    return torch.where(valid, s, torch.full_like(s, NEG_INF))


def _mla_pc(pr, cc, score_dtype):
    """P.C of the absorbed form: (B,H,1,T) probabilities against the latent
    buffer -> (B,1,H,R) float32 (under bf16_mxu the probabilities take the
    buffer's dtype first)."""
    if _mxu(score_dtype):
        pr = pr.to(cc.dtype)
    return torch.einsum("bhst,btl->bshl", pr.float(), cc.float())


def _mla_decompress_kq(q_nope, q_rope, cc, cr, m, H, wk_b, wv_b, ops=cm.LIBRARY):
    """Decompress a (compressed latent, rope key) buffer into full k/v and
    build the grouped query (B,S,H,1,nope+rope) for the row attends."""
    dtype = q_nope.dtype
    B, T = cc.shape[:2]
    S = q_nope.shape[1]
    ccd = cc.to(dtype)
    k_nope = ops.einsum("btl,lhk->bthk", ccd, wk_b)
    v = ops.einsum("btl,lhv->bthv", ccd, wv_b)
    k = torch.cat([k_nope, cr[:, :, None, :].to(dtype).expand(
        B, T, H, m.qk_rope_dim)], dim=-1)
    q = torch.cat([q_nope, q_rope.expand(B, S, H, m.qk_rope_dim)], dim=-1)
    return k, v, q.reshape(B, S, H, 1, m.qk_nope_dim + m.qk_rope_dim)


def _mla_paged_apply(p: MLAttention, x, cfg, cache):
    """Paged MLA: writes the compressed latent and the rope key into the
    pools in place, then absorbed decode (S == 1) through the decode kernel
    (``paged_attend_impl="pallas"``) or the table gather, or prefill as
    decompress plus ``_attend_rows`` over the gathered buffer. The caller
    advances ``cache["lens"]``. A prefill runs the cache's products
    (``cm.products_of``)."""
    B, S, _ = x.shape
    m, H = cfg.mla, p.wq.shape[1]               # the rank's heads
    lens, tables = cache["lens"], cache["tables"]
    positions = lens.to(torch.int64)[:, None] + torch.arange(S, device=x.device)[None, :]
    ops = cm.products_of(cache)

    q_nope, q_rope = _mla_project_q(p, x, cfg, positions, ops)
    c_kv, k_rope = _mla_compress(p, x, cfg, positions, ops)
    cp, rp = cache["c_kv_pool"], cache["k_rope_pool"]
    _pool_write(cp, tables, lens, c_kv)
    _pool_write(rp, tables, lens, k_rope)

    wk_b, wv_b = _mla_split_wkv_b(p, cfg, x.dtype)
    scale = _mla_scale(cfg)
    k_len = lens.to(torch.int64) + S
    softmax_impl = getattr(cfg, "softmax_impl", "exact")

    if S == 1:
        if _paged_attend_impl(cfg) == "pallas":
            q_eff = torch.einsum("bshk,lhk->bshl", q_nope, wk_b)
            o_lat = kops.paged_attend_mla(
                q_eff[:, 0].contiguous(), q_rope[:, 0].contiguous(), cp, rp,
                tables, (lens + 1).to(torch.int32), scale=scale,
                softmax_impl=softmax_impl)
            o = torch.einsum("bshl,lhv->bshv", o_lat[:, None],
                             wv_b.to(torch.float32))
        else:
            cc = _pool_gather(cp, tables)                          # (B,T,R)
            cr = _pool_gather(rp, tables)
            T = cc.shape[1]
            valid = (torch.arange(T, device=x.device)[None, :]
                     < k_len[:, None])[:, None, None, :]
            o = _mla_absorbed_decode(q_nope, q_rope, cc, cr, wk_b, wv_b,
                                     scale, valid, cfg.score_dtype,
                                     softmax_impl)
    else:
        # prefill: decompress the gathered buffer, per-row-positioned attend
        cc = _pool_gather(cp, tables)
        cr = _pool_gather(rp, tables)
        k, v, qg = _mla_decompress_kq(q_nope, q_rope, cc, cr, m, H, wk_b, wv_b, ops)
        o = _attend_rows(qg, k, v, positions, k_len, scale,
                         softmax_impl=softmax_impl, ops=ops)
        o = o.to(qg.dtype).reshape(B, S, H, m.v_dim)
    return _row_parallel(p, _out_project(o.to(x.dtype), p.wo, ops))


def _mla_dense_apply(p: MLAttention, x, cfg, cache):
    """Dense MLA: writes each row's compressed latent and rope key at its
    ``idx`` in place, then absorbed decode (S == 1) or decompress plus
    ``_attend_rows`` (prefill) over the whole buffer, masked past
    ``idx + S``. The caller advances ``cache["idx"]``."""
    axis = shd.seq_axis(cfg)
    if axis:
        return _mla_seq_apply(p, x, cfg, cache, axis)
    B, S, _ = x.shape
    m, H = cfg.mla, p.wq.shape[1]               # the rank's heads
    idx = cache["idx"].to(torch.int64)
    positions = idx[:, None] + torch.arange(S, device=x.device)[None, :]
    q_nope, q_rope = _mla_project_q(p, x, cfg, positions)
    c_kv, k_rope = _mla_compress(p, x, cfg, positions)
    cc, cr = cache["c_kv"], cache["k_rope"]
    _dense_write(cc, cache["idx"], c_kv)
    _dense_write(cr, cache["idx"], k_rope)
    wk_b, wv_b = _mla_split_wkv_b(p, cfg, x.dtype)
    scale = _mla_scale(cfg)
    k_len = idx + S
    softmax_impl = getattr(cfg, "softmax_impl", "exact")
    if S == 1:
        valid = (torch.arange(cc.shape[1], device=x.device)[None, :]
                 < k_len[:, None])[:, None, None, :]
        o = _mla_absorbed_decode(q_nope, q_rope, cc, cr, wk_b, wv_b, scale,
                                 valid, cfg.score_dtype, softmax_impl)
    else:
        k, v, qg = _mla_decompress_kq(q_nope, q_rope, cc, cr, m, H, wk_b, wv_b)
        o = _attend_rows(qg, k, v, positions, k_len, scale,
                         softmax_impl=softmax_impl)
        o = o.to(qg.dtype).reshape(B, S, H, m.v_dim)
    return _row_parallel(p, _out_project(o.to(x.dtype), p.wo))


def _mla_seq_apply(p: MLAttention, x, cfg, cache, axis: str = "model"):
    """_mla_dense_apply with the latent buffers' positions cut over the
    model axis (``kv_shard="seq_model"``) or, ``axis="data"``, over the
    data axes ("seq_data"): the latent is head-less, so each rank writes its
    span of the new positions' latent and rope key. Decode is the absorbed
    form with every head's absorbed query and rope query gathered (over
    "data" the rank's own heads); prefill decompresses the rank's positions
    with every head's ``wkv_b`` (gathered for the step; over "data" the
    rank's own) and takes ``_seq_attend``. The P.V (or P.C) partial is
    summed over the axis in float32, and the rank's heads go on through
    ``wv_b`` / ``wo``."""
    mesh = shd.active_serving_mesh()
    B, S, _ = x.shape
    m, Hl, H = cfg.mla, p.wq.shape[1], cfg.num_heads
    idx = cache["idx"].to(torch.int64)
    positions = idx[:, None] + torch.arange(S, device=x.device)[None, :]
    q_nope, q_rope = _mla_project_q(p, x, cfg, positions)
    c_kv, k_rope = _mla_compress(p, x, cfg, positions)
    cc, cr = cache["c_kv"], cache["k_rope"]
    lo, total = _span(cc, mesh, axis)
    _dense_write(cc, cache["idx"], c_kv, lo, total)
    _dense_write(cr, cache["idx"], k_rope, lo, total)
    wk_b, wv_b = _mla_split_wkv_b(p, cfg, x.dtype)
    scale = _mla_scale(cfg)
    k_len = idx + S
    softmax_impl = getattr(cfg, "softmax_impl", "exact")
    if axis == "data":        # the span holds every position's latent: own heads
        H = Hl
    q_rope = _heads_gathered(q_rope, 2, H, mesh)
    if S == 1:
        q_eff = _heads_gathered(torch.einsum("bshk,lhk->bshl", q_nope, wk_b), 2, H, mesh)
        valid = ((lo + torch.arange(cc.shape[1], device=x.device))[None, :]
                 < k_len[:, None])[:, None, None, :]
        s = _mla_absorbed_scores(q_eff, q_rope, cc, cr, scale, valid, cfg.score_dtype)
        pr = _split_softmax(softmax_impl, s, mesh, axis)
        o_lat = shd.reduce_(_mla_pc(pr, cc, cfg.score_dtype).contiguous(), mesh, axis)
        o = torch.einsum("bshl,lhv->bshv", _own_heads(o_lat, Hl, mesh),
                         wv_b.to(torch.float32))
    else:
        wk_b = _heads_gathered(wk_b, 1, H, mesh)
        wv_b = _heads_gathered(wv_b, 1, H, mesh)
        k, v, qg = _mla_decompress_kq(_heads_gathered(q_nope, 2, H, mesh), q_rope,
                                      cc, cr, m, H, wk_b, wv_b)
        o = _seq_attend(qg, k, v, positions, k_len, lo, scale, "f32", softmax_impl, mesh,
                        axis)
        o = _own_heads(o.to(qg.dtype).reshape(B, S, H, m.v_dim), Hl, mesh)
    return _row_parallel(p, _out_project(o.to(x.dtype), p.wo))


def mla_apply(p: MLAttention, x, cfg, *, cache: Optional[dict] = None):
    """x (B,S,d) -> (B,S,d). Without a cache: decompress K/V and run the
    chunked causal core. With a paged cache: see _mla_paged_apply; a dense
    one: _mla_dense_apply."""
    B, S, _ = x.shape
    m, H = cfg.mla, p.wq.shape[1]               # the rank's heads
    x = _column_parallel(p, x)
    if cache is not None:
        if "c_kv_pool" in cache:
            return _mla_paged_apply(p, x, cfg, cache)
        return _mla_dense_apply(p, x, cfg, cache)
    positions = torch.arange(S, device=x.device)[None, :]
    q_nope, q_rope = _mla_project_q(p, x, cfg, positions)
    c_kv, k_rope = _mla_compress(p, x, cfg, positions)
    wk_b, wv_b = _mla_split_wkv_b(p, cfg, x.dtype)
    k, v, qg = _mla_decompress_kq(q_nope, q_rope, c_kv, k_rope, m, H, wk_b, wv_b)
    o = causal_attention(qg, k, v, chunk=cfg.attn_chunk,
                         softmax_impl=getattr(cfg, "softmax_impl", "exact"))
    return _row_parallel(p, _out_project(o.reshape(B, S, H, m.v_dim), p.wo))
