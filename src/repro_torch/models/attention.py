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

The dense per-slot KV cache and the quantized pools are not ported yet
(ROADMAP A.6, A.9).
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
from torch import nn

from repro_torch.cordic_engine import functions as F
from repro_torch.kernels import ops as kops
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


def _check_score_dtype(score_dtype: str) -> None:
    if score_dtype != "f32":
        raise NotImplementedError(
            f"score_dtype={score_dtype!r} is not ported; the port scores in "
            "float32 (score_dtype='f32')")


# ---------------------------------------------------------------------------
# Causal attention cores
# ---------------------------------------------------------------------------
def _attend_block(q, k, v, q_pos, k_pos, scale, score_dtype: str = "f32",
                  softmax_impl: str = "exact"):
    """q (B,c,KH,G,D), k/v (B,T,KH,D) -> (B,c,KH,G,D), full-row softmax."""
    _check_score_dtype(score_dtype)
    q32, k32, v32 = (t.to(torch.float32) for t in (q, k, v))
    s = torch.einsum("bqhgd,bkhd->bhgqk", q32, k32) * scale
    mask = k_pos[None, :] <= q_pos[:, None]                    # (c, T)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = _softmax_fn(softmax_impl)(s, axis=-1)
    return torch.einsum("bhgqk,bkhd->bqhgd", p, v32)


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
                 softmax_impl: str = "exact"):
    """_attend_block with per-row positions: q (B,S,KH,G,D), k/v
    (B,T,KH,Dv), q_pos (B,S), k_len (B,)."""
    _check_score_dtype(score_dtype)
    q32, k32, v32 = (t.to(torch.float32) for t in (q, k, v))
    s = torch.einsum("bqhgd,bkhd->bhgqk", q32, k32) * scale
    k_pos = torch.arange(k.shape[1], device=q.device)
    mask = ((k_pos[None, None, :] < k_len[:, None, None])
            & (k_pos[None, None, :] <= q_pos[:, :, None]))      # (B,S,T)
    s = torch.where(mask[:, None, None], s, torch.full_like(s, NEG_INF))
    p = _softmax_fn(softmax_impl)(s, axis=-1)
    return torch.einsum("bhgqk,bkhd->bqhgd", p, v32)


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
            f"(got {cfg.score_dtype!r})")
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


def _pool_gather(pool, tables):
    """(N, L, *f) pool + (B, M) tables -> (B, M*L, *f), the full table."""
    B, M = tables.shape
    L = pool.shape[1]
    return pool[tables.to(torch.int64)].reshape((B, M * L) + tuple(pool.shape[2:]))


def gqa_init_paged_cache(cfg, slots: int, num_blocks: int, block_len: int,
                         max_blocks: int, dtype=torch.float32, *, device,
                         tables: Optional[torch.Tensor] = None,
                         lens: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """One layer's paged cache: (num_blocks, block_len, KH, hd) K/V pools
    (block 0 is scratch) plus the per-slot tables and lengths, which the
    caller may share across layers."""
    if getattr(cfg, "kv_quant", "none") not in (None, "none"):
        raise NotImplementedError(
            "kv_quant pools are not ported yet (ROADMAP A.9)")
    KH, hd = cfg.num_kv_heads, cfg.head_dim
    shape = (num_blocks, block_len, KH, hd)
    return {
        "k_pool": torch.zeros(shape, dtype=dtype, device=device),
        "v_pool": torch.zeros(shape, dtype=dtype, device=device),
        **_slot_rows(slots, max_blocks, device, tables, lens),
    }


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
class GQAttention(nn.Module):
    """wq (d,H,hd), wk/wv (d,KH,hd), wo (H,hd,d), as the JAX spec."""

    def __init__(self, cfg, *, dtype: torch.dtype, device: torch.device,
                 gen: torch.Generator = None):
        super().__init__()
        if cfg.qkv_bias or cfg.pad_heads_to:
            raise NotImplementedError(
                "qkv_bias and pad_heads_to are not ported yet (ROADMAP A.10)")
        d, hd = cfg.d_model, cfg.head_dim
        H, KH = cfg.num_heads, cfg.num_kv_heads
        for name, shape in (("wq", (d, H, hd)), ("wk", (d, KH, hd)),
                            ("wv", (d, KH, hd)), ("wo", (H, hd, d))):
            w = (cm.init_normal(shape, gen, dtype, device) if gen is not None
                 else torch.empty(shape, dtype=dtype, device=device))
            setattr(self, name, nn.Parameter(w, requires_grad=False))


def _project(x, w):
    """einsum("bsd,dhk->bshk") as one matrix product."""
    B, S, d = x.shape
    return (x @ w.to(x.dtype).reshape(d, -1)).view(B, S, *w.shape[1:])


def _out_project(o, wo):
    """einsum("bshk,hkd->bsd") as one matrix product."""
    B, S = o.shape[:2]
    return o.reshape(B, S, -1) @ wo.to(o.dtype).reshape(-1, wo.shape[-1])


def _gqa_paged_apply(p: GQAttention, x, cfg, cache, q, k, v):
    """Paged continuation of gqa_apply. Writes the S new K/V positions into
    the pools in place, then attends: decode (S == 1) through the decode
    kernel (``paged_attend_impl="pallas"``) or the table gather; prefill
    (S == bucket width) through the gather and ``_attend_rows``. The
    caller advances ``cache["lens"]``."""
    B, S, _ = x.shape
    hd = cfg.head_dim
    KH = k.shape[2]
    G = q.shape[2] // KH
    lens, tables = cache["lens"], cache["tables"]

    positions = lens.to(torch.int64)[:, None] + torch.arange(S, device=x.device)[None, :]
    q = cm.apply_rope(q, positions, cfg.rope_theta)
    k = cm.apply_rope(k, positions, cfg.rope_theta)
    kp, vp = cache["k_pool"], cache["v_pool"]
    _pool_write(kp, tables, lens, k)
    _pool_write(vp, tables, lens, v)
    qg = q.reshape(B, S, KH, G, hd)

    if S == 1 and _paged_attend_impl(cfg) == "pallas":
        o = kops.paged_attend_gqa(
            qg[:, 0].contiguous(), kp, vp, tables, (lens + 1).to(torch.int32),
            scale=1.0 / math.sqrt(hd),
            softmax_impl=getattr(cfg, "softmax_impl", "exact"),
            kv_dtype=x.dtype)[:, None]
    else:
        k_full = _pool_gather(kp, tables).to(x.dtype)
        v_full = _pool_gather(vp, tables).to(x.dtype)
        o = _attend_rows(qg, k_full, v_full, positions, lens.to(torch.int64) + S,
                         1.0 / math.sqrt(hd), cfg.score_dtype,
                         getattr(cfg, "softmax_impl", "exact"))
    o = o.to(qg.dtype).reshape(B, S, KH * G, hd)
    return _out_project(o, p.wo)


def gqa_apply(p: GQAttention, x, cfg, *, cache: Optional[dict] = None):
    """x (B,S,d) -> (B,S,d). Without a cache: causal attention over x.
    With a paged cache: see _gqa_paged_apply."""
    B, S, d = x.shape
    hd = cfg.head_dim
    H, KH = cfg.num_heads, cfg.num_kv_heads
    G = H // KH
    q = _project(x, p.wq)
    k = _project(x, p.wk)
    v = _project(x, p.wv)
    if cache is not None:
        if "k_pool" not in cache:
            raise NotImplementedError(
                "the dense per-slot KV cache is not ported yet (ROADMAP A.6); "
                "serve with kv_impl='paged'")
        return _gqa_paged_apply(p, x, cfg, cache, q, k, v)
    positions = torch.arange(S, device=x.device)[None, :]
    q = cm.apply_rope(q, positions, cfg.rope_theta)
    k = cm.apply_rope(k, positions, cfg.rope_theta)
    o = causal_attention(q.reshape(B, S, KH, G, hd), k, v, chunk=cfg.attn_chunk,
                         score_dtype=cfg.score_dtype,
                         softmax_impl=getattr(cfg, "softmax_impl", "exact"))
    return _out_project(o.reshape(B, S, H, hd), p.wo)


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


def _mla_project_q(p: MLAttention, x, cfg, positions):
    m = cfg.mla
    q = _project(x, p.wq)                                     # (B,S,H,nope+rope)
    q_nope, q_rope = q[..., :m.qk_nope_dim], q[..., m.qk_nope_dim:]
    return q_nope, cm.apply_rope(q_rope, positions, cfg.rope_theta)


def _mla_compress(p: MLAttention, x, cfg, positions):
    """(c_kv (B,S,R) rmsnormed, k_rope (B,S,rope) RoPE'd), in x.dtype."""
    m = cfg.mla
    kv = x @ p.wkv_a.to(x.dtype)
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
    (B,H,1,T) score mask. Returns o (B,1,H,v_dim) float32."""
    _check_score_dtype(score_dtype)
    q_eff = torch.einsum("bshk,lhk->bshl", q_nope, wk_b)          # (B,1,H,R)
    cc32 = cc.to(torch.float32)
    s = (torch.einsum("bshl,btl->bhst", q_eff.to(torch.float32), cc32)
         + torch.einsum("bshk,btk->bhst", q_rope.to(torch.float32),
                        cr.to(torch.float32))) * scale
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    pr = _softmax_fn(softmax_impl)(s, axis=-1)
    o_lat = torch.einsum("bhst,btl->bshl", pr, cc32)
    return torch.einsum("bshl,lhv->bshv", o_lat, wv_b.to(torch.float32))


def _mla_decompress_kq(q_nope, q_rope, cc, cr, m, H, wk_b, wv_b):
    """Decompress a (compressed latent, rope key) buffer into full k/v and
    build the grouped query (B,S,H,1,nope+rope) for the row attends."""
    dtype = q_nope.dtype
    B, T = cc.shape[:2]
    S = q_nope.shape[1]
    ccd = cc.to(dtype)
    k_nope = torch.einsum("btl,lhk->bthk", ccd, wk_b)
    v = torch.einsum("btl,lhv->bthv", ccd, wv_b)
    k = torch.cat([k_nope, cr[:, :, None, :].to(dtype).expand(
        B, T, H, m.qk_rope_dim)], dim=-1)
    q = torch.cat([q_nope, q_rope.expand(B, S, H, m.qk_rope_dim)], dim=-1)
    return k, v, q.reshape(B, S, H, 1, m.qk_nope_dim + m.qk_rope_dim)


def _mla_paged_apply(p: MLAttention, x, cfg, cache):
    """Paged MLA: writes the compressed latent and the rope key into the
    pools in place, then absorbed decode (S == 1) through the decode kernel
    (``paged_attend_impl="pallas"``) or the table gather, or prefill as
    decompress plus ``_attend_rows`` over the gathered buffer. The caller
    advances ``cache["lens"]``."""
    B, S, _ = x.shape
    m, H = cfg.mla, cfg.num_heads
    lens, tables = cache["lens"], cache["tables"]
    positions = lens.to(torch.int64)[:, None] + torch.arange(S, device=x.device)[None, :]

    q_nope, q_rope = _mla_project_q(p, x, cfg, positions)
    c_kv, k_rope = _mla_compress(p, x, cfg, positions)
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
        k, v, qg = _mla_decompress_kq(q_nope, q_rope, cc, cr, m, H, wk_b, wv_b)
        o = _attend_rows(qg, k, v, positions, k_len, scale,
                         softmax_impl=softmax_impl)
        o = o.to(qg.dtype).reshape(B, S, H, m.v_dim)
    return _out_project(o.to(x.dtype), p.wo)


def mla_apply(p: MLAttention, x, cfg, *, cache: Optional[dict] = None):
    """x (B,S,d) -> (B,S,d). Without a cache: decompress K/V and run the
    chunked causal core. With a paged cache: see _mla_paged_apply."""
    B, S, _ = x.shape
    m, H = cfg.mla, cfg.num_heads
    if cache is not None:
        if "c_kv_pool" not in cache:
            raise NotImplementedError(
                "the dense per-slot KV cache is not ported yet (ROADMAP A.6); "
                "serve with kv_impl='paged'")
        return _mla_paged_apply(p, x, cfg, cache)
    positions = torch.arange(S, device=x.device)[None, :]
    q_nope, q_rope = _mla_project_q(p, x, cfg, positions)
    c_kv, k_rope = _mla_compress(p, x, cfg, positions)
    wk_b, wv_b = _mla_split_wkv_b(p, cfg, x.dtype)
    k, v, qg = _mla_decompress_kq(q_nope, q_rope, c_kv, k_rope, m, H, wk_b, wv_b)
    o = causal_attention(qg, k, v, chunk=cfg.attn_chunk,
                         softmax_impl=getattr(cfg, "softmax_impl", "exact"))
    return _out_project(o.reshape(B, S, H, m.v_dim), p.wo)
