"""PyTorch port of the paged decode kernels (GQA and MLA) against the JAX
kernels.

The geometries of tests/test_paged_attention.py (lengths on and one off the
block boundaries, a single-block slot, a mixed-length batch, a vacant slot
reading scratch block 0, the kv_dtype rounding seam), batched into a few
calls, for the ``exact``, ``cordic_pallas`` and ``cordic_fixed`` softmax
(lengths off the block boundaries leave masked lanes inside a live block,
which ``cordic_fixed`` clips at e^-80 instead of flushing). The reference's
own standard: ATOL 2e-5 (f32 dot and sum orders differ; the CORDIC
probabilities are lane-exact given the row max and sum) and an unmoved
per-row argmax.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import paged_attention as JP  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import paged_attention as P  # noqa: E402

ATOL = 2e-5
#: cordic_fixed rounds k = round(u / ln2) and r to Q2.14 from the score
#: itself, so a score a few ulp off (another dot order than XLA's) can move
#: one lane's e^r by one code: one probability code step (2^-14) times the
#: largest value is the most that costs. The GQA scores keep that bound;
#: the MLA scores replay XLA:CPU's dot order (ROADMAP C.4), which took the
#: MLA geometry [3, 8, 1, 13, 16] from 6.03e-5 to 1.2e-7, so MLA is held to
#: ATOL on every impl
CODE = 2.0 ** -14
IMPLS = ("exact", "cordic_pallas", "cordic_fixed")
#: name -> (live lengths per row (0 = vacant), block_len, kv_dtype, seed)
GEOMETRIES = {
    "block_boundaries": ([1, 3, 4, 5, 7, 8, 9, 16, 0, 13], 4, None, 0),
    "single_block_and_vacant": ([2, 0, 17, 5], 16, None, 1),
    "kv_dtype_bf16": ([7, 12], 4, "bfloat16", 5),
}


def _case(klen_list, L, seed, KH=2, G=2, hd=8):
    """Pools/tables/lens; vacant rows get an all-zero table and k_len 1,
    as the engine drives inactive slots."""
    rng = np.random.default_rng(seed)
    B = len(klen_list)
    M = max(-(-k // L) for k in klen_list)
    N = 1 + B * M
    q = rng.normal(size=(B, KH, G, hd)).astype(np.float32)
    kp = rng.normal(size=(N, L, KH, hd)).astype(np.float32)
    vp = rng.normal(size=(N, L, KH, hd)).astype(np.float32)
    tables = np.zeros((B, M), np.int32)
    nxt = 1
    for b, klen in enumerate(klen_list):
        for c in range(-(-klen // L)):
            tables[b, c] = nxt
            nxt += 1
    k_len = np.asarray([max(k, 1) for k in klen_list], np.int32)
    return q, kp, vp, tables, k_len


@functools.lru_cache(maxsize=None)
def _pair(geom, impl):
    klens, L, kvd, seed = GEOMETRIES[geom]
    args = _case(klens, L, seed)
    want = np.asarray(JP.gqa_decode(
        *map(jnp.asarray, args), scale=0.3, softmax_impl=impl,
        kv_dtype=getattr(jnp, kvd) if kvd else None, interpret=True))
    got = P.gqa_decode(*map(torch.from_numpy, args), scale=0.3,
                       softmax_impl=impl,
                       kv_dtype=getattr(torch, kvd) if kvd else None).numpy()
    return args, got, want


def _tol(impl, values):
    return max(ATOL, CODE * np.abs(values).max()) if impl == "cordic_fixed" else ATOL


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("geom", sorted(GEOMETRIES))
def test_gqa_decode_vs_jax(geom, impl):
    args, got, want = _pair(geom, impl)
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() < _tol(impl, args[2]), np.abs(got - want).max()
    np.testing.assert_array_equal(got.reshape(got.shape[0], -1).argmax(-1),
                                  want.reshape(want.shape[0], -1).argmax(-1))


@pytest.mark.parametrize("impl", IMPLS)
def test_vacant_row_leaves_live_rows_bit_unchanged(impl):
    (q, kp, vp, tables, k_len), full, _ = _pair("single_block_and_vacant", impl)
    keep = np.asarray([0, 2, 3])
    sub = P.gqa_decode(torch.from_numpy(q[keep]), torch.from_numpy(kp),
                       torch.from_numpy(vp), torch.from_numpy(tables[keep]),
                       torch.from_numpy(k_len[keep]), scale=0.3,
                       softmax_impl=impl).numpy()
    np.testing.assert_array_equal(full[keep], sub)


def test_kv_dtype_cast_is_load_bearing():
    (q, kp, vp, tables, k_len), got, _ = _pair("kv_dtype_bf16", "exact")
    raw = ops.paged_attend_gqa(*map(torch.from_numpy, (q, kp, vp, tables, k_len)),
                               scale=0.3).numpy()
    assert np.abs(raw - got).max() > 1e-4


def test_canonical_kv_dtype():
    assert P.canonical_kv_dtype(None) is None
    assert P.canonical_kv_dtype("bfloat16") is torch.bfloat16
    assert P.canonical_kv_dtype(torch.float32) is torch.float32
    with pytest.raises(ValueError, match="not a float dtype"):
        P.canonical_kv_dtype(torch.int8)
    with pytest.raises(ValueError, match="unknown kv_dtype"):
        P.canonical_kv_dtype("bf17")


def test_unported_branches_raise():
    """Every branch of the reference is ported (the kv_quant branch is held
    in tests/test_torch_kv_quant.py); an unknown format or a half-wired
    quantized call is refused."""
    args = list(map(torch.from_numpy, _case([3], 4, 0)))
    with pytest.raises(ValueError, match="unknown kv_quant"):
        P.gqa_decode(*args, scale=0.3, kv_quant="int4")
    with pytest.raises(ValueError, match="scale pools come together"):
        P.gqa_decode(*args, scale=0.3, kv_quant="int8")


# ---------------------------------------------------------------------------
# MLA decode: the JAX suite's geometries (tests/test_paged_attention.py:149,
# L 4, H 4, R 16, P 8, scale 0.2): lengths [1], [4], [5], [8], [9],
# [3, 8, 1, 13, 16] and a vacant slot ([6, 0]), as the rows of one batch
# per softmax impl (rows are independent). Same standard: ATOL 2e-5 and an
# unmoved per-row argmax.
# ---------------------------------------------------------------------------
MLA_GEOMETRIES = ([1], [4], [5], [8], [9], [3, 8, 1, 13, 16], [6, 0])


def _mla_case(klen_list, L=4, H=4, R=16, P=8, seed=0):
    rng = np.random.default_rng(seed)
    B = len(klen_list)
    M = max(-(-k // L) for k in klen_list)
    N = 1 + B * M
    qe = rng.normal(size=(B, H, R)).astype(np.float32)
    qr = rng.normal(size=(B, H, P)).astype(np.float32)
    cp = rng.normal(size=(N, L, R)).astype(np.float32)
    rp = rng.normal(size=(N, L, P)).astype(np.float32)
    tables = np.zeros((B, M), np.int32)
    nxt = 1
    for b, klen in enumerate(klen_list):
        for c in range(-(-klen // L)):
            tables[b, c] = nxt
            nxt += 1
    k_len = np.asarray([max(k, 1) for k in klen_list], np.int32)
    return qe, qr, cp, rp, tables, k_len


@functools.lru_cache(maxsize=None)
def _mla_pair(impl):
    klens = [k for g in MLA_GEOMETRIES for k in g]
    args = _mla_case(klens, seed=3)
    want = np.asarray(JP.mla_decode(*map(jnp.asarray, args), scale=0.2,
                                    softmax_impl=impl, interpret=True))
    got = ops.paged_attend_mla(*map(torch.from_numpy, args), scale=0.2,
                               softmax_impl=impl).numpy()
    return args, got, want


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("geom", range(len(MLA_GEOMETRIES)))
def test_mla_decode_vs_jax(geom, impl):
    args, got, want = _mla_pair(impl)
    row0 = sum(len(g) for g in MLA_GEOMETRIES[:geom])
    rows = slice(row0, row0 + len(MLA_GEOMETRIES[geom]))
    got, want = got[rows], want[rows]
    assert got.dtype == np.float32 and np.isfinite(got).all()
    assert np.abs(got - want).max() < ATOL, np.abs(got - want).max()
    np.testing.assert_array_equal(got.reshape(got.shape[0], -1).argmax(-1),
                                  want.reshape(want.shape[0], -1).argmax(-1))


@pytest.mark.parametrize("impl", IMPLS)
def test_mla_vacant_row_leaves_live_rows_bit_unchanged(impl):
    (qe, qr, cp, rp, tables, k_len), full, _ = _mla_pair(impl)
    keep = np.flatnonzero(k_len > 1)
    sub = P.mla_decode(*(torch.from_numpy(a[keep]) for a in (qe, qr)),
                       torch.from_numpy(cp), torch.from_numpy(rp),
                       torch.from_numpy(tables[keep]),
                       torch.from_numpy(k_len[keep]), scale=0.2,
                       softmax_impl=impl).numpy()
    np.testing.assert_array_equal(full[keep], sub)


def test_mla_split_dot_order():
    """The score sum's fixed order, jitted XLA:CPU's for the JAX kernel's
    dots (what the kernel's 4 threads per score compute): 4 strided
    partials of fused multiply-adds, then (p0 + p1) + (p2 + p3); equal to
    the jitted einsum at the decode shapes (heads and lanes >= 4)."""
    import jax

    rng = np.random.default_rng(0)
    q = rng.normal(size=(1, 4, 40)).astype(np.float32)
    c = rng.normal(size=(1, 16, 40)).astype(np.float32)
    assert P.MLA_SPLIT == 4
    part = [np.float32(0.0)] * 4
    for i in range(40):
        t = i % 4
        part[t] = np.float32(np.float64(q[0, 0, i]) * np.float64(c[0, 0, i])
                             + np.float64(part[t]))
    want = np.float32(np.float32(part[0] + part[1]) + np.float32(part[2] + part[3]))
    got = P._split_dot(torch.from_numpy(q), torch.from_numpy(c))
    assert got[0, 0, 0].item() == want
    xla = jax.jit(lambda a, b: jnp.einsum("hr,lr->hl", a, b,
                                          preferred_element_type=jnp.float32))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(xla(q[0], c[0])))


def _fma_orders(q, k):
    """(4 strided fused multiply-add partials then (p0 + p1) + (p2 + p3),
    one sequential fused multiply-add chain) of the dot of two float32
    vectors, in numpy."""
    fma = lambda a, b, c: np.float32(np.float64(a) * np.float64(b) + np.float64(c))
    part, acc = [np.float32(0.0)] * 4, np.float32(0.0)
    for i in range(len(q)):
        part[i % 4] = fma(q[i], k[i], part[i % 4])
        acc = fma(q[i], k[i], acc)
    return np.float32(np.float32(part[0] + part[1]) + np.float32(part[2] + part[3])), acc


@pytest.mark.parametrize("geom,order", [
    ((2, 2, 8, 16), 0),       # the test geometries: G 2, L 4 or 16
    ((4, 8, 128, 16), 0),     # Yi-9B's decode block (block_len 16)
    ((2, 7, 64, 16), 0),      # internvl2-1b's group of 7
    ((32, 1, 64, 16), 1),     # musicgen-large's G 1: one chain
    ((4, 8, 128, 32), 1),     # a block of 32 lanes: one chain
], ids=["test-G2", "yi-G8", "internvl2-G7", "musicgen-G1", "yi-L32"])
def test_gqa_score_dot_order_depends_on_the_geometry(geom, order):
    """ROADMAP C.4's GQA trial: jitted XLA:CPU computes the JAX kernel's
    score dot ``einsum("hgd,lhd->hgl")`` with 4 strided fused multiply-add
    partials when G >= 2 and the block holds <= 16 lanes, and with one
    sequential chain when G is 1 or the block 32 lanes or more. No one
    order fits every geometry, so the port keeps its order and the
    ``cordic_fixed`` code-step bound (``_tol``)."""
    import jax

    KH, G, hd, L = geom
    rng = np.random.default_rng(1)
    q = rng.normal(size=(KH, G, hd)).astype(np.float32)
    k = rng.normal(size=(L, KH, hd)).astype(np.float32)
    xla = np.asarray(jax.jit(lambda a, b: jnp.einsum(
        "hgd,lhd->hgl", a, b, preferred_element_type=jnp.float32))(q, k))
    hits = [0, 0]
    for h in range(min(KH, 2)):
        for g in range(G):
            for l in range(min(L, 4)):
                for i, v in enumerate(_fma_orders(q[h, g], k[l, h])):
                    hits[i] += v == xla[h, g, l]
    n = min(KH, 2) * G * min(L, 4)
    assert hits[order] == n and hits[1 - order] < n, hits


def test_mla_unported_branch_raises():
    """Every softmax impl of the reference is ported; an unknown one is
    refused."""
    assert P.IMPLS == ("exact", "cordic_pallas", "cordic_fixed")
    args = map(torch.from_numpy, _mla_case([3]))
    with pytest.raises(ValueError, match="unknown softmax_impl"):
        P.mla_decode(*args, scale=0.2, softmax_impl="cordic_float")
