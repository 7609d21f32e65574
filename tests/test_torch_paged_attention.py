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
#: largest value is the most that costs (measured once, MLA geometry
#: [3, 8, 1, 13, 16]: 6.03e-5 against a bound of 2.4e-4)
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
    args = map(torch.from_numpy, _case([3], 4, 0))
    with pytest.raises(NotImplementedError, match="ROADMAP B.6"):
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
    assert np.abs(got - want).max() < _tol(impl, args[2]), np.abs(got - want).max()
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
    """The score sum's fixed order: 16 strided partials, then left to right
    (what the kernel's 16 threads per score compute)."""
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.normal(size=(1, 1, 40)).astype(np.float32))
    c = torch.from_numpy(rng.normal(size=(1, 1, 40)).astype(np.float32))
    part = [np.float32(0.0)] * P.MLA_SPLIT
    for i in range(40):
        t = i % P.MLA_SPLIT
        part[t] = np.float32(part[t] + np.float32(q[0, 0, i] * c[0, 0, i]))
    want = part[0]
    for t in range(1, P.MLA_SPLIT):
        want = np.float32(want + part[t])
    assert P._split_dot(q, c).item() == want


def test_mla_unported_branch_raises():
    """Every softmax impl of the reference is ported; an unknown one is
    refused."""
    assert P.IMPLS == ("exact", "cordic_pallas", "cordic_fixed")
    args = map(torch.from_numpy, _mla_case([3]))
    with pytest.raises(ValueError, match="unknown softmax_impl"):
        P.mla_decode(*args, scale=0.2, softmax_impl="cordic_float")
