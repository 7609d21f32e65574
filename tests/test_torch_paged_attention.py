"""PyTorch port of the paged decode kernels (GQA and MLA) against the JAX
kernels.

The geometries of tests/test_paged_attention.py (lengths on and one off the
block boundaries, a single-block slot, a mixed-length batch, a vacant slot
reading scratch block 0, the kv_dtype rounding seam), batched into a few
calls, for the ``exact``, ``cordic_pallas`` and ``cordic_fixed`` softmax
(lengths off the block boundaries leave masked lanes inside a live block,
which ``cordic_fixed`` clips at e^-80 instead of flushing). The CORDIC
impls equal the JAX kernel's outputs bit for bit: both dots of the kernel
(the scores and the P.V sums) run in XLA:CPU's order at these geometries,
and the probabilities are lane-exact. ``exact`` is held to the reference's
own ATOL 2e-5 and an unmoved per-row argmax, and bit for bit once the
port's exponential is XLA's (a test-side stand-in): its exponential is
all that keeps it apart.

The dots' orders (``dot_order`` for the scores, ``pv_order`` for the P.V
sums; ROADMAP C.4) are held bit for bit against jitted ``jnp.einsum`` at
every geometry the engine reaches, and against the JAX kernels' own
scores and P.V sums in interpret mode, eager and jitted, read out of the
kernel by a stand-in for its softmax pass; the geometries whose order is
not mapped are named here.
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


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("geom", sorted(GEOMETRIES))
def test_gqa_decode_vs_jax(geom, impl):
    """Within ATOL 2e-5 with an unmoved argmax on every impl, and bit for
    bit on the CORDIC impls: both dot orders are mapped here."""
    args, got, want = _pair(geom, impl)
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() < ATOL, np.abs(got - want).max()
    np.testing.assert_array_equal(got.reshape(got.shape[0], -1).argmax(-1),
                                  want.reshape(want.shape[0], -1).argmax(-1))
    L = GEOMETRIES[geom][1]
    assert P.dot_order("gqa", 2, 8, L).mapped and P.pv_order("gqa", 2, 8, L).mapped
    if impl != "exact":
        np.testing.assert_array_equal(got, want)


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
    # both dot orders mapped (H 4, R 16, P 8, L 4): the CORDIC impls bit for bit
    assert P.dot_order("mla", 4, 8, 4).mapped and P.pv_order("mla", 4, 16, 4).mapped
    if impl != "exact":
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("geom", sorted(GEOMETRIES) + ["mla"])
def test_exact_decode_differs_from_jax_by_its_exp_alone(geom, monkeypatch):
    """``exact`` with the port's exponential swapped for jitted ``jnp.exp``
    (a test-side stand-in) equals the JAX kernel bit for bit: the scores
    and P.V sums in XLA's order, and the folds ``l = fma(l, alpha, bs)``,
    ``acc = fma(acc, alpha, pv)`` as XLA fuses them, so torch's ``exp``
    against XLA's is all that keeps the outputs apart (ROADMAP C.4)."""
    import jax

    # the cached pairs first: they keep torch's exponential
    args, _, want = _mla_pair("exact") if geom == "mla" else _pair(geom, "exact")
    jexp = jax.jit(jnp.exp)
    monkeypatch.setattr(torch, "exp", lambda x: torch.from_numpy(np.array(jexp(x.numpy()))))
    if geom == "mla":
        got = P.mla_decode(*map(torch.from_numpy, args), scale=0.2).numpy()
    else:
        kvd = GEOMETRIES[geom][2]
        got = P.gqa_decode(*map(torch.from_numpy, args), scale=0.3,
                           kv_dtype=getattr(torch, kvd) if kvd else None).numpy()
    np.testing.assert_array_equal(got, want)


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


#: (kind, KH or None, rows, width, L) of the dot-order map: every arch's
#: G / H and head_dim / kv_lora_rank at the block lengths a user may set,
#: the rank cuts tensor parallelism gives (KH 1 of Yi at tp 4, DeepSeek's
#: 8 heads at tp 2) and each branch of ``dot_order``
DOT_CASES = {
    "test-G2": ("gqa", 2, 2, 8, 16),
    "yi-G8": ("gqa", 4, 8, 128, 16),
    "internvl2-G7": ("gqa", 2, 7, 64, 16),
    "musicgen-G1": ("gqa", 32, 1, 64, 16),
    "yi-L32": ("gqa", 4, 8, 128, 32),
    "yi-L4": ("gqa", 4, 8, 128, 4),
    "yi-L8": ("gqa", 4, 8, 128, 8),
    "yi-L64": ("gqa", 4, 8, 128, 64),
    "yi-L17": ("gqa", 4, 8, 128, 17),
    "yi-tp4-KH1": ("gqa", 1, 8, 128, 16),
    "qwen-G5": ("gqa", 8, 5, 128, 16),
    "command-r-G12": ("gqa", 8, 12, 128, 16),
    "phi-G4-L3": ("gqa", 8, 4, 128, 3),
    "test-G2-L2": ("gqa", 2, 2, 64, 2),
    "yi-L1": ("gqa", 4, 8, 128, 1),
    "qwen-L1": ("gqa", 8, 5, 128, 1),
    "musicgen-G1-L32": ("gqa", 32, 1, 64, 32),
    "smoke-KH1-G1": ("gqa", 1, 1, 16, 16),
    "deepseek-L16": ("mla", None, 16, 512, 16),
    "deepseek-L4": ("mla", None, 16, 512, 4),
    "deepseek-L24": ("mla", None, 16, 512, 24),
    "deepseek-L32": ("mla", None, 16, 512, 32),
    "deepseek-L48": ("mla", None, 16, 512, 48),
    "deepseek-L64": ("mla", None, 16, 512, 64),
    "deepseek-L96": ("mla", None, 16, 512, 96),
    "deepseek-L128": ("mla", None, 16, 512, 128),
    "deepseek-rope-L32": ("mla", None, 16, 64, 32),
    "deepseek-tp2-L32": ("mla", None, 8, 512, 32),
    "deepseek-L1": ("mla", None, 16, 512, 1),
    "deepseek-tp4-L1": ("mla", None, 4, 512, 1),
    "deepseek-H2-L3": ("mla", None, 2, 512, 3),
    "deepseek-H4-L2": ("mla", None, 4, 512, 2),
    "smoke-mla-L16": ("mla", None, 4, 32, 16),
    "smoke-mla-L64": ("mla", None, 4, 32, 64),
}
#: geometries whose order is not mapped (their scores agree with JAX's to
#: f32 round-off only; ROADMAP C.4): a one-row dot LLVM vectorizes and the
#: backend reorders, one query row a KV head at block lengths other than 1
#: and 4-128 by powers of two (the first head's last lane now and then
#: takes another order), a single-lane block between 9 and 15 rows, and
#: past DOT_ORDER_MAX_L lanes
UNMAPPED = {
    "gqa-G1-L9": ("gqa", 2, 1, 16, 9),
    "gqa-G1-L17": ("gqa", 2, 1, 128, 17),
    "gqa-KH1-G1-hd64": ("gqa", 1, 1, 64, 16),
    "mla-H1": ("mla", None, 1, 512, 16),
    "gqa-KH1-L1": ("gqa", 1, 8, 128, 1),
    "mla-H10-L1": ("mla", None, 10, 512, 1),
    "mla-L512": ("mla", None, 16, 512, 512),
}


def _order(kind, KH, rows, width, L):
    return P.dot_order(kind, rows, width, L, **({} if KH is None else {"heads": KH}))


def _operands(kind, KH, rows, width, L, seed=1):
    """(q, k) float32: GQA (KH, G, hd) and (L, KH, hd), MLA (H, R), (L, R)."""
    rng = np.random.default_rng(seed)
    if kind == "gqa":
        return (rng.normal(size=(KH, rows, width)).astype(np.float32),
                rng.normal(size=(L, KH, width)).astype(np.float32))
    return (rng.normal(size=(rows, width)).astype(np.float32),
            rng.normal(size=(L, width)).astype(np.float32))


def _port_dot(kind, q, k, order):
    """The plain versions' scores (before the scale) of one block."""
    q, k = torch.from_numpy(q), torch.from_numpy(k)
    if kind == "gqa":                       # (KH,G,1,hd) . (KH,1,L,hd)
        return P._xla_dot(q[:, :, None], k.permute(1, 0, 2)[:, None], order).numpy()
    return P._xla_dot(q[:, None], k[None], order).numpy()


def _fma_order(a, b, order):
    """One dot of two float32 vectors in ``order``, step by step in numpy."""
    fma = lambda x, y, c: np.float32(np.float64(x) * np.float64(y) + np.float64(c))
    part = [np.float32(0.0)] * order.partials
    for i in range(len(a)):
        t = i % order.partials
        part[t] = fma(a[i], b[i], part[t])
    while len(part) > 1:
        h = len(part) // 2
        part = ([np.float32(part[i] + part[i + h]) for i in range(h)]
                if order.combine == "halve" else
                [np.float32(part[i] + part[i + 1]) for i in range(0, len(part), 2)])
    return part[0]


def test_mla_split_dot_order():
    """``_xla_dot`` replays each order step by step: a chain, 2, 4 and 8
    strided partials of fused multiply-adds, combined as a tree or by
    halves (the kernels' ``order`` argument, 2 * partials + halves)."""
    rng = np.random.default_rng(0)
    q = rng.normal(size=(3, 40)).astype(np.float32)
    c = rng.normal(size=(5, 40)).astype(np.float32)
    orders = [P.DotOrder(1), P.DotOrder(2), P.DotOrder(4), P.DotOrder(8),
              P.DotOrder(4, "halve"), P.DotOrder(8, "halve")]
    assert [o.code for o in orders] == [2, 4, 8, 16, 9, 17]
    outs = []
    for order in orders:
        got = _port_dot("mla", q, c, order)
        want = np.array([[_fma_order(q[h], c[l], order) for l in range(5)]
                         for h in range(3)])
        np.testing.assert_array_equal(got, want)
        outs.append(got)
    assert len({o.tobytes() for o in outs}) == len(outs)     # the orders differ


@pytest.mark.parametrize("case", sorted(DOT_CASES))
def test_gqa_score_dot_order_depends_on_the_geometry(case):
    """ROADMAP C.4: ``dot_order`` gives jitted XLA:CPU's order of the JAX
    kernels' score dots, ``einsum("hgd,lhd->hgl")`` and
    ``einsum("hr,lr->hl")``, bit for bit on every element, at every
    geometry of DOT_CASES (the map in ``dot_order``'s docstring: 4
    partials at G >= 2 and blocks of 4-16 lanes, one chain at G 1 or past
    16 lanes, MLA's 2 partials at L 25-32 and its chain at L 49-64, ...)."""
    import jax

    kind, KH, rows, width, L = DOT_CASES[case]
    order = _order(kind, KH, rows, width, L)
    assert order.mapped, order
    q, k = _operands(kind, KH, rows, width, L)
    spec = "hgd,lhd->hgl" if kind == "gqa" else "hr,lr->hl"
    xla = np.asarray(jax.jit(lambda a, b: jnp.einsum(
        spec, a, b, preferred_element_type=jnp.float32))(q, k))
    got = _port_dot(kind, q, k, order)
    np.testing.assert_array_equal(got, xla)
    if order.partials > 1 or kind == "mla":
        # the geometry tells the orders apart: a chain misses somewhere
        assert not np.array_equal(_port_dot(kind, q, k, P.DotOrder(1)), xla) \
            or not np.array_equal(_port_dot(kind, q, k, P.DotOrder(4)), xla)


@pytest.mark.parametrize("case", sorted(UNMAPPED))
def test_unmapped_dot_orders_are_named(case):
    """The geometries whose XLA:CPU order is not found are flagged
    (``mapped`` False) and take a chain; the kernels run them all the
    same."""
    order = _order(*UNMAPPED[case])
    assert not order.mapped and order.partials == 1


#: (kind, KH or None, rows, width, L) of the P.V order map (``pv_order``):
#: every arch's G / H and head_dim / kv_lora_rank at block lengths a user
#: may set, the rank cuts, each branch and each border of the map
PV_CASES = {
    "yi-L16": ("gqa", 4, 8, 128, 16),
    "yi-L1": ("gqa", 4, 8, 128, 1),
    "yi-L64": ("gqa", 4, 8, 128, 64),
    "yi-L256": ("gqa", 4, 8, 128, 256),
    "yi-tp4-KH1": ("gqa", 1, 8, 128, 16),
    "internvl2-G7": ("gqa", 2, 7, 64, 16),
    "musicgen-G1": ("gqa", 32, 1, 64, 16),
    "qwen-G5-L33": ("gqa", 8, 5, 128, 33),
    "command-r-G12": ("gqa", 8, 12, 128, 16),
    "phi-G4-L3": ("gqa", 8, 4, 128, 3),
    "test-G2-L3": ("gqa", 2, 2, 8, 3),
    "test-G2-L4": ("gqa", 2, 2, 8, 4),
    "test-G2-L16": ("gqa", 2, 2, 8, 16),
    "smoke-KH1-G1": ("gqa", 1, 1, 16, 16),
    "deepseek-L16": ("mla", None, 16, 512, 16),
    "deepseek-L64": ("mla", None, 16, 512, 64),
    "deepseek-L65": ("mla", None, 16, 512, 65),
    "deepseek-L200": ("mla", None, 16, 512, 200),
    "deepseek-L240": ("mla", None, 16, 512, 240),      # pieces of 64: L + H 256
    "deepseek-L241": ("mla", None, 16, 512, 241),      # pieces of 128: past 256
    "deepseek-tp2-L248": ("mla", None, 8, 512, 248),
    "deepseek-tp2-L249": ("mla", None, 8, 512, 249),
    "deepseek-tp4-L100": ("mla", None, 4, 512, 100),
    "mla-H1-L100": ("mla", None, 1, 512, 100),
    "smoke-mla-L64": ("mla", None, 4, 32, 64),
    "mla-R64-L200": ("mla", None, 4, 64, 200),
    "test-mla-L4": ("mla", None, 4, 16, 4),
    "test-mla-L8": ("mla", None, 4, 16, 8),
}
#: geometries whose P.V order is not mapped (their sums agree with JAX's to
#: f32 round-off only; ROADMAP C.4): the narrow widths at L not a multiple
#: of 4 (past 3), one element of G 12 over 8 KV heads at L 170, widths the
#: engine never reaches, past DOT_ORDER_MAX_L lanes
PV_UNMAPPED = {
    "test-G2-L5": ("gqa", 2, 2, 8, 5),
    "command-r-G12-L170": ("gqa", 8, 12, 128, 170),
    "test-mla-L6": ("mla", None, 4, 16, 6),
    "mla-R256": ("mla", None, 16, 256, 16),
    "yi-L512": ("gqa", 4, 8, 128, 512),
}


def _pv_order(kind, KH, rows, width, L):
    return P.pv_order(kind, rows, width, L, **({} if KH is None else {"heads": KH}))


def _port_pv(kind, p, v, order):
    """The plain versions' P.V sums of one block: GQA p (KH, G, L), v (L, KH,
    hd) -> (KH, G, hd); MLA p (H, L), v (L, R) -> (H, R)."""
    p, v = torch.from_numpy(p), torch.from_numpy(v)
    if kind == "gqa":
        return P._xla_pv(p, v.permute(1, 0, 2)[:, None], order).numpy()
    return P._xla_pv(p, v[None], order).numpy()


@pytest.mark.parametrize("case", sorted(PV_CASES))
def test_pv_dot_order_depends_on_the_geometry(case):
    """ROADMAP C.4: ``pv_order`` gives jitted XLA:CPU's order of the JAX
    kernels' P.V dots, ``einsum("hgl,lhd->hgd")`` and ``einsum("hl,lr->hr")``,
    bit for bit on every element, at every geometry of PV_CASES (a fused
    chain at the archs' head_dims; DeepSeek's R 512 in Eigen's pieces of 64
    or 128 lanes past L 64; 4 strided partials at the narrow widths)."""
    import jax

    kind, KH, rows, width, L = PV_CASES[case]
    order = _pv_order(kind, KH, rows, width, L)
    assert order.mapped, order
    rng = np.random.default_rng(L)
    if kind == "gqa":
        p = rng.normal(size=(KH, rows, L)).astype(np.float32)
        v = rng.normal(size=(L, KH, width)).astype(np.float32)
    else:
        p = rng.normal(size=(rows, L)).astype(np.float32)
        v = rng.normal(size=(L, width)).astype(np.float32)
    spec = "hgl,lhd->hgd" if kind == "gqa" else "hl,lr->hr"
    xla = np.asarray(jax.jit(lambda a, b: jnp.einsum(
        spec, a, b, preferred_element_type=jnp.float32))(p, v))
    np.testing.assert_array_equal(_port_pv(kind, p, v, order), xla)
    if order.partials > 1 or order.chunk:
        # the geometry tells the orders apart: one chain misses somewhere
        assert not np.array_equal(_port_pv(kind, p, v, P.DotOrder(1)), xla)


@pytest.mark.parametrize("case", sorted(PV_UNMAPPED))
def test_unmapped_pv_orders_are_named(case):
    """The geometries whose P.V order is not found are flagged and take
    one chain; the kernels run them all the same."""
    order = _pv_order(*PV_UNMAPPED[case])
    assert not order.mapped and (order.partials, order.chunk) == (1, 0)


#: (kind, KH or None, rows, width, L, how): the JAX kernels themselves in
#: interpret mode, eager or jitted, on float32, bfloat16-rounded and int8
#: pools
KERNEL_CASES = [
    ("gqa", 2, 2, 8, 4, "eager"), ("gqa", 2, 2, 8, 16, "eager"),
    ("gqa", 4, 8, 128, 16, "jit"), ("gqa", 4, 8, 128, 32, "jit"),
    ("gqa", 32, 1, 64, 16, "eager"), ("gqa", 2, 5, 64, 1, "jit"),
    ("gqa", 2, 2, 64, 16, "bfloat16"), ("gqa", 2, 4, 64, 32, "int8"),
    ("mla", None, 4, 32, 16, "eager"), ("mla", None, 4, 32, 32, "jit"),
    ("mla", None, 16, 512, 32, "eager"), ("mla", None, 4, 32, 64, "eager"),
]


@pytest.mark.parametrize("case", KERNEL_CASES, ids=lambda c: "-".join(map(str, c)))
def test_jax_kernel_scores_take_the_mapped_order(case, monkeypatch):
    """The scores the JAX kernel computes inside ``gqa_decode`` /
    ``mla_decode`` (interpret mode, as the JAX suite and the engine run
    it), read out by a stand-in for ``_pass_update`` that writes them to
    the output, equal the plain versions' (the mapped dot, then times the
    scale) bit for bit: the JIT picks the kernel dot's order as it picks a
    bare einsum's."""
    import jax

    from repro.core import kv_quant as jkvq
    from repro_torch.core import kv_quant as kvq

    kind, KH, rows, width, L, how = case
    n = min(L, width)

    def probe(s, v, p, impl, sched, cfg, m_sc, l_sc, acc_sc, contract):
        acc_sc[..., :n] = s[..., :n]
        l_sc[...] = jnp.ones_like(l_sc[...])

    monkeypatch.setattr(JP, "_pass_update", probe)
    q, k = _operands(kind, KH, rows, width, L, seed=2)
    table, k_len = np.array([[1]], np.int32), np.array([L], np.int32)
    pool = lambda x: np.concatenate([np.zeros_like(x)[None], x[None]])
    kw = dict(scale=0.3, interpret=True)
    if kind == "gqa":
        kf = k
        if how == "bfloat16":
            kw["kv_dtype"] = jnp.bfloat16
            kf = torch.from_numpy(k).bfloat16().float().numpy()
        if how == "int8":
            spec = kvq.spec_for("int8")
            sc = kvq.block_scale(torch.from_numpy(pool(k)), spec)
            codes = kvq.quantize(torch.from_numpy(pool(k)), spec, sc)
            kf = kvq.dequantize(codes, spec, sc)[1].numpy()
            kw.update(kv_quant="int8", k_scale_pool=jnp.asarray(sc.numpy()),
                      v_scale_pool=jnp.asarray(sc.numpy()))
            kp = jnp.asarray(codes.numpy())
            assert jkvq.spec_for("int8") is not None
        else:
            kp = jnp.asarray(pool(k))
        fn = lambda a: JP.gqa_decode(jnp.asarray(q[None]), a, a, jnp.asarray(table),
                                     jnp.asarray(k_len), **kw)
        want = _port_dot(kind, q, kf, _order(kind, KH, rows, width, L)) * np.float32(0.3)
    else:
        zr = np.zeros((rows, 8), np.float32)
        fn = lambda a: JP.mla_decode(jnp.asarray(q[None]), jnp.asarray(zr[None]), a,
                                     jnp.asarray(np.zeros((2, L, 8), np.float32)),
                                     jnp.asarray(table), jnp.asarray(k_len), **kw)
        kp = jnp.asarray(pool(k))
        # the rope dot of zero queries adds +0 to each score
        want = _port_dot(kind, q, k, _order(kind, None, rows, 8, L)) * np.float32(0.3)
    got = np.asarray((jax.jit(fn) if how == "jit" else fn)(kp))[0]
    np.testing.assert_array_equal(got[..., :n], want[..., :n])


#: (kind, KH or None, rows, width, L, how): the JAX kernels' P.V sums in
#: interpret mode, eager or jitted, on float32 and int8 pools
PV_KERNEL_CASES = [
    ("gqa", 2, 2, 8, 16, "eager"), ("gqa", 4, 8, 128, 32, "jit"),
    ("gqa", 32, 1, 64, 16, "eager"), ("gqa", 2, 4, 64, 16, "int8"),
    ("mla", None, 16, 512, 16, "eager"), ("mla", None, 16, 512, 80, "jit"),
    ("mla", None, 4, 16, 8, "eager"),
]


@pytest.mark.parametrize("case", PV_KERNEL_CASES, ids=lambda c: "-".join(map(str, c)))
def test_jax_kernel_pv_sums_take_the_mapped_order(case, monkeypatch):
    """The P.V sums the JAX kernel computes inside ``gqa_decode`` /
    ``mla_decode`` (interpret mode), read out by a stand-in for
    ``_pass_update`` that contracts the block's scores with its values
    through the kernel's own ``contract`` and writes them to the output,
    equal the plain versions' (``_xla_pv`` in ``pv_order`` over the mapped
    scores) bit for bit: the JIT orders the kernel's second einsum as it
    orders a bare one."""
    import jax

    from repro_torch.core import kv_quant as kvq

    kind, KH, rows, width, L, how = case

    def probe(s, v, p, impl, sched, cfg, m_sc, l_sc, acc_sc, contract):
        acc_sc[...] = contract(s, v)
        l_sc[...] = jnp.ones_like(l_sc[...])

    monkeypatch.setattr(JP, "_pass_update", probe)
    q, k = _operands(kind, KH, rows, width, L, seed=3)
    _, v = _operands(kind, KH, rows, width, L, seed=4)
    table, k_len = np.array([[1]], np.int32), np.array([L], np.int32)
    pool = lambda x: np.concatenate([np.zeros_like(x)[None], x[None]])
    kw = dict(scale=0.3, interpret=True)
    if kind == "gqa":
        vf, kp, vp = v, jnp.asarray(pool(k)), jnp.asarray(pool(v))
        if how == "int8":
            spec = kvq.spec_for("int8")
            ks, vs = (kvq.block_scale(torch.from_numpy(pool(x)), spec) for x in (k, v))
            kc, vc = (kvq.quantize(torch.from_numpy(pool(x)), spec, sc)
                      for x, sc in ((k, ks), (v, vs)))
            k, vf = (kvq.dequantize(c, spec, sc)[1].numpy() for c, sc in ((kc, ks), (vc, vs)))
            kw.update(kv_quant="int8", k_scale_pool=jnp.asarray(ks.numpy()),
                      v_scale_pool=jnp.asarray(vs.numpy()))
            kp, vp = jnp.asarray(kc.numpy()), jnp.asarray(vc.numpy())
        fn = lambda a, b: JP.gqa_decode(jnp.asarray(q[None]), a, b, jnp.asarray(table),
                                        jnp.asarray(k_len), **kw)
        s = _port_dot(kind, q, k, _order(kind, KH, rows, width, L)) * np.float32(0.3)
        got = np.asarray((jax.jit(fn) if how == "jit" else fn)(kp, vp))[0]
    else:
        zr = np.zeros((rows, 8), np.float32)
        fn = lambda a: JP.mla_decode(jnp.asarray(q[None]), jnp.asarray(zr[None]), a,
                                     jnp.asarray(np.zeros((2, L, 8), np.float32)),
                                     jnp.asarray(table), jnp.asarray(k_len), **kw)
        vf = k                                       # MLA's values are its latent rows
        s = _port_dot(kind, q, k, _order(kind, None, rows, 8, L)) * np.float32(0.3)
        got = np.asarray((jax.jit(fn) if how == "jit" else fn)(jnp.asarray(pool(k))))[0]
    order = _pv_order(kind, KH, rows, width, L)
    assert order.mapped, order
    np.testing.assert_array_equal(got, _port_pv(kind, s.astype(np.float32), vf, order))


def test_mla_unported_branch_raises():
    """Every softmax impl of the reference is ported; an unknown one is
    refused."""
    assert P.IMPLS == ("exact", "cordic_pallas", "cordic_fixed")
    args = map(torch.from_numpy, _mla_case([3]))
    with pytest.raises(ValueError, match="unknown softmax_impl"):
        P.mla_decode(*args, scale=0.2, softmax_impl="cordic_float")
