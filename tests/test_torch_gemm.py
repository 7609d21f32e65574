"""The row-count-invariant product (``kernels/gemm.py``) on the CPU: its
plain version against a step-by-step numpy replay of the order the SIMT
kernel keeps (one float32 chain over k an element, each product rounded
before its add), within float32 round-off of a float64 product, each row
the same bits at every row count and batch count, and the einsum / matmul
layer against torch's at the model's equations; the route plan (bf16
operands to the tensor-core kernel, any float32 one to the SIMT chain),
TMA's layout rule and its copies, and the bound the tensor-core route is
held to. The kernels themselves are held on the card by ``chip_smoke.py``
(phase 3d, ``--prefill-probe``): the SIMT one bit-equal to the plain
version, the tensor-core one by invariance and by the bound.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import gemm as GM  # noqa: E402
from repro_torch.models import common as cm  # noqa: E402

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
#: the row counts and batch counts each row must not depend on
MS = (1, 3, 16, 17, 64)
BATCHES = (1, 2, 5)
U = 2.0 ** -24                      # float32's unit round-off


def _operands(nb, M, K, N, dtype, seed=0):
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(rng.standard_normal((nb, M, K)).astype(np.float32)).to(dtype)
    b = torch.from_numpy((rng.standard_normal((nb, K, N)) / np.sqrt(K))
                         .astype(np.float32)).to(dtype)
    return a, b


def _numpy_replay(a, b):
    """The kernel's order, step by step in numpy float32: acc = 0, then for
    k in order acc = fl(acc + fl(a_k * b_k))."""
    a, b = a.float().numpy(), b.float().numpy()
    acc = np.zeros((a.shape[0], a.shape[1], b.shape[2]), np.float32)
    for k in range(a.shape[2]):
        prod = (a[:, :, k:k + 1] * b[:, k:k + 1, :]).astype(np.float32)
        acc = (acc + prod).astype(np.float32)
    return acc


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("K", [1, 7, 64, 257])
def test_plain_replays_the_chain_in_numpy(dtype, K):
    a, b = _operands(2, 5, K, 6, DTYPES[dtype], seed=K)
    got = GM.gemm_plain(a, b, torch.float32)
    assert np.array_equal(got.numpy(), _numpy_replay(a, b))
    # the output dtype is one rounding of the float32 chain
    out = GM.gemm_plain(a, b)
    assert out.dtype == DTYPES[dtype]
    assert torch.equal(out, got.to(DTYPES[dtype]))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_plain_within_float32_roundoff_of_float64(dtype):
    """|chain - exact| <= gamma_K sum_k |a_k b_k| (gamma_K = K u / (1 - K u),
    the bound of a recursive sum with rounded products), then the output's
    own rounding: half an ulp of the output dtype."""
    K = 300
    a, b = _operands(3, 8, K, 9, DTYPES[dtype], seed=1)
    a64, b64 = a.double(), b.double()
    exact = a64 @ b64
    mag = a64.abs() @ b64.abs()
    gamma = K * U / (1 - K * U)
    chain = GM.gemm_plain(a, b, torch.float32).double()
    assert bool(((chain - exact).abs() <= gamma * mag).all())
    out = GM.gemm_plain(a, b).double()
    half_ulp = 2.0 ** -8 if dtype == "bf16" else U      # bf16 keeps 8 bits
    assert bool(((out - exact).abs() <= gamma * mag + half_ulp * chain.abs()).all())


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_rows_bit_equal_across_row_and_batch_counts(dtype):
    """A row's bits at every row count of MS and batch count of BATCHES
    equal its bits in the widest product (the property the paged prefill
    relies on); through ``matmul`` (rows flattened) and ``gemm`` (batched,
    a broadcast weight)."""
    K, N = 48, 20
    a, b = _operands(1, max(MS) * max(BATCHES), K, N, DTYPES[dtype], seed=3)
    w = b[0]
    full = GM.matmul(a[0], w)
    for M in MS:
        assert torch.equal(GM.matmul(a[0, :M], w), full[:M]), M
        for nb in BATCHES:
            got = GM.gemm(a[0, :nb * M].view(nb, M, K), w[None].expand(nb, K, N))
            assert torch.equal(got.reshape(nb * M, N), full[:nb * M]), (M, nb)


@pytest.mark.parametrize("eq,sa,sb", [
    ("bqhgd,bkhd->bhgqk", (2, 5, 3, 4, 8), (2, 7, 3, 8)),      # _scores
    ("bhgqk,bkhd->bqhgd", (2, 3, 4, 5, 7), (2, 7, 3, 6)),      # _pv
    ("btl,lhk->bthk", (2, 9, 8), (8, 3, 5)),                   # MLA decompress
])
def test_einsum_is_one_gemm_of_torch_einsum(eq, sa, sb):
    """The einsum layer: the batch, rows, reduction and columns laid out
    for one ``gemm``; within float32 round-off of ``torch.einsum``, and
    each row of the first operand's batch the same bits alone."""
    rng = np.random.default_rng(len(eq))
    a = torch.from_numpy(rng.standard_normal(sa).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(sb).astype(np.float32))
    got = GM.einsum(eq, a, b)
    want = torch.einsum(eq, a, b)
    assert got.shape == want.shape and got.dtype == want.dtype
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert torch.equal(GM.einsum_plain(eq, a, b), got)
    if eq[0] == eq[eq.index(",") + 1]:                          # a batch label
        assert torch.equal(GM.einsum(eq, a[:1], b[:1]), got[:1])


def test_einsum_refuses_what_is_not_one_gemm():
    a, b = torch.zeros(2, 3), torch.zeros(3, 4)
    with pytest.raises(ValueError, match="summed in one operand"):
        GM.einsum("ij,jk->k", a, b)
    with pytest.raises(ValueError, match="unsupported"):
        GM.einsum("ii,ik->ik", torch.zeros(3, 3), b)
    with pytest.raises(ValueError, match="sizes"):
        GM.einsum("ij,jk->ik", a, torch.zeros(4, 4))
    with pytest.raises(ValueError, match="weight"):
        GM.matmul(a, torch.zeros(2, 3, 4))
    with pytest.raises(ValueError, match="batch, M, K"):
        GM.gemm(torch.zeros(2, 3, 4), torch.zeros(3, 4, 5))


def test_unembed_float32_logits_of_bf16_operands():
    """bf16 operands go in as they are: a bf16 product is exact in float32,
    so the logits are those of the float32 operands, bit for bit."""
    rng = np.random.default_rng(5)
    table = torch.from_numpy(rng.standard_normal((11, 16)).astype(np.float32)).bfloat16()
    x = torch.from_numpy(rng.standard_normal((2, 3, 16)).astype(np.float32)).bfloat16()
    got = GM.unembed(table, x)
    assert got.dtype == torch.float32 and got.shape == (2, 3, 11)
    assert torch.equal(got, GM.unembed(table.float(), x.float()))
    torch.testing.assert_close(got, cm.unembed_f32(table, x), rtol=1e-5, atol=1e-5)


def test_meta_tensors_give_the_shape_and_book_the_work():
    """The dry run's meta tensors: an empty result of the right shape and
    dtype, no launch; the work booked is 2MNK and each operand once."""
    a = torch.empty((3, 5, 7), device="meta", dtype=torch.bfloat16)
    b = torch.empty((3, 7, 4), device="meta", dtype=torch.bfloat16)
    c = GM.gemm(a, b, torch.float32)
    assert c.shape == (3, 5, 4) and c.dtype == torch.float32 and c.device.type == "meta"
    assert GM.gemm_work(a, b, torch.float32) == (
        (3 * 5 * 7 + 3 * 7 * 4) * 2 + 3 * 5 * 4 * 4, 0, 2 * 3 * 5 * 4 * 7)


@pytest.mark.parametrize("a_dt,b_dt", [("bf16", "bf16"), ("bf16", "f32"),
                                       ("f32", "bf16"), ("f32", "f32")])
def test_route_plan_by_dtype(a_dt, b_dt):
    """Two bf16 operands take the tensor-core kernel; a float32 one the SIMT
    chain (TF32 would drop its low mantissa bits). The meta path, the dry
    run's, is the same on both routes: no launch, the output's shape and
    dtype."""
    want = "tc" if a_dt == b_dt == "bf16" else "simt"
    assert GM.gemm_route(DTYPES[a_dt], DTYPES[b_dt]) == want
    a = torch.empty((2, 5, 24), device="meta", dtype=DTYPES[a_dt])
    b = torch.empty((2, 24, 9), device="meta", dtype=DTYPES[b_dt])
    for out in (None, torch.float32):
        c = GM.gemm(a, b, out)
        assert c.device.type == "meta" and c.shape == (2, 5, 9)
        assert c.dtype == (out or torch.result_type(a, b))


def _legal(t, unit):
    st = GM._tma_strides(t, unit)
    return (t.data_ptr() % 16 == 0 and st[unit] == 1 and st[3 - unit] % 8 == 0
            and st[0] % 8 == 0)


def _x(*shape):
    return torch.arange(float(np.prod(shape))).view(shape).bfloat16()


#: name -> (operand maker, unit dim, TMA-ready as it is)
TMA_CASES = {
    "contiguous": (lambda: _x(2, 5, 16), 2, True),
    "k-major (a table's transpose)": (lambda: _x(2, 16, 8).transpose(1, 2), 1, True),
    "k-major, 5 rows a column": (lambda: _x(2, 16, 5).transpose(1, 2), 1, False),
    "n-major read k-major": (lambda: _x(2, 5, 16), 1, False),
    "13 of 16 columns": (lambda: _x(2, 5, 16)[:, :, :13], 2, True),
    "row stride 13": (lambda: _x(2, 5, 13), 2, False),
    "base off 16 bytes": (lambda: _x(170)[1:161].view(2, 5, 16), 2, False),
    "broadcast batch": (lambda: _x(1, 5, 16).expand(2, -1, -1), 2, True),
    "one row": (lambda: _x(2, 5, 16)[:, :1, :], 2, True),
    "batch stride 3 rows of 40": (lambda: _x(2, 3, 40)[:, :, :16], 2, True),
}


@pytest.mark.parametrize("case", sorted(TMA_CASES))
def test_tma_copy_rule(case):
    """``tma_ready`` says whether TMA can read an operand in place (unit dim
    stride 1, the other dim's stride a multiple of 8 elements, a 16-byte
    base, a batch stride of 0 or a multiple of 8); ``tma_operand`` returns
    it as it is then, and otherwise a copy that is ready, with the same
    values."""
    make, unit, ready = TMA_CASES[case]
    x = make()
    assert GM.tma_ready(x, unit) == ready == _legal(x, unit)
    y = GM.tma_operand(x, unit)
    assert (y is x) == ready
    assert torch.equal(y, x) and GM.tma_ready(y, unit) and _legal(y, unit)


@pytest.mark.parametrize("out", ["f32", "bf16"])
@pytest.mark.parametrize("K", [64, 4096, 11008])
def test_bound_helper_holds_the_plain_chain(K, out):
    """``gemm_bound``: the float64 product and gamma * sum_k |a_k b_k|. The
    plain chain lies within ``chain_gamma``'s bound, which lies within
    ``tc_gamma``'s (the tensor-core route's, which assumes no
    round-to-nearest inside a k16 step), at the widths of Yi's products (K
    4096, the MLP's down product 11008)."""
    a, b = _operands(1, 3, K, 5, torch.bfloat16, seed=K)
    odt = DTYPES[out]
    got = GM.gemm_plain(a, b, odt).double()
    ref, chain = GM.gemm_bound(a, b, GM.chain_gamma(K, odt))
    _, tc = GM.gemm_bound(a, b, GM.tc_gamma(K, odt))
    assert bool(((got - ref).abs() <= chain).all())
    assert bool((chain <= tc).all())
    assert torch.allclose(ref, a.double() @ b.double())
    assert 0 < GM.chain_gamma(K, odt) < GM.tc_gamma(K, odt) < 0.01 + (odt == torch.bfloat16)


def test_products_route_by_the_cache():
    """``products_of``: a layer dict carrying "products" runs them, every
    other forward torch's."""
    assert cm.products_of(None) is cm.LIBRARY
    assert cm.products_of({"k_pool": None}) is cm.LIBRARY
    assert cm.products_of({"products": cm.INVARIANT}) is cm.INVARIANT
    assert cm.INVARIANT.matmul is GM.matmul and cm.LIBRARY.matmul is torch.matmul
