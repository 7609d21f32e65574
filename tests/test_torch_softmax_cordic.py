"""PyTorch port of the CORDIC softmax kernels against the JAX kernels.

No tolerance: the port sums each row in jitted XLA:CPU's order over the
row padded to 128 lanes (``softmax_cordic._xla_row_sum``), so softmax and
log-softmax equal the JAX kernels in interpret mode bit for bit. The edge
cases are rows whose sum lands on a rounding edge of its Q2.14 mantissa,
where another order moves a lane by a code step.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import softmax_cordic as JS  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import softmax_cordic as S  # noqa: E402

#: one Q2.14 code step of a probability: 2^-14 of a quotient in (0.175, 0.71)
REL_STEP = 2.0 ** -14 / 0.175


def _rows(seed, rows, cols, scale=4.0):
    x = np.random.default_rng(seed).normal(size=(rows, cols)).astype(np.float32)
    return x * np.float32(scale)


def _attention_rows():
    """(32, 128): random rows, a causal staircase of -1e30 masks, a fully
    masked row (the reference makes it uniform) and rows whose far lanes
    sit more than e^-20 below the max (exactly 0 out)."""
    x = _rows(7, 32, 128)
    for r in range(8, 20):
        x[r, (r - 8) * 10 + 1:] = -1e30
    x[20, :] = -1e30
    x[21:24, :] = 0.0
    x[21:24, 0] = 25.0
    x[21:24, 1] = 10.0
    return x


def _edge_rows(seed, cols, picks):
    """Rows of a (300, cols) scale-0.5 draw whose sums land on a rounding
    edge: a left-to-right sum moves their lanes by a code step (seen with
    the port's plain stages on the CPU)."""
    return _rows(seed, 300, cols, scale=0.5)[picks]


CASES = {"attention_rows": _attention_rows, "wide_rows": lambda: _rows(3, 8, 300),
         "edge_rows": lambda: _edge_rows(2, 4096, [41, 164, 257]),
         "edge_ragged": lambda: _edge_rows(3, 4000, [62])}


@functools.lru_cache(maxsize=None)
def _pair(case):
    x = CASES[case]()
    want = np.asarray(JS.softmax_2d(jnp.asarray(x), interpret=True))
    got = S.softmax_2d(torch.from_numpy(x)).numpy()
    return x, got, want


@pytest.mark.parametrize("case", sorted(CASES))
def test_softmax_2d_vs_jax_bit_exact(case):
    _, got, want = _pair(case)
    np.testing.assert_array_equal(got, want)


def _left_to_right(x: torch.Tensor) -> torch.Tensor:
    acc = torch.zeros(x.shape[:-1] + (1,))
    for i in range(x.shape[-1]):
        acc = acc + x[..., i:i + 1]
    return acc


@pytest.mark.parametrize("case", ["edge_rows", "edge_ragged"])
def test_softmax_edge_rows_need_xla_order(case, monkeypatch):
    """The left-to-right row sum (the order of the port before the replay)
    misses the JAX kernel on every edge row."""
    x, _, want = _pair(case)
    monkeypatch.setattr(S, "_xla_row_sum", _left_to_right)
    got = S.softmax_2d_plain(torch.from_numpy(x)).numpy()
    assert (got != want).any(axis=-1).all()


def test_softmax_2d_masked_rows():
    x, got, _ = _pair("attention_rows")
    masked = x[8:20] == np.float32(-1e30)
    assert (got[8:20][masked] == 0).all()
    assert (got[8, 1:] == 0).all() and got[8, 0] > 0.99
    np.testing.assert_allclose(got[20], np.full(128, 1 / 128), rtol=REL_STEP)


def test_softmax_2d_dead_lanes_exactly_zero():
    _, got, _ = _pair("attention_rows")
    assert (got[21:24, 2:] == 0).all() and (got[21:24, :2] > 0).all()


def test_ops_softmax_any_axis():
    x = torch.from_numpy(_rows(9, 6, 40).reshape(2, 3, 40)).permute(0, 2, 1)
    y = ops.softmax(x, axis=1)
    assert y.shape == x.shape
    want = S.softmax_2d(x.permute(0, 2, 1).reshape(-1, 40).contiguous())
    assert torch.equal(y.permute(0, 2, 1).reshape(-1, 40), want)


@pytest.mark.parametrize("cols", [32, 128, 300, 512, 4000, 4096, 64000])
def test_row_sum_is_xla_order(cols):
    """The order the CUDA kernels reproduce: jitted jnp.sum of the row
    zero-padded to the JAX kernel's 128-lane width, bit for bit."""
    e = np.abs(_rows(cols, 4, cols, scale=1.0)) * np.float32(1e3)
    cols_p = S.cols_padded(cols)
    padded = np.pad(e, ((0, 0), (0, cols_p - cols)))
    want = np.asarray(jax.jit(lambda a: jnp.sum(a, axis=-1, keepdims=True))(padded))
    np.testing.assert_array_equal(S._xla_row_sum(torch.from_numpy(e)).numpy(), want)


# ---------------------------------------------------------------------------
# log_softmax_2d: bit-exact, the same row-sum order
# ---------------------------------------------------------------------------
def _log_softmax_rows():
    """(40, 1000): random rows; a masked tail, a fully masked row, extreme
    and huge-spread logits; rows 30-31 sum onto a mantissa rounding edge in
    XLA's order (seen with jax 0.9 on the CPU)."""
    x = _rows(11, 40, 1000)
    x[1, 400:] = -1e30
    x[2, :] = -1e30
    x[3, :] = 0.0
    x[3, 0] = 1e4
    x[4] *= 1000.0
    x[5, :10] = 3e4
    x[6, 1:] = -1e30
    edge = np.random.default_rng(5).normal(size=(2000, 1000)).astype(np.float32)
    x[30:32] = edge[[953, 1555]] * np.float32(0.5)
    return x


LOG_CASES = {"mixed_rows": _log_softmax_rows,
             "vocab_rows": lambda: _rows(12, 4, 64000, scale=3.0),
             "ragged_width": lambda: _rows(13, 6, 300, scale=10.0),
             "narrow": lambda: _rows(14, 3, 7, scale=1.0)}


@functools.lru_cache(maxsize=None)
def _log_pair(case):
    x = LOG_CASES[case]()
    want = np.asarray(JS.log_softmax_2d(jnp.asarray(x), interpret=True))
    got = S.log_softmax_2d(torch.from_numpy(x)).numpy()
    return x, got, want


@pytest.mark.parametrize("case", sorted(LOG_CASES))
def test_log_softmax_2d_vs_jax_bit_exact(case):
    _, got, want = _log_pair(case)
    np.testing.assert_array_equal(got, want)


def test_log_softmax_2d_masked_and_extreme_rows():
    x, got, _ = _log_pair("mixed_rows")
    assert (got[1, 400:] < -1e29).all() and np.isfinite(got[1, :400]).all()
    # a fully masked row is uniform: -ln(cols) to the vectoring's accuracy
    np.testing.assert_allclose(got[2], np.full(1000, -np.log(1000.0)), atol=1e-3)
    # one live lane: log p = -ln 1, which the vectoring gives to 2^-12
    assert abs(got[6, 0]) < 2.0 ** -12 and (got[6, 1:] < -1e29).all()
    assert abs(got[3, 0]) < 2.0 ** -12 and (got[3, 1:] < -9000).all()
    assert got[5, :10].max() < 0.0
    assert np.isfinite(got[[0, 3, 4, 5]]).all()


def _block_order(x: torch.Tensor, threads: int = 256) -> torch.Tensor:
    """The log-softmax kernel's order before the replay: thread t adds
    lanes t, t+T, ... left to right, then a pairwise tree of the partials."""
    rows, cols = x.shape
    n = -(-cols // threads) * threads
    steps = torch.nn.functional.pad(x, (0, n - cols)).view(rows, n // threads, threads)
    parts = torch.zeros(rows, threads)
    for i in range(steps.shape[1]):
        parts = parts + steps[:, i]
    while parts.shape[1] > 1:
        half = parts.shape[1] // 2
        parts = parts[:, :half] + parts[:, half:]
    return parts


def test_log_softmax_edge_rows_need_xla_order(monkeypatch):
    """Rows 30-31 of the mixed case: the block order misses the JAX kernel
    on every lane of both rows (ln S moves by a few vectoring codes)."""
    x, _, want = _log_pair("mixed_rows")
    monkeypatch.setattr(S, "_xla_row_sum", _block_order)
    got = S.log_softmax_2d_plain(torch.from_numpy(x[30:32])).numpy()
    assert (got != want[30:32]).all()
    assert np.abs(got - want[30:32]).max() <= 2 * 4 * 2.0 ** -14


def test_ops_log_softmax_any_axis():
    x = torch.from_numpy(_rows(16, 6, 40).reshape(2, 3, 40)).permute(0, 2, 1)
    y = ops.log_softmax(x, axis=1)
    assert y.shape == x.shape
    want = S.log_softmax_2d(x.permute(0, 2, 1).reshape(-1, 40).contiguous())
    assert torch.equal(y.permute(0, 2, 1).reshape(-1, 40), want)


# ---------------------------------------------------------------------------
# log_softmax_plan: the kernel's split of a row over a thread-block cluster
# ---------------------------------------------------------------------------
def _check_plan(plan):
    n1 = S.cols_padded(plan.cols) // 32
    slices = plan.slices()
    assert len(slices) == plan.cluster and 1 <= plan.cluster <= S.LS_MAX_CLUSTER
    covered = [w for a, b in slices for w in range(a, b)]
    assert covered == list(range(n1))            # every window once, in order
    assert all(0 < b - a <= plan.windows for a, b in slices)
    assert plan.smem <= S.SMEM_LIMIT
    tail = 4 * (n1 + n1 // 32 + 1 + S.LS_WARPS + 2)
    assert plan.smem == tail + (128 * plan.windows if plan.staged else 0)


@pytest.mark.parametrize("cols", [5, 128, 300, 4000, 32000, 64000, 102400, 152064, 256000])
def test_log_softmax_plan_covers_the_row(cols):
    plan = S.log_softmax_plan(cols)
    _check_plan(plan)
    # every registry width up to 256,000 lanes keeps its row in shared memory
    assert plan.staged
    # a window a thread up to a cluster of 8 CTAs
    assert plan.windows <= S.LS_THREADS or plan.cluster == S.LS_MAX_CLUSTER


def test_log_softmax_plan_registry_vocabularies():
    for arch in configs.ARCH_IDS:
        for cfg in (configs.get_config(arch), configs.get_smoke(arch)):
            plan = S.log_softmax_plan(cfg.vocab_size)
            _check_plan(plan)
            assert plan.staged


def test_log_softmax_plan_wide_rows():
    # past ~360,000 lanes a cluster's slices no longer fit: read from L2
    wide = S.log_softmax_plan(400000)
    _check_plan(wide)
    assert not wide.staged and wide.cluster == S.LS_MAX_CLUSTER
    with pytest.raises(ValueError, match="shared memory"):
        S.log_softmax_plan(2_000_000)
    # a split other than the chosen one, as the kernel takes it
    plan = S.LogSoftmaxPlan(4000, 3, 43, True)
    _check_plan(plan)
    assert plan.slices() == [(0, 43), (43, 86), (86, 128)]


@pytest.mark.parametrize("cols,cluster,windows,staged,match", [
    (64000, 8, 100, True, "do not split"),       # 800 of 2000 windows
    (64000, 8, 300, True, "do not split"),       # the last CTA holds none
    (64000, 9, 223, True, "cluster"),
    (64000, 0, 2000, True, "cluster"),
    (400000, 8, 1563, True, "shared memory"),    # 200 KB of row a CTA
])
def test_log_softmax_bad_plan_raises(cols, cluster, windows, staged, match):
    with pytest.raises(ValueError, match=match):
        S.LogSoftmaxPlan(cols, cluster, windows, staged)
