"""PyTorch port of the CORDIC softmax kernel against the JAX kernel.

Tolerance: the row sum runs left to right in the port and in XLA's own order
in the JAX kernel, so where a sum lands on a rounding edge of its Q2.14
mantissa every lane of that row moves by one Q2.14 code step of its
probability. One step is 2^-14 of a quotient in (0.175, 0.71), so at most
3.5e-4 of the lane's value. Most lanes are bit-equal; dead lanes are exactly
0 on both sides.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import softmax_cordic as JS  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import softmax_cordic as S  # noqa: E402

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


CASES = {"attention_rows": _attention_rows, "wide_rows": lambda: _rows(3, 8, 300)}


@functools.lru_cache(maxsize=None)
def _pair(case):
    x = CASES[case]()
    want = np.asarray(JS.softmax_2d(jnp.asarray(x), interpret=True))
    got = S.softmax_2d(torch.from_numpy(x)).numpy()
    return x, got, want


@pytest.mark.parametrize("case", sorted(CASES))
def test_softmax_2d_vs_jax_within_one_code_step(case):
    _, got, want = _pair(case)
    np.testing.assert_array_equal(got == 0, want == 0)
    assert (np.abs(got - want) <= REL_STEP * want + 1e-30).all()
    assert (got == want).mean() > 0.9


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


def test_row_sum_is_left_to_right():
    """The order the CUDA kernel reproduces: ((0 + e0) + e1) + ..."""
    e = torch.from_numpy(_rows(5, 3, 33, scale=1.0)).abs()
    want = torch.zeros(3)
    for i in range(33):
        want = want + e[:, i]
    assert torch.equal(S._seq_sum(e)[:, 0], want)


# ---------------------------------------------------------------------------
# log_softmax_2d: tolerance LOG_SOFTMAX_ATOL (the module docstring): the row
# sum's order differs from XLA's, so where it lands on a rounding edge of its
# Q2.14 mantissa ln S moves by a few vectoring codes on every lane of the row
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
def test_log_softmax_2d_vs_jax_within_atol(case):
    _, got, want = _log_pair(case)
    assert np.abs(got - want).max() <= S.LOG_SOFTMAX_ATOL
    assert (got == want).mean() > 0.9


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


def test_log_softmax_plain_sum_is_block_order():
    """The order csrc/softmax.cu sums a row in: thread t adds lanes t, t+T,
    ... left to right, then a pairwise tree adds the T partials."""
    T = S.LOG_SOFTMAX_T
    e = torch.from_numpy(_rows(15, 3, 3 * T + 17, scale=1.0)).abs()
    parts = []
    for t in range(T):
        acc = torch.zeros(3)
        for c in range(t, e.shape[1], T):
            acc = acc + e[:, c]
        parts.append(acc)
    while len(parts) > 1:
        half = len(parts) // 2
        parts = [parts[i] + parts[i + half] for i in range(half)]
    assert torch.equal(S._block_sum(e)[:, 0], parts[0])


def test_ops_log_softmax_any_axis():
    x = torch.from_numpy(_rows(16, 6, 40).reshape(2, 3, 40)).permute(0, 2, 1)
    y = ops.log_softmax(x, axis=1)
    assert y.shape == x.shape
    want = S.log_softmax_2d(x.permute(0, 2, 1).reshape(-1, 40).contiguous())
    assert torch.equal(y.permute(0, 2, 1).reshape(-1, 40), want)
