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
