"""PyTorch port of the CORDIC activation kernels against the JAX package.

The port's plain versions (what a CPU tensor runs through; the CUDA kernels
are held against them on the card by chip_smoke.py) must be bit-exact with
the golden vectors and with the JAX Pallas kernels in interpret mode.
"""
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import cordic_act as JK  # noqa: E402
from repro_torch.cordic_engine.core import PAPER_FIXED  # noqa: E402
from repro_torch.cordic_engine.schedule import PAPER_SCHEDULE  # noqa: E402
from repro_torch.kernels import cordic_act as K  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

GOLDEN = pathlib.Path(__file__).parent / "golden"
ALL_CODES = torch.arange(-(1 << 15), 1 << 15, dtype=torch.int32)


def _golden(name):
    with np.load(GOLDEN / f"{name}_q2_14.npz") as z:
        return z["y"].astype(np.int32)


def test_sigmoid_all_codes_match_golden():
    got = K._cordic_sigmoid_q(ALL_CODES, PAPER_SCHEDULE, PAPER_FIXED).numpy()
    np.testing.assert_array_equal(got, _golden("sigmoid"))


def test_tanh_all_codes_match_golden():
    got = K._cordic_tanh_q(ALL_CODES, PAPER_SCHEDULE, PAPER_FIXED).numpy()
    np.testing.assert_array_equal(got, _golden("tanh"))


def _inputs(seed, shape=(48, 256), scale=3.0):
    """Normal draws plus the range-extension boundaries and clamp edges."""
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32) * scale
    edges = np.array([0.0, 0.5, -0.5, 1.0, -1.0, 2.0, -2.0, 4.0, -4.0, 8.0,
                      -8.0, 12.0, -30.0, 1e-7, 2.0 ** -15], np.float32)
    x.reshape(-1)[:edges.size] = edges
    return x


@pytest.mark.parametrize("op", ("sigmoid", "tanh", "sigmoid_wide", "silu"))
def test_act_2d_bit_exact_vs_jax(op):
    x = _inputs(1)
    want = np.asarray(JK.act_2d(jnp.asarray(x), op, interpret=True))
    got = K.act_2d(torch.from_numpy(x), op).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_silu_mul_2d_bit_exact_vs_jax(dtype):
    g = _inputs(2, scale=4.0)
    u = np.random.default_rng(3).normal(size=g.shape).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = getattr(torch, dtype)
    want = np.asarray(JK.silu_mul_2d(jnp.asarray(g, jdt), jnp.asarray(u, jdt),
                                     interpret=True).astype(jnp.float32))
    got = K.silu_mul_2d(torch.from_numpy(g).to(tdt),
                        torch.from_numpy(u).to(tdt)).float().numpy()
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# The three multiply-adds that jitted XLA fuses: the port's fused form must
# match on every lane, and the two-step form must not (else the pin is moot)
# ---------------------------------------------------------------------------
_LN2 = np.float32(np.log(2.0))
_INV_LN2 = np.float32(1.0 / np.log(2.0))
_N = 1 << 16


def _lanes(seed, lo, hi):
    return np.random.default_rng(seed).uniform(lo, hi, _N).astype(np.float32)


def test_fma_row_dyadic_remainder():
    """r = u - k * ln2 (softmax_cordic.py:72, paged_attention.py:149)."""
    u = _lanes(10, -20.0, 0.0)
    k = np.floor(u * _INV_LN2 + np.float32(0.5)).astype(np.float32)
    want = np.asarray(jax.jit(lambda a, b: a - b * _LN2)(u, k))
    ut, kt = torch.from_numpy(u), torch.from_numpy(k)
    np.testing.assert_array_equal(K._fma_r(ut, kt).numpy(), want)
    assert ((ut - kt * float(_LN2)).numpy() != want).any()


def test_fma_row_dyadic_exponent():
    """u * (1/ln2) + 0.5 (softmax_cordic.py:71, paged_attention.py:148)."""
    u = _lanes(11, -20.0, 0.0)
    want = np.asarray(jax.jit(lambda a: a * _INV_LN2 + 0.5)(u))
    ut = torch.from_numpy(u)
    np.testing.assert_array_equal(K._fma_log2e_half(ut).numpy(), want)
    assert ((ut * float(_INV_LN2) + 0.5).numpy() != want).any()


def test_fma_row_doubling_denominator():
    """s2 + (1-s)(1-s) with s2 = s*s also the numerator (cordic_act.py:289):
    XLA rounds s2 once and fuses the other product, fma(1-s, 1-s, s2)."""
    s = _lanes(12, 0.0, 1.0)

    def ref(a):
        s2 = a * a
        return s2 / jnp.maximum(s2 + (1.0 - a) * (1.0 - a), np.float32(1e-12))

    want = np.asarray(jax.jit(ref)(s))
    st = torch.from_numpy(s)
    s2 = st * st
    np.testing.assert_array_equal((s2 / K._fma_denom(st, s2)).numpy(), want)
    two_step = s2 / (s2 + (1 - st) * (1 - st))
    other_fma = s2 / (st.double() * st.double()
                      + ((1 - st) * (1 - st)).double()).float()
    assert (two_step.numpy() != want).any()
    assert (other_fma.numpy() != want).any()


def test_fixed_point_helpers_match_jax():
    from repro.core import fixed_point as jfp
    from repro_torch.core import fixed_point as fp

    x = _inputs(5).reshape(-1) / 2
    codes = np.random.default_rng(6).integers(-(1 << 20), 1 << 20, x.size)
    np.testing.assert_array_equal(
        fp.quantize(torch.from_numpy(x)).numpy(),
        np.asarray(jfp.quantize(jnp.asarray(x), jfp.Q2_14)))
    np.testing.assert_array_equal(
        fp.wrap(torch.from_numpy(codes.astype(np.int32)), fp.Q2_14).numpy(),
        np.asarray(jfp.wrap(jnp.asarray(codes, jnp.int32), jfp.Q2_14)))
    q = torch.arange(-(1 << 15), 1 << 15, dtype=torch.int32)
    np.testing.assert_array_equal(
        fp.dequantize(q).numpy(),
        np.asarray(jfp.dequantize(jnp.asarray(q.numpy()), jfp.Q2_14)))


# ---------------------------------------------------------------------------
# Front door
# ---------------------------------------------------------------------------
def test_ops_flatten_any_rank_and_keep_dtype():
    x = torch.from_numpy(_inputs(4, shape=(3, 5, 7)))
    for fn, op in ((ops.sigmoid, "sigmoid"), (ops.tanh, "tanh"),
                   (ops.sigmoid_wide, "sigmoid_wide"), (ops.silu, "silu")):
        y = fn(x)
        assert y.shape == x.shape and y.dtype == x.dtype
        assert torch.equal(y.view(-1), K.act_2d_plain(x.reshape(-1), op))
    yb = ops.silu_mul(x.bfloat16(), x.bfloat16())
    assert yb.shape == x.shape and yb.dtype == torch.bfloat16


@pytest.mark.parametrize("op", ["gelu"])
def test_unported_ops_raise(op):
    """Every op of the reference's act_2d is ported (gelu_erf last); a name
    it does not have is refused."""
    assert K.OPS[-1] == "gelu_erf"
    with pytest.raises(ValueError, match="unknown act op"):
        K.act_2d(torch.zeros(4), op)


# ---------------------------------------------------------------------------
# The exp and log legs (ops exp, log, softplus, elu)
# ---------------------------------------------------------------------------
def test_exp_matches_golden():
    """|r| <= 0.34 keeps the dyadic reduction at k = 0, so act_2d "exp"
    returns the dequantized e^r core code (test_golden_vectors.py:95)."""
    lim = int(0.34 * (1 << 14))
    codes = torch.arange(-lim, lim + 1)
    out = K.act_2d(codes.float() / (1 << 14), "exp")
    got = torch.round(out * (1 << 14)).to(torch.int32).numpy()
    np.testing.assert_array_equal(got, _golden("exp")[codes.numpy() + (1 << 15)])


def test_log_matches_golden():
    """x = m in [0.5, 1): frexp keeps p = 0, so ln x = 2 z 2^-14 and
    x 2^13 recovers the vectoring's z codes (test_golden_vectors.py:118)."""
    mq = torch.arange(1 << 13, 1 << 14)
    out = K.act_2d(mq.float() / (1 << 14), "log")
    got = torch.round(out * (1 << 13)).to(torch.int32).numpy()
    np.testing.assert_array_equal(got, _golden("log"))


def _exp_log_inputs(op, seed=8):
    """Wide normal draws plus the clamp, floor and range edges; log also
    takes x <= 0 (floored at 1e-30). Subnormals are left out: XLA:CPU
    flushes them to zero and the port does not."""
    x = _inputs(seed, scale=30.0)
    edges = np.array([80.0, -80.0, 85.0, -85.0, 88.0, -103.0, 1e-30, 1e30,
                      3e38, 0.693, -0.3466, -0.0], np.float32)
    x.reshape(-1)[-edges.size:] = edges
    if op == "log":
        x = np.where(np.random.default_rng(seed).random(x.shape) < 0.9,
                     np.abs(x), -np.abs(x)).astype(np.float32)
    if op == "gelu_erf":
        # past |x| ~ 1.8e19 erf's u^2 overflows and the reference carries
        # NaN (inf / inf) through casts whose NaN results differ between
        # XLA, torch and CUDA; hold the op below that, up to 1e18
        x = np.clip(x, -1e18, 1e18).astype(np.float32)
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("op", ["exp", "log", "softplus", "elu", "gelu_erf"])
def test_exp_log_ops_bit_exact_vs_jax(op, dtype):
    x = _exp_log_inputs(op)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    want = np.asarray(JK.act_2d(jnp.asarray(x, jdt), op, interpret=True)
                      .astype(jnp.float32))
    got = K.act_2d(torch.from_numpy(x).to(getattr(torch, dtype)), op)
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_gelu_erf_equals_the_library_fixed_path():
    """act_2d gelu_erf (the _erf_q stage over _exp_q, exact powers of two)
    against functions.gelu_erf_fixed (jnp.exp2's powers), of both packages:
    where 2^k is inexact (k < -31) the erf is already 1."""
    from repro.cordic_engine import functions as JF
    from repro_torch.cordic_engine import functions as F

    x = _exp_log_inputs("gelu_erf", seed=12)
    got = K.act_2d(torch.from_numpy(x), "gelu_erf").numpy()
    np.testing.assert_array_equal(got, F.gelu_erf_fixed(torch.from_numpy(x)).numpy())
    np.testing.assert_array_equal(got, np.asarray(jax.jit(JF.gelu_erf_fixed)(x)))


def test_exp_log_stages_match_jax():
    """_frexp_f and _hyp_vector_q on their own, against the JAX stages."""
    v = np.abs(_inputs(9).reshape(-1)) + np.float32(1e-3)
    m, p = K._frexp_f(torch.from_numpy(v))
    jm, jp = JK._frexp_f(jnp.asarray(v))
    np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(p.numpy(), np.asarray(jp))
    rng = np.random.default_rng(10)
    den = rng.integers(3 << 13, 1 << 15, 4096).astype(np.int32)
    num = rng.integers(-(1 << 13), 0, 4096).astype(np.int32)
    got = K._hyp_vector_q(torch.from_numpy(den), torch.from_numpy(num),
                          PAPER_FIXED).numpy()
    want = np.asarray(JK._hyp_vector_q(jnp.asarray(den), jnp.asarray(num),
                                       JK.PAPER_FIXED))
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# The integer path: act_q_2d / ops.sigmoid_q (Q2.14 codes in and out)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["int16", "int32"])
def test_sigmoid_q_all_codes_match_golden_and_jax(dtype):
    """All 2^16 codes, bit-exact against the golden file and JAX
    ops.sigmoid_q (the Pallas act_q_2d in interpret mode); the result keeps
    the input's dtype and shape."""
    from repro.kernels import ops as jops

    codes = np.arange(-(1 << 15), 1 << 15).astype(dtype).reshape(256, 256)
    got = ops.sigmoid_q(torch.from_numpy(codes))
    assert got.dtype == getattr(torch, dtype) and tuple(got.shape) == (256, 256)
    got = got.numpy()
    np.testing.assert_array_equal(got.reshape(-1), _golden("sigmoid"))
    np.testing.assert_array_equal(got, np.asarray(jops.sigmoid_q(jnp.asarray(codes))))


def test_act_q_2d_rejects_float_codes():
    with pytest.raises(TypeError, match="int16 or int32"):
        K.act_q_2d(torch.zeros(4))
