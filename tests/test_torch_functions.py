"""The port's CORDIC numerics against the JAX package: fixed-point helpers,
the engine sweeps (golden vectors of every format profile), the paper's
sigmoid pipeline and its MAE, and the function library.

Integer paths must be bit-exact; float boundary ops must round as jitted
XLA rounds them (``repro_torch.core.numerics``), so the library's
``*_fixed``/``*_float`` functions are held bit for bit in float32. The
softmax and log-softmax gradients (the custom_jvp rules as autograd
Functions) match ``jax.grad`` to float32 round-off. The activation
registry is held in tests/test_torch_activations.py.
"""
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import paper_sigmoid  # noqa: E402
from repro.core import errors as JE  # noqa: E402
from repro.core import fixed_point as jfp  # noqa: E402
from repro.core import sigmoid as JS  # noqa: E402
from repro.cordic_engine import functions as JF  # noqa: E402
from repro_torch.core import cordic as C  # noqa: E402
from repro_torch.core import errors as TE  # noqa: E402
from repro_torch.core import fixed_point as fp  # noqa: E402
from repro_torch.core import numerics as nx  # noqa: E402
from repro_torch.core import sigmoid as S  # noqa: E402
from repro_torch.cordic_engine import core as eng  # noqa: E402
from repro_torch.cordic_engine import functions as F  # noqa: E402

GOLDEN = pathlib.Path(__file__).parent / "golden"
_DT = {"float32": (jnp.float32, torch.float32),
       "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _np(t):
    return t.detach().float().numpy() if torch.is_tensor(t) else np.asarray(
        jnp.asarray(t).astype(jnp.float32))


def _both(fn_j, fn_t, *arrays, dtype="float32"):
    jdt, tdt = _DT[dtype]
    want = jax.jit(fn_j)(*(jnp.asarray(a, jdt) for a in arrays))
    got = fn_t(*(torch.from_numpy(a).to(tdt) for a in arrays))
    if not isinstance(want, tuple):
        want, got = (want,), (got,)
    return [_np(w) for w in want], [_np(g) for g in got]


# ---------------------------------------------------------------------------
# fixed point and the rounding helpers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("fmt", ["Q2_14", "Q2_20", "Q2_29"])
@pytest.mark.parametrize("rounding", ["nearest", "floor"])
def test_quantize_matches_jax(fmt, rounding):
    x = np.random.default_rng(0).normal(size=4096).astype(np.float32)
    x[:6] = [1.9999999, -2.0, 2.0, 3.0, -7.0, 0.5 + 2.0 ** -15]
    f, jf = getattr(fp, fmt), getattr(jfp, fmt)
    got = fp.quantize(torch.from_numpy(x), f, rounding).numpy()
    want = np.asarray(jfp.quantize(jnp.asarray(x), jf, rounding))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(fp.dequantize(torch.from_numpy(got), f).numpy(),
                                  np.asarray(jfp.dequantize(jnp.asarray(want), jf)))


def test_integer_ops_match_jax():
    rng = np.random.default_rng(1)
    v = rng.integers(-(1 << 17), 1 << 17, 4096).astype(np.int32)
    t, j = torch.from_numpy(v), jnp.asarray(v)
    for s in (0, 1, 3, 9):
        for rnd in ("trunc", "nearest"):
            np.testing.assert_array_equal(fp.shr(t, s, fp.Q2_14, rnd).numpy(),
                                          np.asarray(jfp.shr(j, s, jfp.Q2_14, rnd)))
        np.testing.assert_array_equal(fp.shl(t, s).numpy(), np.asarray(jfp.shl(j, s)))
    np.testing.assert_array_equal(fp.add(t, t).numpy(), np.asarray(jfp.add(j, j)))
    np.testing.assert_array_equal(fp.sub(t, 7).numpy(), np.asarray(jfp.sub(j, 7)))
    np.testing.assert_array_equal(fp.sat(t, fp.Q2_14).numpy(),
                                  np.asarray(jfp.sat(j, jfp.Q2_14)))
    for src, dst in ((fp.Q2_20, fp.Q2_14), (fp.Q2_14, fp.Q2_20), (fp.Q2_29, fp.Q2_14)):
        jsrc, jdst = (getattr(jfp, f"Q2_{q.frac_bits}") for q in (src, dst))
        np.testing.assert_array_equal(
            fp.requantize(t, src, dst, "nearest").numpy(),
            np.asarray(jfp.requantize(j, jsrc, jdst, "nearest")))
    assert fp.const(0.3) == int(jfp.const(0.3))
    assert str(fp.Q2_29) == str(jfp.Q2_29) == "Q2.29"


def test_saturation_observer_counts_clips():
    seen = []
    prev = fp.set_saturation_observer(lambda f, c, n: seen.append((f, c, n)))
    try:
        fp.quantize(torch.tensor([0.5, 2.5, -3.0, 1.0]))
    finally:
        assert fp.set_saturation_observer(prev) is not None
    assert seen == [("Q2.14", 2, 4)]
    fp.quantize(torch.tensor([9.0]))          # no observer: no call
    assert len(seen) == 1


def test_exp2_sqrt_and_sum_order_match_xla():
    k = np.arange(-150, 129).astype(np.float32)
    np.testing.assert_array_equal(nx.exp2(torch.from_numpy(k)).numpy(),
                                  np.asarray(jax.jit(jnp.exp2)(k)))
    a = np.random.default_rng(2).uniform(0, 2, 1 << 15).astype(np.float32)
    np.testing.assert_array_equal(nx.sqrt(torch.from_numpy(a)).numpy(),
                                  np.asarray(jax.jit(jnp.sqrt)(a)))
    rng = np.random.default_rng(3)
    for n in (7, 32, 33, 100, 128):
        x = (rng.standard_normal((64, n))
             * 1e3 ** rng.standard_normal((64, n))).astype(np.float32)
        np.testing.assert_array_equal(
            nx.xla_sum(torch.from_numpy(x), -1).numpy(),
            np.asarray(jax.jit(lambda v: jnp.sum(v, -1))(x)), err_msg=str(n))


# ---------------------------------------------------------------------------
# golden vectors through the engine sweeps, every format profile
# ---------------------------------------------------------------------------
def _golden(fn, prof):
    with np.load(GOLDEN / f"{fn}_{prof}.npz") as z:
        y = z["y"].astype(np.int64)
        x = z["x"].astype(np.int64) if "x" in z.files else None
    if x is None:
        x = (np.arange(1 << 13, 1 << 14) if fn == "log"
             else np.arange(-(1 << 15), 1 << 15))
    return torch.from_numpy(x.astype(np.int32)), y


@pytest.mark.parametrize("prof", ["q2_14", "q2_20", "q2_29"])
@pytest.mark.parametrize("fn", ["sigmoid", "tanh", "exp", "log"])
def test_golden_vectors_through_engine_sweeps(fn, prof):
    p = F.FORMAT_PROFILES[prof]
    x, want = _golden(fn, prof)
    if fn == "sigmoid":
        got = C.sigmoid_mr_q(x, p.pipeline, p.cfg)
    elif fn == "tanh":
        got = C.tanh_mr_q(x, p.pipeline, p.cfg)
    elif fn == "exp":
        c, s, _ = eng.rotate_q(x, p.rotation, p.cfg)
        got = fp.add(c, s, p.cfg.fmt)
    else:
        one = 1 << p.cfg.fmt.frac_bits
        got = eng.vector_q(x + one, x - one, p.vectoring, p.cfg)
    np.testing.assert_array_equal(got.numpy(), want)


def test_sweeps_agree_with_kernel_stages():
    """The engine sweeps and the kernel stages are two transcriptions of one
    datapath: on all 2^16 angle codes they agree."""
    from repro_torch.kernels import cordic_act as K

    z = torch.arange(-(1 << 15), 1 << 15, dtype=torch.int32)
    c, s, _ = C.mr_hrc_q(z)
    kc, ks = K._coshsinh_q(z, C.PAPER_SCHEDULE, C.PAPER_FIXED)
    assert torch.equal(c, kc) and torch.equal(s, ks)
    assert torch.equal(C.sigmoid_mr_q(z), K._cordic_sigmoid_q(z, C.PAPER_SCHEDULE,
                                                               C.PAPER_FIXED))


# ---------------------------------------------------------------------------
# the paper's sigmoid: MAE (paper Table 2) and the Table-2 families
# ---------------------------------------------------------------------------
def test_paper_mae_reproduced():
    st = TE.error_stats(lambda x: S.sigmoid_cordic_fixed(x), S.sigmoid_exact, -1, 1)
    ref = JE.error_stats(lambda x: JS.sigmoid_cordic_fixed(x), JS.sigmoid_exact, -1, 1)
    assert st["mae"] <= paper_sigmoid.PAPER_MAE and st["max"] <= 1e-3
    # the exact sigmoids (torch's and XLA's libm) differ by an ulp here and
    # there: the two MAEs agree to 1e-4 of themselves (5e-5 seen)
    assert st["mae"] == pytest.approx(ref["mae"], rel=1e-4)
    assert st["max"] == pytest.approx(ref["max"], rel=1e-4)
    # with LVC cut at j = 9 the MAE lands by the published figure
    sched = C.MRSchedule(lvc_js=tuple(range(1, 10)))
    st9 = TE.error_stats(lambda x: S.sigmoid_cordic_fixed(x, sched), S.sigmoid_exact, -1, 1)
    assert 2e-4 <= st9["mae"] <= 8e-4
    assert TE.ulp(st["max"]) == pytest.approx(JE.ulp(st["max"]))


@pytest.mark.parametrize("name", sorted(S.TABLE2_METHODS))
def test_table2_methods_match_jax(name):
    x = np.linspace(-1.2, 1.2, 4001, dtype=np.float32)
    (want,), (got,) = _both(JS.TABLE2_METHODS[name], S.TABLE2_METHODS[name], x)
    np.testing.assert_array_equal(got, want)


def test_op_count_and_float_helpers():
    assert C.shift_add_op_count() == __import__(
        "repro.core.cordic", fromlist=["x"]).shift_add_op_count()
    z = np.linspace(-0.5, 0.5, 513, dtype=np.float32)
    from repro.core import cordic as JC

    (want,), (got,) = _both(JC.r2_residual_f, C.r2_residual_f, z)
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# the function library, float32, bit for bit
# ---------------------------------------------------------------------------
_R = np.random.default_rng(7)
_X = {
    "wide": (_R.normal(size=4096) * 30).astype(np.float32),
    "unit": _R.uniform(-0.9, 0.9, 4096).astype(np.float32),
    "pos": (np.abs(_R.normal(size=4096)) * 10 + 1e-3).astype(np.float32),
    "norm": (_R.normal(size=4096) * 4).astype(np.float32),
}
_X["norm"][:8] = [0.0, 1.0, -1.0, 0.5, 2.0, -2.0, 4.0, 0.25]
_X["pos"][:4] = [1.0, 0.5, 2.0, 1e-20]

FUNCTIONS = {  # name -> input arrays
    "exp_fixed": ("wide",), "exp_float": ("wide",),
    "coshsinh_fixed": ("unit",), "coshsinh_float": ("unit",),
    "atanh_fixed": ("unit",), "atanh_float": ("unit",),
    "log_fixed": ("pos",), "log_float": ("pos",),
    "divide_fixed": ("norm", "wide"), "divide_float": ("norm", "wide"),
    "reciprocal_fixed": ("norm",), "reciprocal_float": ("norm",),
    "multiply_fixed": ("norm", "wide"), "multiply_float": ("norm", "wide"),
    "sincos_fixed": ("wide",), "sincos_float": ("wide",),
    "sin_fixed": ("norm",), "cos_float": ("norm",),
    "softplus_fixed": ("wide",), "softplus_float": ("wide",),
    "elu_fixed": ("norm",), "elu_float": ("norm",),
    "erf_fixed": ("norm",), "erf_float": ("norm",),
    "gelu_erf_fixed": ("norm",), "gelu_erf_float": ("norm",),
}


@pytest.mark.parametrize("name", sorted(FUNCTIONS))
def test_function_library_bit_exact(name):
    arrays = [_X[k] for k in FUNCTIONS[name]]
    want, got = _both(getattr(JF, name), getattr(F, name), *arrays)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)


def test_divide_edges_match_jax():
    """sign(0) = 0, frexp(0) = (0, 0) floored to 0.5, the halving at m_y >=
    m_x and exact powers of two."""
    y = np.array([0.0, 1.0, 2.0, 0.75, -3.0, 1.0, 0.0, 5e-30, 1e30], np.float32)
    x = np.array([2.0, 0.0, 2.0, 0.75, 0.5, 1.0, 0.0, 3.0, 7e-3], np.float32)
    for name in ("divide_fixed", "divide_float", "multiply_fixed", "multiply_float"):
        (want,), (got,) = _both(getattr(JF, name), getattr(F, name), y, x)
        np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("width", [7, 33, 100])
@pytest.mark.parametrize("name", ["softmax_fixed", "log_softmax_fixed",
                                  "log_softmax_float"])
def test_row_functions_bit_exact(name, width):
    """Rows of 7 (one window), 33 and 100 (XLA's split windows). Jitted
    alone, XLA fuses a 16-wide row's exp and sum differently from one seed
    to the next (another summation order, and the dyadic reduction fused
    or not), so that width is held by the model and engine tests instead."""
    x = (np.random.default_rng(width).normal(size=(48, width)) * 4).astype(np.float32)
    x[3, : width // 2] = -1e30                   # masked lanes
    (want,), (got,) = _both(getattr(JF, name), getattr(F, name), x)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["softmax", "log_softmax"])
def test_row_function_gradients_match_jax(name):
    rng = np.random.default_rng(9)
    x = (rng.normal(size=(6, 20)) * 3).astype(np.float32)
    w = rng.normal(size=(6, 20)).astype(np.float32)
    want = jax.grad(lambda v: jnp.sum(getattr(JF, name)(v) * w))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    (getattr(F, name)(xt) * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
