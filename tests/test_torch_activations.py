"""The port's activation registry (``core/activations.py``) against the
JAX package's: every kind, impl and range mode, in float32 and bfloat16.

The CORDIC impls are bit-exact in both dtypes: bfloat16 ops round after
every op and meet Python constants as bfloat16 values, as jitted XLA does
(``repro_torch.core.numerics``); ``cordic_pallas`` goes through the kernel
wrappers (their plain versions on the CPU) against the Pallas kernels in
interpret mode. Held to float round-off instead: the "exact" impl and the
"gelu" kind (torch's libm against XLA's), and ``gelu_tanh`` under range
"reduce" in float32 for the plain impls, where jitted XLA folds ``1 + (2 s
- 1)`` (the tanh from the sigmoid) into ``2 s`` and the port rounds the two
ops: one ulp on some lanes. First-order gradients (the custom_jvp rules as
autograd Functions) match ``jax.grad`` to float32 round-off.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import activations as JA  # noqa: E402
from repro_torch.core import activations as A  # noqa: E402
from test_torch_functions import _both  # noqa: E402


# ---------------------------------------------------------------------------
# the activation registry
# ---------------------------------------------------------------------------
KINDS = ("sigmoid", "tanh", "silu", "gelu_tanh", "relu", "gelu", "exp",
         "softplus", "elu", "gelu_erf")
_ACT_X = (np.random.default_rng(11).normal(size=4096) * 3).astype(np.float32)
_ACT_X[:8] = [0.0, 1.0, -1.0, 2.0, -2.0, 4.03125, 8.0, -8.5]


def _round_off_only(kind, impl, range_mode, dtype):
    """Cases held to float round-off, not bit for bit (module docstring)."""
    if impl == "exact" or kind == "gelu":
        return (2e-6, 1e-6) if dtype == "float32" else (2 ** -7, 2 ** -7)
    if kind == "gelu_tanh" and range_mode == "reduce" and dtype == "float32":
        return (2.5e-7, 1e-7)
    return None


#: (impl, range_mode): the exact impl ignores the range mode
CASES = [("exact", "reduce")] + [(i, r) for i in ("cordic_float", "cordic_fixed",
                                                  "cordic_pallas")
                                 for r in ("clamp", "reduce")]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl,range_mode", CASES)
def test_registry_matches_jax(impl, range_mode, dtype):
    x = _ACT_X[:1024] if impl != "cordic_pallas" else _ACT_X[:256]
    for kind in KINDS:
        (want,), (got,) = _both(JA.get_activation(kind, impl, range_mode),
                                A.get_activation(kind, impl, range_mode), x,
                                dtype=dtype)
        tol = _round_off_only(kind, impl, range_mode, dtype)
        if tol is None:
            np.testing.assert_array_equal(got, want, err_msg=kind)
        else:
            np.testing.assert_allclose(got, want, rtol=tol[0], atol=tol[1],
                                       err_msg=kind)


@pytest.mark.parametrize("impl", ["exact", "cordic_float", "cordic_fixed",
                                  "cordic_pallas"])
def test_registry_gradients_match_jax(impl):
    x = _ACT_X[:256]
    for kind in KINDS:
        jf = JA.get_activation(kind, impl, "reduce")
        want = np.asarray(jax.grad(lambda v: jnp.sum(jf(v)))(jnp.asarray(x)))
        xt = torch.from_numpy(x).requires_grad_(True)
        A.get_activation(kind, impl, "reduce")(xt).sum().backward()
        # torch's own tanh-GELU backward against JAX's autodiff of the
        # formula: different roundings near its zero crossing
        native = kind == "gelu" or (impl == "exact" and kind == "gelu_tanh")
        atol = 1e-5 if native else 2e-6
        np.testing.assert_allclose(xt.grad.numpy(), want, rtol=2e-5, atol=atol,
                                   err_msg=kind)


def test_registry_rejects_unknown_names():
    with pytest.raises(ValueError, match="not in"):
        A.get_activation("silu", "cordic_bogus")
    with pytest.raises(ValueError, match="range_mode"):
        A.get_activation("silu", "cordic_fixed", range_mode="wrap")
    with pytest.raises(ValueError, match="unknown activation kind"):
        A.get_activation("swish", "cordic_fixed")
    assert A.ACT_IMPLS == JA.ACT_IMPLS and A.RANGE_MODES == JA.RANGE_MODES


def test_wide_sigmoid_bf16_rounds_every_op():
    """bfloat16 silu through sigmoid_cordic_wide rounds after every op (and
    takes k from a bfloat16 log2): float32-then-round differs on many
    lanes, the port does not."""
    xb = torch.from_numpy(_ACT_X).bfloat16()
    silu = A.get_activation("silu", "cordic_fixed")
    once = silu(xb.float()).bfloat16()
    want = np.asarray(jax.jit(JA.get_activation("silu", "cordic_fixed"))(
        jnp.asarray(_ACT_X, jnp.bfloat16)).astype(jnp.float32))
    np.testing.assert_array_equal(silu(xb).float().numpy(), want)
    assert int((once.float().numpy() != want).sum()) > 100
