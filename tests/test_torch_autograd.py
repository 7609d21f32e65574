"""Gradients of the port's CORDIC ops against the JAX ``custom_jvp`` rules.

Each ``autograd.Function`` of ``repro_torch.kernels.ops`` is held against
``jax.value_and_grad`` of the JAX op on the same inputs, within float32
round-off (the backward formulas are the JAX tangents, transposed; the
reductions of softmax and log-softmax run in another order). Under grad,
``silu_mul`` must return JAX's primal, ``u * (g * sigmoid_wide(g))``, bit
for bit and without the fused kernel.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import cordic_act as K  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

#: float32 round-off of a gradient, relative to its largest entry
RTOL = 1e-6
UNARY = ["sigmoid", "sigmoid_wide", "tanh", "exp", "log", "softplus", "elu", "gelu_erf",
         "silu"]


def _x(op, seed=0):
    x = (np.random.default_rng(seed).normal(size=(6, 40)) * 3).astype(np.float32)
    if op == "log":
        x[0, :5] = [-1.0, 0.0, 1e-31, 2.0, 1e-3]    # the flat floor and above
        x[1:] = np.abs(x[1:]) + np.float32(0.1)
    return x


def _torch_value_and_grad(op, x, w, **kw):
    xt = torch.from_numpy(x.copy()).requires_grad_(True)
    tv = (getattr(ops, op)(xt, **kw) * torch.from_numpy(w)).sum()
    tv.backward()
    return float(tv.detach()), xt.grad.numpy()


#: (op, kwargs) cases: every op along the last axis, softmax along axis 1
CASES = {op: (op, {}) for op in UNARY + ["softmax", "log_softmax"]}
CASES["softmax_axis1"] = ("softmax", {"axis": 1})


def _case_inputs(name):
    op, _ = CASES[name]
    x = _x(op)
    if name == "softmax_axis1":
        x = x.reshape(6, 4, 10)
    w = np.random.default_rng(1).normal(size=x.shape).astype(np.float32)
    return x, w


@pytest.fixture(scope="module")
def jax_grads():
    """Every case's value and grad from one jitted jax.value_and_grad."""
    xs = {n: jnp.asarray(_case_inputs(n)[0]) for n in CASES}
    ws = {n: _case_inputs(n)[1] for n in CASES}

    def total(xs):
        vals = {n: jnp.sum(getattr(jops, CASES[n][0])(x, **CASES[n][1]) * ws[n])
                for n, x in xs.items()}
        return sum(vals.values()), vals

    (_, vals), grads = jax.jit(jax.value_and_grad(total, has_aux=True))(xs)
    return {n: (float(vals[n]), np.asarray(grads[n])) for n in CASES}


@pytest.mark.parametrize("name", sorted(CASES))
def test_grad_matches_jax(name, jax_grads):
    op, kw = CASES[name]
    x, w = _case_inputs(name)
    jv, jg = jax_grads[name]
    tv, tg = _torch_value_and_grad(op, x, w, **kw)
    assert tv == pytest.approx(jv, rel=1e-5)
    assert np.abs(tg - jg).max() <= RTOL * np.abs(jg).max()


def test_log_grad_is_zero_on_the_floor():
    xt = torch.tensor([-1.0, 0.0, 1e-31, 2.0], requires_grad=True)
    ops.log(xt).sum().backward()
    assert xt.grad.tolist()[:3] == [0.0, 0.0, 0.0] and xt.grad[3] == 0.5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_silu_mul_primal_and_grads_under_grad_match_jax(dtype):
    rng = np.random.default_rng(3)
    g = (rng.normal(size=(64, 96)) * 4).astype(np.float32)
    u = rng.normal(size=g.shape).astype(np.float32)
    w = rng.normal(size=g.shape).astype(np.float32)
    jdt = getattr(jnp, dtype)
    gj, uj = jnp.asarray(g, jdt), jnp.asarray(u, jdt)
    # the primal JAX computes under differentiation: its jvp rule's
    primal, _ = jax.jvp(jops.silu_mul, (gj, uj),
                        (jnp.ones_like(gj), jnp.zeros_like(uj)))
    _, (dg, du) = jax.value_and_grad(
        lambda a, b: jnp.sum(jops.silu_mul(a, b).astype(jnp.float32) * w),
        argnums=(0, 1))(gj, uj)
    tdt = getattr(torch, dtype)
    gt = torch.from_numpy(g).to(tdt).requires_grad_(True)
    ut = torch.from_numpy(u).to(tdt).requires_grad_(True)
    y = ops.silu_mul(gt, ut)
    (y.float() * torch.from_numpy(w)).sum().backward()

    def f32(a):
        return np.asarray(a.astype(jnp.float32))

    np.testing.assert_array_equal(y.detach().float().numpy(), f32(primal))
    np.testing.assert_array_equal(gt.grad.float().numpy(), f32(dg))
    np.testing.assert_array_equal(ut.grad.float().numpy(), f32(du))
    # and it is not the fused kernel's (u * g) * s on many lanes
    fused = K.silu_mul_2d(gt.detach().reshape(-1), ut.detach().reshape(-1))
    assert (fused.view(y.shape) != y.detach()).any()


def test_silu_mul_launches_under_grad_and_without(monkeypatch):
    """Under grad: one act_2d (sigmoid_wide) and no silu_mul_2d, as the JAX
    rule; without grad: the fused kernel alone."""
    calls = []
    act, fused = K.act_2d, K.silu_mul_2d
    monkeypatch.setattr(K, "act_2d",
                        lambda x, op, **kw: calls.append(op) or act(x, op, **kw))
    monkeypatch.setattr(K, "silu_mul_2d",
                        lambda g, u, **kw: calls.append("silu_mul_2d") or fused(g, u, **kw))
    g = torch.randn(4, 8, requires_grad=True)
    u = torch.randn(4, 8)
    ops.silu_mul(g, u)
    assert calls == ["sigmoid_wide"]
    calls.clear()
    with torch.no_grad():
        ops.silu_mul(g, u)
    ops.silu_mul(g.detach(), u)
    assert calls == ["silu_mul_2d", "silu_mul_2d"]


# ---------------------------------------------------------------------------
# Second order (tests/test_gradients.py:75 and :184): torch.autograd.grad
# twice, with create_graph, against jax.grad(jax.grad(...)) on seeded 4x64
# inputs. silu and silu_mul differentiate through s = sigmoid_wide(x), and
# token_nll through its impl's log-softmax, as the JAX rules do.
# ---------------------------------------------------------------------------
from repro.train import losses as jlosses  # noqa: E402
from repro_torch.train import losses  # noqa: E402

#: second-order tolerance, relative to the largest entry: float32 round-off
#: of the composed rules (the RTOL class of the first-order tests above)
RTOL2 = 1e-6
SECOND = ["silu", "silu_mul/gate", "silu_mul/up", "token_nll/exact",
          "token_nll/cordic", "token_nll/cordic_pallas"]


def _second_inputs():
    rng = np.random.default_rng(21)
    x = (rng.normal(size=(4, 64)) * 2).astype(np.float32)
    u = rng.normal(size=(4, 64)).astype(np.float32)
    w = rng.normal(size=(4, 64)).astype(np.float32)
    v = rng.normal(size=(4, 64)).astype(np.float32)
    labels = rng.integers(0, 64, size=(4,)).astype(np.int32)
    return x, u, w, v, labels


def _jax_second(name, x, u, w, v, labels):
    """(first-order grads, second-order grads) of one case in JAX."""
    if name == "silu":
        def f(a):
            return jnp.sum(jops.silu(a) * w)

        g1 = jax.grad(f)
        return (g1(x),), (jax.grad(lambda a: jnp.sum(g1(a) * v))(x),)
    if name.startswith("silu_mul"):
        def f(a, b):
            return jnp.sum(jops.silu_mul(a, b) * w)

        g1 = jax.grad(f, argnums=(0, 1))
        k = 0 if name.endswith("gate") else 1
        h = jax.grad(lambda a, b: jnp.sum(g1(a, b)[k] * v), argnums=(0, 1))(x, u)
        return g1(x, u), h
    impl = name.split("/")[1]

    def loss(l):
        return jnp.mean(jlosses.token_nll(l, labels, impl))

    return ((jax.grad(loss)(x),),
            (jax.grad(lambda l: jnp.sum(jax.grad(loss)(l) ** 2))(x),))


def _torch_second(name, x, u, w, v, labels, create_graph=True):
    """(first-order grads, second-order grads or None) of one case in the
    port; the second order only under ``create_graph``."""
    xt = torch.from_numpy(x.copy()).requires_grad_(True)
    ins = [xt]
    if name == "silu":
        out = (ops.silu(xt) * torch.from_numpy(w)).sum()
    elif name.startswith("silu_mul"):
        ut = torch.from_numpy(u.copy()).requires_grad_(True)
        ins.append(ut)
        out = (ops.silu_mul(xt, ut) * torch.from_numpy(w)).sum()
    else:
        out = losses.token_nll(xt, torch.from_numpy(labels),
                               name.split("/")[1]).mean()
    g1 = torch.autograd.grad(out, ins, create_graph=create_graph)
    if not create_graph:
        return g1, None
    if name == "silu" or name.startswith("silu_mul"):
        k = 1 if name.endswith("up") else 0
        inner = (g1[k] * torch.from_numpy(v)).sum()
    else:
        inner = (g1[0] ** 2).sum()
    h = torch.autograd.grad(inner, ins, allow_unused=True)
    h = tuple(torch.zeros_like(t) if g is None else g for g, t in zip(h, ins))
    return g1, h


@pytest.fixture(scope="module")
def jax_second():
    x, u, w, v, labels = _second_inputs()
    args = (jnp.asarray(x), jnp.asarray(u), w, v, jnp.asarray(labels))
    out = jax.jit(lambda *a: {n: _jax_second(n, *a) for n in SECOND})(*args)
    return {n: ([np.asarray(t) for t in g1], [np.asarray(t) for t in h])
            for n, (g1, h) in out.items()}


@pytest.mark.parametrize("name", SECOND)
def test_second_order_matches_jax(name, jax_second):
    ins = _second_inputs()
    _, h = _torch_second(name, *ins)
    jg1, jh = jax_second[name]
    assert len(h) == len(jh)
    for got, want in zip(h, jh):
        got = got.detach().numpy()
        assert np.isfinite(got).all()
        assert np.abs(got - want).max() <= RTOL2 * max(np.abs(want).max(), 1e-30), name


@pytest.mark.parametrize("name", SECOND)
def test_first_order_unchanged_by_create_graph(name, jax_second):
    """The recomputation under grad mode returns the saved values: first
    derivatives are bit-equal with and without create_graph, and agree
    with JAX's."""
    ins = _second_inputs()
    with_graph, _ = _torch_second(name, *ins)
    plain, _ = _torch_second(name, *ins, create_graph=False)
    jg1, _ = jax_second[name]
    for a, b, want in zip(with_graph, plain, jg1):
        assert torch.equal(a.detach(), b)
        assert np.abs(b.numpy() - want).max() <= RTOL * np.abs(want).max()
