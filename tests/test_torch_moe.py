"""PyTorch port of the GShard MoE FFN (models/moe.py) against the JAX one.

DeepSeek-V2-Lite smoke config (E 4, top-2, d_ff_expert 32, one shared
expert) in float32, the JAX layer's weights copied in, inputs from a numpy
seed, CORDIC activations on. Both router scores ("softmax" in float32,
"sigmoid" through the CORDIC sigmoid_wide), and a router biased towards two
experts so that their queues overflow the capacity C and tokens drop.

Standard: the routing (top-k indices, queue positions, kept mask) is equal;
the outputs and the aux loss agree to float32 round-off (the two frameworks
order the matrix products' sums differently).
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import moe as JM  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import moe as M  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from test_torch_models import spec_params  # noqa: E402

ARCH = "deepseek-v2-lite-16b"
#: float32 round-off of outputs of order 1 after three matrix products
RTOL, ATOL = 1e-5, 1e-5


def _cfgs(router_score):
    out = []
    for mod in (jconfigs, configs):
        c = mod.get_smoke(ARCH, act_impl="cordic_pallas")
        out.append(dataclasses.replace(
            c, moe=dataclasses.replace(c.moe, router_score=router_score)))
    return out


@functools.lru_cache(maxsize=None)
def _ffn_params():
    """Weights of the JAX ``moe_spec`` as flat numpy arrays ("router",
    "shared/w_gate", ...), drawn with numpy at the spec's scales."""
    return T.flatten_params(spec_params(JM.moe_spec(_cfgs("softmax")[0])))


@functools.lru_cache(maxsize=None)
def _jax_fns():
    """moe_apply and the routing, jitted with the config static (one
    compile per config instead of eager dispatch of every op)."""
    return (jax.jit(JM.moe_apply, static_argnums=2),
            jax.jit(_jax_routing, static_argnums=2))


def _case(router_score, biased, seed, B=2, S=16):
    jcfg, cfg = _cfgs(router_score)
    flat = dict(_ffn_params())
    d = cfg.d_model
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, S, d)).astype(np.float32)
    if biased:
        # every token carries v, and experts 0 and 1 score v: all 2*S
        # choices of a group land on those two queues, C = 10 < S each
        v = rng.normal(size=d).astype(np.float32)
        x = x + v
        router = flat["router"].copy()
        router[:, :2] = 0.5 * v[:, None]
        flat["router"] = router
    mod = M.MoE(cfg, dtype=torch.float32, device="cpu")
    T.copy_into(dict(mod.named_parameters()),
                {k.replace("/", "."): a for k, a in flat.items()})
    jp = T._nest({k: jnp.asarray(a) for k, a in flat.items()})
    return jcfg, cfg, jp, mod, x


def _jax_routing(jp, x, jcfg):
    """The JAX moe_apply's routing, reproduced with its own jnp lines
    (moe.py:73-86): top-k indices, queue positions, kept mask."""
    m = jcfg.moe
    B, S, d = x.shape
    E, K = m.num_experts, m.top_k
    scores, _ = JM._router_scores(jp, x.reshape(B * S, d), jcfg)
    _, gate_idx = jax.lax.top_k(scores.reshape(B, S, E), K)
    onehot = jax.nn.one_hot(gate_idx, E, dtype=jnp.int32)
    flat = onehot.reshape(B, S * K, E)
    pos = (jnp.cumsum(flat, axis=1) * flat - 1).reshape(B, S, K, E)
    pos_in_e = jnp.sum(pos * onehot, axis=-1)
    C = max(int(np.ceil(S * K * m.capacity_factor / E)), 4)
    keep = (pos_in_e < C) & (pos_in_e >= 0)
    return gate_idx, pos_in_e, keep


@pytest.mark.parametrize("router_score,biased", [
    ("softmax", False), ("sigmoid", False), ("softmax", True)])
def test_moe_apply_matches_jax(router_score, biased):
    jcfg, cfg, jp, mod, x = _case(router_score, biased, seed=1)
    moe_apply, routing = _jax_fns()
    want_y, want_aux = moe_apply(jp, jnp.asarray(x), jcfg)
    with torch.no_grad():
        got_y, got_aux = M.moe_apply(mod, torch.from_numpy(x), cfg)
        xt = torch.from_numpy(x).reshape(-1, cfg.d_model)
        scores = M.router_scores(mod, xt, cfg)[0].reshape(x.shape[0], x.shape[1], -1)
        _, gate_idx, pos_in_e, keep = M.route(scores, cfg)
    j_idx, j_pos, j_keep = map(np.asarray, routing(jp, jnp.asarray(x), jcfg))
    np.testing.assert_array_equal(gate_idx.numpy(), j_idx)
    np.testing.assert_array_equal(pos_in_e.numpy(), j_pos)
    np.testing.assert_array_equal(keep.numpy(), j_keep)
    if biased:          # experts 0 and 1 take all 32 choices of a group
        assert set(gate_idx.unique().tolist()) == {0, 1}
        assert int((~keep).sum()) == 2 * 2 * (x.shape[1] - M.capacity(x.shape[1], cfg))
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(got_aux), float(want_aux), rtol=RTOL)


def test_top_k_keeps_the_lower_index_first_on_ties():
    scores = torch.tensor([[0.25, 0.5, 0.25, 0.5, 0.1]])
    vals, idx = M.top_k(scores, 3)
    want_v, want_i = jax.lax.top_k(jnp.asarray(scores.numpy()), 3)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_i))
    assert idx.tolist() == [[1, 3, 0]] and vals.tolist() == [[0.5, 0.5, 0.25]]


@pytest.mark.parametrize("S,C", [(1, 4), (16, 10)])
def test_capacity_follows_the_dispatch_width(S, C):
    """C = max(ceil(S K cap / E), 4): smoke E 4, K 2, cap 1.25. At full
    width (E 64, K 6) the bucket widths 16 and 32 give 4, 64 gives 8 and
    128 gives 15."""
    assert M.capacity(S, configs.get_smoke(ARCH)) == C
    full = configs.get_config(ARCH)
    assert [M.capacity(w, full) for w in (1, 16, 32, 64, 128)] == [4, 4, 4, 8, 15]
