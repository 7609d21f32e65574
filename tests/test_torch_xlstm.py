"""The port's xLSTM blocks (``repro_torch/models/xlstm.py``) and the xLSTM
smoke model against the JAX ones, with the JAX parameters.

mLSTM and sLSTM blocks alone (float32 smoke width: d_model 64, 2 heads,
chunk 16) and the whole smoke model (three mLSTM blocks, then one sLSTM),
forward and decode, for each of the activation datapaths ``exact``,
``cordic_fixed`` and ``cordic_pallas`` (the kernels' plain versions on the
CPU, the JAX Pallas kernels in interpret mode). Tolerance: the float
scans (einsums, cumsums, exp) round differently in the two frameworks,
within f32 round-off; where that crosses a rounding edge of a Q2.14 code a
CORDIC activation moves by one code step (6.1e-5), so block outputs and
logits are held within the 1e-3 of tests/test_torch_models.py and every
argmax holds. The port against itself: chunk invariance and decode after
prefill within the reference's own bounds (tests/test_models.py).
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import common as jcm  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models import xlstm as JX  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models import xlstm as X  # noqa: E402
from test_torch_models import ATOL, spec_params  # noqa: E402

ARCH = "xlstm-1.3b"
IMPLS = ("exact", "cordic_fixed", "cordic_pallas")


def _cfgs(impl, **xl):
    jcfg = jconfigs.get_smoke(ARCH, act_impl=impl)
    cfg = configs.get_smoke(ARCH, act_impl=impl)
    if xl:
        jcfg = dataclasses.replace(jcfg, xlstm=dataclasses.replace(jcfg.xlstm, **xl))
        cfg = dataclasses.replace(cfg, xlstm=dataclasses.replace(cfg.xlstm, **xl))
    return jcfg, cfg


def load_module(module, jparams):
    """Copy a JAX block's param tree into the port's module of that block
    (norms are {"scale": ...} in JAX)."""
    flat = T.flatten_params(jparams)
    T.copy_into(dict(module.named_parameters()),
                {n: flat[T._jax_leaf_path(n)] for n, _ in module.named_parameters()})
    return module


@functools.lru_cache(maxsize=None)
def _block(kind, seed):
    """(JAX params, port module) of one mLSTM or sLSTM block, float32."""
    _, cfg = _cfgs("exact")
    spec = (JX.mlstm_spec if kind == "mlstm" else JX.slstm_spec)(cfg)
    jp = jcm.init_params(spec, jax.random.PRNGKey(seed))
    module = (X.MLSTM if kind == "mlstm" else X.SLSTM)(cfg, dtype=torch.float32,
                                                       device="cpu")
    return jp, load_module(module, jp)


def _x(seed, shape):
    return np.random.default_rng(seed).normal(0, 0.5, shape).astype(np.float32)


def _jcache(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


BLOCKS = {"mlstm": (JX.mlstm_apply, JX.mlstm_init_cache, X.mlstm_apply,
                    X.mlstm_init_cache),
          "slstm": (JX.slstm_apply, JX.slstm_init_cache, X.slstm_apply,
                    X.slstm_init_cache)}


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_block_forward_and_decode_match_jax(kind, impl):
    """A 21-position prefill into a cache (not a chunk multiple: the inert
    pad, two chunks) and one decode step, against JAX's: the outputs, the
    final state, and the port's no-cache forward (the same arithmetic from
    a fresh state) within ATOL."""
    japply, jinit, apply, init = BLOCKS[kind]
    jcfg, cfg = _cfgs(impl)
    jp, module = _block(kind, 4)
    x = _x(4, (2, 22, cfg.d_model))
    jc = jinit(jcfg, 2)
    cache = init(cfg, 2, device="cpu")
    for sl in (slice(0, 21), slice(21, 22)):
        want, jc = japply(jp, jnp.asarray(x[:, sl]), jcfg, cache=jc)
        got = apply(module, torch.from_numpy(x[:, sl]), cfg, cache)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)
        if sl.start == 0:
            fwd = apply(module, torch.from_numpy(x[:, sl]), cfg).numpy()
            np.testing.assert_allclose(fwd, np.asarray(want), rtol=0, atol=ATOL)
    for k, v in _jcache(jc).items():
        np.testing.assert_allclose(cache[k].numpy(), v, rtol=1e-4, atol=ATOL,
                                   err_msg=k)


def test_mlstm_chunk_invariance_and_decode():
    """tests/test_models.py for the port: chunk 8 against 32 (2e-4), and a
    decode after a 31-position prefill against the 32nd position (2e-3)."""
    _, module = _block("mlstm", 4)
    x = torch.from_numpy(_x(4, (2, 32, 64)))
    y8 = X.mlstm_apply(module, x, _cfgs("exact", chunk=8)[1])
    y32 = X.mlstm_apply(module, x, _cfgs("exact", chunk=32)[1])
    torch.testing.assert_close(y8, y32, rtol=0, atol=2e-4)
    _, cfg = _cfgs("exact")
    cache = X.mlstm_init_cache(cfg, 2, device="cpu")
    X.mlstm_apply(module, x[:, :31], cfg, cache)
    y_dec = X.mlstm_apply(module, x[:, 31:32], cfg, cache)
    torch.testing.assert_close(y_dec[:, 0], X.mlstm_apply(module, x, cfg)[:, 31],
                               rtol=0, atol=2e-3)


def test_slstm_cache_continuation():
    """An 11-position prefill into a cache, then position 12 alone, equals
    the 12-position forward's last position (2e-4, tests/test_models.py)."""
    _, cfg = _cfgs("exact")
    _, module = _block("slstm", 5)
    x = torch.from_numpy(_x(5, (1, 12, cfg.d_model)))
    cache = X.slstm_init_cache(cfg, 1, device="cpu")
    X.slstm_apply(module, x[:, :11], cfg, cache)
    y_dec = X.slstm_apply(module, x[:, 11:12], cfg, cache)
    torch.testing.assert_close(y_dec[:, 0], X.slstm_apply(module, x, cfg)[:, 11],
                               rtol=0, atol=2e-4)


@functools.lru_cache(maxsize=None)
def _model():
    jcfg, cfg = _cfgs("exact")
    jp = spec_params(JT.model_spec(jcfg), seed=1)
    return jp, T.load_jax_params(cfg, T.flatten_params(jp), device="cpu")


def test_bridge_segments_and_round_trip():
    """The smoke model's segments (three mLSTM stacked, one sLSTM) and the
    full config's 12 (seven mLSTM, then one sLSTM, six times), as the JAX
    execution plan; every leaf lands and jax_tree gives the tree back."""
    jp, model = _model()
    _, cfg = _cfgs("exact")
    assert [s[1:] for s in T.segments(cfg)] == [("mlstm", 0, 3), ("slstm", 3, 1)]
    full = configs.get_config(ARCH)
    assert T.execution_plan(full) == JT.execution_plan(jconfigs.get_config(ARCH))
    assert len(T.segments(full)) == 12
    assert T.segments(full)[1][1:] == ("slstm", 7, 1)
    flat = T.flatten_params(jp)
    np.testing.assert_array_equal(model.blocks[2].mixer.w_if.numpy(),
                                  flat["seg0/mixer/w_if"][2])
    np.testing.assert_array_equal(model.blocks[3].mixer.ffn.w_up.numpy(),
                                  flat["seg1/mixer/ffn/w_up"])
    np.testing.assert_array_equal(model.blocks[1].mixer.norm.numpy(),
                                  flat["seg0/mixer/norm/scale"][1])
    back = T.flatten_params(T.jax_tree(cfg, dict(model.named_parameters())))
    assert sorted(back) == sorted(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], np.asarray(flat[k]))


def _logits_close(got, want):
    diff = np.abs(got - want)
    assert np.median(diff) < 1e-5 and diff.max() < ATOL, diff.max()
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("impl", IMPLS)
def test_model_forward_and_decode_match_jax(impl):
    """The whole smoke model with the JAX weights: a 21-token prefill of two
    rows into a dense cache and one decode step against JAX's, logits
    within ATOL; the port's no-cache forward over the same tokens too."""
    jcfg, cfg = _cfgs(impl)
    jp, model = _model()
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 22)).astype(np.int32)
    jc = JT.init_cache(jcfg, 2, 32, jnp.float32)
    cache = T.init_cache(cfg, 2, 32, device="cpu")
    for sl in (slice(0, 21), slice(21, 22)):
        want, _, jc = JT.apply(jp, {"tokens": jnp.asarray(toks[:, sl])}, jcfg, jc)
        t = torch.from_numpy(toks[:, sl]).long()
        _logits_close(T.apply(model, {"tokens": t}, cfg, cache)[0].numpy(),
                      np.asarray(want))
        if sl.start == 0:
            _logits_close(T.apply(model, {"tokens": t}, cfg)[0].numpy(),
                          np.asarray(want))
    assert cache.idx.tolist() == [22, 22]


def test_dense_cache_resets_recurrent_state():
    """reset_state puts every recurrent leaf back to its initial value in
    the rows of a view only (m at -1e30, the rest 0); attention-free, the
    cache's bytes are its float32 state."""
    _, cfg = _cfgs("exact")
    cache = T.init_cache(cfg, 2, 32, device="cpu")
    for c in cache.layers:
        for k, v in c.items():
            if k != "idx":
                v.fill_(3.0)
    T.take_slot(cache, 1).reset_state()
    mlstm = cache.layers[0]
    assert mlstm["m"][1].eq(X.NEG).all() and mlstm["C"][1].eq(0).all()
    assert mlstm["C"][0].eq(3.0).all()
    assert cache.layers[3]["h"][1].eq(0).all() and cache.layers[3]["m"][0].eq(3).all()
    d_inner, H, dk = X.mdims(cfg)
    per_row = (3 * (H * dk * dk + H * dk + H + 3 * d_inner) + 4 * cfg.d_model) * 4
    assert cache.nbytes() == 2 * per_row
