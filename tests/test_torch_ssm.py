"""The port's Mamba2 block (``repro_torch/models/ssm.py``) and the Zamba2
smoke model (Mamba2 layers and the shared attention block) against the JAX
ones, with the JAX parameters.

Float32 smoke width (d_model 64, head_dim 16, d_state 16, chunk 16), for the
activation datapaths ``exact``, ``cordic_fixed`` and ``cordic_pallas``;
tolerances as tests/test_torch_xlstm.py: within the 1e-3 of
tests/test_torch_models.py against JAX, the reference's own bounds
(tests/test_models.py) for the port against itself.
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
from repro.models import ssm as JS  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import ssm as S  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from test_torch_models import ATOL, spec_params  # noqa: E402
from test_torch_xlstm import _logits_close, _x, load_module  # noqa: E402

ARCH = "zamba2-1.2b"
IMPLS = ("exact", "cordic_fixed", "cordic_pallas")


def _cfgs(impl, **ssm):
    jcfg = jconfigs.get_smoke(ARCH, act_impl=impl)
    cfg = configs.get_smoke(ARCH, act_impl=impl)
    if ssm:
        jcfg = dataclasses.replace(jcfg, ssm=dataclasses.replace(jcfg.ssm, **ssm))
        cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm, **ssm))
    return jcfg, cfg


@functools.lru_cache(maxsize=None)
def _block(seed):
    """(JAX params, port module) of one Mamba2 block, float32, with a
    non-zero conv bias and dt bias and spread decays."""
    _, cfg = _cfgs("exact")
    jp = jcm.init_params(JS.mamba2_spec(cfg), jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    for k, v in (("conv_b", 0.1), ("dt_bias", 0.5), ("A_log", 0.7), ("D", 0.3)):
        jp[k] = jp[k] + jnp.asarray(rng.normal(0, v, jp[k].shape), jnp.float32)
    module = S.Mamba2(cfg, dtype=torch.float32, device="cpu")
    return jp, load_module(module, jp)


@pytest.mark.parametrize("impl", IMPLS)
def test_mamba2_forward_and_decode_match_jax(impl):
    """A 21-position prefill into a cache (two chunks, the inert pad) and
    one decode step against JAX's: outputs and the final state; the port's
    no-cache forward over the same positions too."""
    jcfg, cfg = _cfgs(impl)
    jp, module = _block(3)
    x = _x(3, (2, 22, cfg.d_model))
    jc = JS.mamba2_init_cache(jcfg, 2)
    cache = S.mamba2_init_cache(cfg, 2, device="cpu")
    for sl in (slice(0, 21), slice(21, 22)):
        want, jc = JS.mamba2_apply(jp, jnp.asarray(x[:, sl]), jcfg, cache=jc)
        got = S.mamba2_apply(module, torch.from_numpy(x[:, sl]), cfg, cache)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)
        if sl.start == 0:
            fwd = S.mamba2_apply(module, torch.from_numpy(x[:, sl]), cfg).numpy()
            np.testing.assert_allclose(fwd, np.asarray(want), rtol=0, atol=ATOL)
    for k in ("ssm", "conv"):
        np.testing.assert_allclose(cache[k].numpy(), np.asarray(jc[k]), rtol=1e-4,
                                   atol=ATOL, err_msg=k)


def test_mamba2_chunk_invariance_and_decode():
    """tests/test_models.py for the port: chunk 8 against 32, and a decode
    after an 8-position prefill against the 9th position (2e-4 each)."""
    _, module = _block(2)
    x = torch.from_numpy(_x(2, (2, 32, 64)))
    y8 = S.mamba2_apply(module, x, _cfgs("exact", chunk=8)[1])
    y32 = S.mamba2_apply(module, x, _cfgs("exact", chunk=32)[1])
    torch.testing.assert_close(y8, y32, rtol=0, atol=2e-4)
    _, cfg = _cfgs("exact")
    cache = S.mamba2_init_cache(cfg, 2, device="cpu")
    S.mamba2_apply(module, x[:, :8], cfg, cache)
    y_dec = S.mamba2_apply(module, x[:, 8:9], cfg, cache)
    torch.testing.assert_close(y_dec[:, 0], S.mamba2_apply(module, x[:, :9], cfg)[:, 8],
                               rtol=0, atol=2e-4)


@functools.lru_cache(maxsize=None)
def _model():
    jcfg, cfg = _cfgs("exact")
    jp = spec_params(JT.model_spec(jcfg), seed=2)
    return jp, T.load_jax_params(cfg, T.flatten_params(jp), device="cpu")


def test_bridge_plan_and_shared_block():
    """The execution plan (segments broken by the shared block's
    applications) equals JAX's for the smoke and the full config; the
    shared block's leaves land once, from the top-level ``shared`` subtree,
    and jax_tree gives the tree back."""
    jp, model = _model()
    jcfg, cfg = _cfgs("exact")
    assert T.execution_plan(cfg) == JT.execution_plan(jcfg)
    full, jfull = configs.get_config(ARCH), jconfigs.get_config(ARCH)
    assert T.execution_plan(full) == JT.execution_plan(jfull)
    assert T.num_shared_apps(full) == JT.num_shared_apps(jfull) == 6
    assert [s[1:] for s in T.segments(full)][-1] == ("mamba2", 36, 2)
    flat = T.flatten_params(jp)
    np.testing.assert_array_equal(model.shared.attn.wq.numpy(), flat["shared/attn/wq"])
    np.testing.assert_array_equal(model.shared.ln2.numpy(), flat["shared/ln2/scale"])
    np.testing.assert_array_equal(model.blocks[3].mixer.A_log.numpy(),
                                  flat["seg1/mixer/A_log"][1])
    back = T.flatten_params(T.jax_tree(cfg, dict(model.named_parameters())))
    assert sorted(back) == sorted(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], np.asarray(flat[k]))


@pytest.mark.parametrize("impl", IMPLS)
def test_model_forward_and_decode_match_jax(impl):
    """The Zamba2 smoke model (four Mamba2 layers, the shared block after
    layers 2 and 4, each application with its own KV cache) with the JAX
    weights: a 21-token prefill into a dense cache and one decode step
    against JAX's, and the no-cache forward, logits within ATOL."""
    jcfg, cfg = _cfgs(impl)
    jp, model = _model()
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 22)).astype(np.int32)
    jc = JT.init_cache(jcfg, 2, 32, jnp.float32)
    cache = T.init_cache(cfg, 2, 32, device="cpu")
    assert len(cache.layers) == cfg.num_layers + 2
    for sl in (slice(0, 21), slice(21, 22)):
        want, _, jc = JT.apply(jp, {"tokens": jnp.asarray(toks[:, sl])}, jcfg, jc)
        t = torch.from_numpy(toks[:, sl]).long()
        _logits_close(T.apply(model, {"tokens": t}, cfg, cache)[0].numpy(),
                      np.asarray(want))
        if sl.start == 0:
            _logits_close(T.apply(model, {"tokens": t}, cfg)[0].numpy(),
                          np.asarray(want))
    # each application's K/V against its JAX cache
    for app in range(2):
        np.testing.assert_allclose(cache.layers[cfg.num_layers + app]["k"].numpy(),
                                   np.asarray(jc["shared"]["k"][app]), rtol=0, atol=ATOL)
