"""Chunked prefill, multi-row prefill and log-prob ``score`` on the port's
paged engine against the JAX ``ServeEngine`` with the same knobs.

Smoke configs, greedy, the CORDIC kernels' datapath (the port's plain
versions on the CPU, the JAX Pallas kernels in interpret mode). A GShard
MoE layer sizes its expert capacity from the dispatch width, so for
DeepSeek-V2-Lite the gate is the JAX engine with the same chunk, row count
and budget; for Yi (no MoE) chunked serving also equals unchunked, as
tests/test_scheduler.py holds the JAX engine, with the prefix cache too. ``score`` is held to the JAX
engine's within the logit tolerance of tests/test_torch_models.py.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serve import engine as JE  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serve import engine as E  # noqa: E402
from test_torch_models import ATOL, spec_params  # noqa: E402

DS = "deepseek-v2-lite-16b"
ENGINE_KW = dict(slots=4, max_len=64, softmax_impl="cordic_pallas",
                 kv_impl="paged", paged_attend_impl="pallas")
#: prompts spanning single-shot rows and 2-3 chunks of 16
PLENS = (5, 40, 17, 33, 9, 24)


@functools.lru_cache(maxsize=None)
def _models(arch):
    """(JAX cfg, port cfg, JAX params, port model) of an arch's smoke
    config, the port's weights through the bridge."""
    jcfg = jconfigs.get_smoke(arch, act_impl="cordic_pallas")
    cfg = configs.get_smoke(arch, act_impl="cordic_pallas")
    jparams = (spec_params(JT.model_spec(jcfg)) if arch == DS
               else JT.init(jcfg, jax.random.PRNGKey(3)))
    model = T.load_jax_params(cfg, T.flatten_params(jparams), device="cpu")
    return jcfg, cfg, jparams, model


def _prompts(vocab, plens=PLENS, seed=7):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in plens]


def _serve(mod, cfg, params, prompts, max_new=5, **kw):
    extra = {} if mod is JE else {"device": "cpu"}
    eng = mod.ServeEngine(cfg, params, **{**ENGINE_KW, **kw}, **extra)
    reqs = [mod.Request(rid=i, prompt=p, max_new_tokens=max_new)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    return eng, [r.out for r in reqs]


@functools.lru_cache(maxsize=None)
def _jax_tokens(arch, knobs):
    jcfg, cfg, jparams, _ = _models(arch)
    return _serve(JE, jcfg, jparams, _prompts(cfg.vocab_size), **dict(knobs))[1]


KNOBS = {
    "chunk16-batch1": dict(prefill_chunk=16, prefill_batch=1),
    "chunk16-batch4": dict(prefill_chunk=16, prefill_batch=4),
    "chunk16-budget32": dict(prefill_chunk=16, max_prefill_tokens=32),
}


@pytest.mark.parametrize("arch", ["yi-9b", DS])
@pytest.mark.parametrize("knobs", list(KNOBS), ids=list(KNOBS))
def test_chunked_tokens_identical_to_jax_engine(arch, knobs):
    """The port with a prefill chunk, a prefill row count and a token
    budget emits the JAX engine's tokens with the same knobs; it chunks
    (the 40-token prompt takes three dispatches) and packs rows."""
    _, cfg, _, model = _models(arch)
    kw = KNOBS[knobs]
    eng, got = _serve(E, cfg, model, _prompts(cfg.vocab_size), **kw)
    assert got == _jax_tokens(arch, tuple(sorted(kw.items())))
    assert eng.prefill_batch == kw.get("prefill_batch", ENGINE_KW["slots"])
    assert eng.pager.blocks_in_use == 0 and not eng.scheduler.chunking


def test_chunked_equals_unchunked_on_a_dense_model():
    """Yi has no MoE layer: chunked and multi-row serving emit the
    unchunked engine's tokens (the JAX engine's own bar,
    tests/test_scheduler.py), and the unchunked port equals JAX."""
    _, cfg, _, model = _models("yi-9b")
    _, base = _serve(E, cfg, model, _prompts(cfg.vocab_size))
    assert base == _jax_tokens("yi-9b", ())
    for kw in KNOBS.values():
        assert _serve(E, cfg, model, _prompts(cfg.vocab_size), **kw)[1] == base, kw


def test_mid_prefill_slot_left_out_of_decode():
    """A slot mid-chunking emits nothing until its final chunk lands; the
    iterations before it run prefill only."""
    _, cfg, _, model = _models("yi-9b")
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size, 48)
    eng = E.ServeEngine(cfg, model, device="cpu", **{**ENGINE_KW, "slots": 2},
                        prefill_chunk=16)
    req = E.Request(rid=0, prompt=prompt, max_new_tokens=4)
    eng.submit(req)
    assert eng.step() == 1 and req.out == [] and 0 in eng.scheduler.chunking
    assert eng.step() == 1 and req.out == []
    eng.step()                     # the final chunk, then this iteration's decode
    assert len(req.out) == 2 and 0 not in eng.scheduler.chunking
    eng.run()
    assert len(req.out) == 4


def test_short_request_not_blocked_by_a_long_prefill():
    """A short prompt behind a 64-token (four-chunk) one gets its first
    token on the first iteration and decodes on every iteration while the
    long prompt streams in."""
    _, cfg, _, model = _models("yi-9b")
    rng = np.random.default_rng(0)
    long = E.Request(rid=0, prompt=rng.integers(0, cfg.vocab_size, 64),
                     max_new_tokens=1)
    short = E.Request(rid=1, prompt=rng.integers(0, cfg.vocab_size, 4),
                      max_new_tokens=8)
    eng = E.ServeEngine(cfg, model, device="cpu", **{**ENGINE_KW, "slots": 2},
                        prefill_chunk=16)
    eng.submit(long)
    eng.submit(short)
    eng.step()
    assert len(short.out) == 2 and 0 in eng.scheduler.chunking
    eng.step()
    assert len(short.out) == 3 and 0 in eng.scheduler.chunking
    eng.run()
    assert long.done and short.done and len(long.out) == 1 and len(short.out) == 8


def test_chunked_int8_prefix_cache_equals_cache_off():
    """Int8 pools, a shared 32-token prompt: chunked serving with the
    prefix cache (whole rows, several a dispatch, resumed rows pinned like
    continuations) emits the cache-off tokens, and those of the JAX engine
    with the same knobs."""
    jcfg, cfg, jparams, model = _models("yi-9b")
    rng = np.random.default_rng(4)
    shared = rng.integers(0, cfg.vocab_size, 32).astype(np.int32)
    prompts = [np.concatenate([shared, rng.integers(0, cfg.vocab_size, n)]).astype(np.int32)
               for n in (3, 9, 20, 1, 14)]
    kw = dict(kv_quant="int8", prefill_chunk=16)
    _, off = _serve(E, cfg, model, prompts, **kw)
    eng = E.ServeEngine(cfg, model, device="cpu", prefix_cache=True, **{**ENGINE_KW, **kw})
    groups = []
    dispatch = eng._dispatch_prefill
    eng._dispatch_prefill = lambda g: (groups.append(len(g)), dispatch(g))
    reqs = [E.Request(rid=i, prompt=p, max_new_tokens=5) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    on = [r.out for r in reqs]
    assert eng.prefix.hits > 0 and not hasattr(eng, "prefill_piece")
    assert eng.prefill_batch == ENGINE_KW["slots"] and max(groups) > 1
    assert on == off
    assert on == _serve(JE, jcfg, jparams, prompts, prefix_cache=True, **kw)[1]


@pytest.mark.parametrize("impl", ["exact", "cordic", "cordic_pallas"])
def test_score_matches_jax_engine(impl):
    """Teacher-forced log-probs of a 24-token prompt through each loss
    impl's log-softmax, within the model tests' logit tolerance."""
    jcfg, cfg, jparams, model = _models("yi-9b")
    prompt = np.random.default_rng(2).integers(0, cfg.vocab_size, 24).astype(np.int32)
    want = JE.ServeEngine(jcfg, jparams, loss_impl=impl, **ENGINE_KW).score(prompt)
    got = E.ServeEngine(cfg, model, device="cpu", loss_impl=impl,
                        **ENGINE_KW).score(prompt)
    assert got.shape == want.shape == (23,) and got.dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=ATOL)


def test_prefill_batch_checked():
    """prefill_batch >= 1, defaulting as in the JAX engine (``slots`` when
    chunking on the paged plane, else 1), with the prefix cache as without
    it, on a model with MoE layers or without; any row count is taken under
    the cache."""
    _, cfg, _, model = _models("yi-9b")
    with pytest.raises(ValueError, match="prefill_batch"):
        E.ServeEngine(cfg, model, device="cpu", prefill_batch=0, **ENGINE_KW)
    eng = E.ServeEngine(cfg, model, device="cpu", **ENGINE_KW)
    assert eng.prefill_batch == 1 and eng.scheduler.prefill_chunk is None
    eng = E.ServeEngine(cfg, model, device="cpu", prefix_cache=True,
                        prefill_chunk=16, prefill_batch=2, **ENGINE_KW)
    assert eng.prefill_batch == 2
    eng = E.ServeEngine(cfg, model, device="cpu", prefix_cache=True,
                        prefill_chunk=16, **ENGINE_KW)
    assert eng.prefill_batch == ENGINE_KW["slots"]
    assert not hasattr(eng, "prefill_piece") and not hasattr(E.ServeEngine, "prefill_piece")
    _, dcfg, _, dmodel = _models(DS)
    eng = E.ServeEngine(dcfg, dmodel, device="cpu", prefix_cache=True,
                        prefill_chunk=16, **ENGINE_KW)
    assert eng.prefill_batch == ENGINE_KW["slots"]


def test_launcher_serves_chunked_on_the_cpu(capsys):
    from repro_torch.launch import serve as launch

    assert launch.main(["--arch", "yi-9b", "--smoke", "--device", "cpu",
                        "--requests", "3", "--slots", "2", "--max-new", "4",
                        "--max-len", "64", "--prefill-chunk", "16",
                        "--prefill-batch", "2", "--max-prefill-tokens", "32"]) == 0
    assert "3 requests, 12 tokens" in capsys.readouterr().out
