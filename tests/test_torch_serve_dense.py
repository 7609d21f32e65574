"""The port's dense KV plane and seeded sampling against the JAX
``ServeEngine`` (``kv_impl="dense"``, the config's default).

Smoke configs, the CORDIC kernels' datapath (the port's plain versions on
the CPU, the JAX Pallas kernels in interpret mode). The JAX engines are
built once per arch and knob set and reused across tests, so each compiles
its prefill and decode shapes once; the prompts stay inside one bucket
where chunking is not the point.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serve import engine as JE  # noqa: E402
from repro.serve import sampling as jsp  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serve import engine as E  # noqa: E402
from repro_torch.serve import sampling as sp  # noqa: E402
from test_torch_models import ATOL, spec_params  # noqa: E402

DS = "deepseek-v2-lite-16b"
ARCHS = ["yi-9b", DS]
KW = dict(slots=2, max_len=64, softmax_impl="cordic_pallas")
#: (temperature, top_k, greedy) knob sets: tests/test_serving.py's two
GREEDY, SAMPLED = (1.0, 0, True), (2.5, 8, False)
#: one batch of every kind: greedy, low and high temperature, top-k, a
#: temperature of 0 (greedy), top-1
MIXED = [GREEDY, (0.5, 0, False), SAMPLED, (0.0, 5, False), (1.3, 1, False)]
#: prompts inside the 16-token bucket, and ones that chunk at 16
PLENS = (5, 11, 3, 9)
CHUNK_PLENS = (5, 40, 17, 33)


@functools.lru_cache(maxsize=None)
def _models(arch):
    """(JAX cfg, port cfg, JAX params, port model), the port's weights
    through the bridge."""
    jcfg = jconfigs.get_smoke(arch, act_impl="cordic_pallas")
    cfg = configs.get_smoke(arch, act_impl="cordic_pallas")
    jparams = (spec_params(JT.model_spec(jcfg)) if arch == DS
               else JT.init(jcfg, jax.random.PRNGKey(3)))
    model = T.load_jax_params(cfg, T.flatten_params(jparams), device="cpu")
    return jcfg, cfg, jparams, model


@functools.lru_cache(maxsize=None)
def _jax_engine(arch, knobs=()):
    jcfg, _, jparams, _ = _models(arch)
    return JE.ServeEngine(jcfg, jparams, **KW, **dict(knobs))


def _requests(mod, vocab, knobs, plens=PLENS, max_new=6, seed=0):
    """Requests of ``mod`` (JE or E), request i with knob set
    knobs[i % len(knobs)] as that package's SamplingParams."""
    SP = jsp.SamplingParams if mod is JE else sp.SamplingParams
    rng = np.random.default_rng(seed)
    return [mod.Request(rid=i, prompt=rng.integers(0, vocab, n).astype(np.int32),
                        max_new_tokens=max_new,
                        sampling=SP(*knobs[i % len(knobs)]))
            for i, n in enumerate(plens)]


def _serve(eng, reqs):
    for r in reqs:
        eng.submit(r)
    eng.run()
    return [r.out for r in reqs]


def _jax_tokens(arch, knobs, knob_sets=(), **req_kw):
    _, cfg, _, _ = _models(arch)
    return _serve(_jax_engine(arch, knob_sets),
                  _requests(JE, cfg.vocab_size, knobs, **req_kw))


def _port(arch, **kw):
    _, cfg, _, model = _models(arch)
    return E.ServeEngine(cfg, model, device="cpu", **{**KW, **kw})


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("knobs", [GREEDY, SAMPLED], ids=["greedy", "sampled"])
def test_dense_tokens_identical_to_jax_engine(arch, knobs):
    """The config's default KV plane (dense), 4 requests through 2 slots:
    the JAX engine's tokens, greedy and seeded-sampled."""
    _, cfg, _, _ = _models(arch)
    eng = _port(arch)
    assert eng.kv_impl == "dense" and eng.pager is None
    got = _serve(eng, _requests(E, cfg.vocab_size, [knobs]))
    assert got == _jax_tokens(arch, [knobs])
    assert all(len(t) == 6 for t in got)
    assert not eng.has_work


@pytest.mark.parametrize("arch", ARCHS)
def test_dense_chunked_identical_to_jax_engine(arch):
    """prefill_chunk=16 on the dense plane (one row a dispatch, the
    mid-prefill rows kept in the slot): the JAX engine's tokens with the
    same chunk, on a batch mixing greedy and sampled requests."""
    _, cfg, _, _ = _models(arch)
    knob_sets = (("prefill_chunk", 16),)
    eng = _port(arch, prefill_chunk=16)
    assert eng.prefill_batch == 1
    got = _serve(eng, _requests(E, cfg.vocab_size, MIXED, plens=CHUNK_PLENS))
    assert got == _jax_tokens(arch, MIXED, knob_sets, plens=CHUNK_PLENS)
    if arch == "yi-9b":          # no MoE layer: chunking changes no token
        assert got == _serve(_port(arch), _requests(E, cfg.vocab_size, MIXED,
                                                    plens=CHUNK_PLENS))


def test_mixed_params_batch_identical_to_jax_engine():
    """Every kind of request in one batch; the greedy rows' tokens equal
    an all-greedy run's (a row's token depends on its own row only)."""
    _, cfg, _, _ = _models("yi-9b")
    plens = (5, 11, 3, 9, 7)
    got = _serve(_port("yi-9b"), _requests(E, cfg.vocab_size, MIXED, plens=plens))
    assert got == _jax_tokens("yi-9b", MIXED, plens=plens)
    greedy = _serve(_port("yi-9b"), _requests(E, cfg.vocab_size, [GREEDY],
                                              plens=plens))
    assert got[0] == greedy[0] and got[3] == greedy[3]
    assert got[2] != greedy[2]


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_tokens_equal_dense_tokens(arch):
    """The port's paged plane (table gather and the decode kernel's plain
    version) emits its dense plane's tokens, seeded-sampled, prompts
    across three buckets and slot reuse."""
    _, cfg, _, _ = _models(arch)
    plens = (5, 40, 17, 33, 9)
    dense = _serve(_port(arch), _requests(E, cfg.vocab_size, [SAMPLED, GREEDY],
                                          plens=plens))
    for attend in ("gather", "pallas"):
        eng = _port(arch, kv_impl="paged", paged_attend_impl=attend)
        assert _serve(eng, _requests(E, cfg.vocab_size, [SAMPLED, GREEDY],
                                     plens=plens)) == dense, attend


def test_batched_equals_sequential_under_sampling():
    """Four slots and one slot emit the same sampled streams: each request
    draws from its own key stream, whatever its slot or batch."""
    _, cfg, _, _ = _models("yi-9b")
    reqs = functools.partial(_requests, E, cfg.vocab_size, [(1.5, 8, False)],
                             plens=(5, 11, 3, 9, 14, 6))
    batched = _serve(_port("yi-9b", slots=4), reqs())
    assert batched == _serve(_port("yi-9b", slots=1), reqs())
    assert batched != _serve(_port("yi-9b", slots=4, seed=1), reqs())


@pytest.mark.parametrize("kw", [
    dict(paged_attend_impl="pallas"), dict(kv_quant="int8"),
    dict(prefix_cache=True)], ids=["pallas", "kv_quant", "prefix_cache"])
def test_dense_plane_refusals_are_the_jax_engines(kw):
    jcfg, cfg, jparams, model = _models("yi-9b")
    with pytest.raises(ValueError) as want:
        JE.ServeEngine(jcfg, jparams, **KW, kv_impl="dense", **kw)
    with pytest.raises(ValueError) as got:
        E.ServeEngine(cfg, model, device="cpu", **KW, kv_impl="dense", **kw)
    assert str(got.value) == str(want.value)


def test_dense_cache_helpers_against_jax():
    """init_cache / take_slot / insert_slot / stack_caches /
    override_cache_length: a bucket-wide prefill into one row of a stacked
    cache writes the JAX batch-1 cache's buffers and logits, and a decode
    step from it the JAX decode's logits (the model tests' tolerance)."""
    jcfg, cfg, jparams, model = _models("yi-9b")
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (1, 16))
    jc = JT.init_cache(jcfg, 1, 64, np.float32)
    jl, _, jc = JT.apply(jparams, {"tokens": toks}, jcfg, cache=jc)
    jc = JT.override_cache_length(jc, 11)
    jd, _, jc = JT.apply(jparams, {"tokens": toks[:, 3:4]}, jcfg, cache=jc)

    stacked = T.stack_caches([T.init_cache(cfg, 1, 64, device="cpu")
                              for _ in range(3)])
    assert stacked.idx.shape == (3,) and stacked.layers[0]["k"].shape == (
        3, 64, cfg.num_kv_heads, cfg.head_dim)
    row = T.take_slot(stacked, 1)
    t = torch.as_tensor(toks)
    tl = T.apply(model, {"tokens": t}, cfg, cache=row)[0]
    T.override_cache_length(row, 11)
    assert stacked.idx.tolist() == [0, 11, 0]
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    # layer 0, batch row 0: the prompt's 11 positions (the decode wrote 11)
    jk = np.asarray(jc["seg0"]["k"][0, 0])
    np.testing.assert_allclose(stacked.layers[0]["k"][1, :11].numpy(), jk[:11],
                               atol=ATOL)
    one = T.init_cache(cfg, 1, 64, device="cpu")
    one.copy_from(row)
    T.insert_slot(stacked, one, 2)
    assert stacked.idx.tolist() == [0, 11, 11]
    td = T.apply(model, {"tokens": t[:, 3:4].expand(3, 1)}, cfg, cache=stacked)[0]
    np.testing.assert_allclose(td[1].numpy(), np.asarray(jd)[0], atol=ATOL)
    assert torch.equal(td[1], td[2])
    assert stacked.idx.tolist() == [1, 12, 12]
