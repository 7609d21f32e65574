"""The archs served since the recurrent slice, through the port's
``ServeEngine`` against the JAX engine: the recurrent pair (xlstm-1.3b,
zamba2-1.2b: dense plane, exact-length prefill) and four attention archs
(qwen2.5-32b with its QKV bias, phi3.5-moe's GQA + MoE blocks,
deepseek-coder-33b, command-r-plus-104b).

Smoke configs in float32, the CORDIC kernels' datapath (the port's plain
versions on the CPU, the JAX Pallas kernels in interpret mode), the JAX
parameters through the bridge (Qwen's biases drawn non-zero). The JAX
engines are built once per arch and reused; the recurrent archs compile a
prefill per prompt length, so the prompts take two lengths, neither a
bucket width.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import obs as jobs  # noqa: E402
from repro.kernels import paged_attention as JP  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serve import engine as JE  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch import obs as obs_lib  # noqa: E402
from repro_torch.kernels import paged_attention as PA  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serve import engine as E  # noqa: E402
from test_torch_models import spec_params  # noqa: E402

RECURRENT = ["xlstm-1.3b", "zamba2-1.2b"]
ATTENTION = ["qwen2.5-32b", "phi3.5-moe-42b-a6.6b", "deepseek-coder-33b",
             "command-r-plus-104b"]
KW = dict(slots=2, max_len=64, softmax_impl="cordic_pallas")
#: two lengths, neither a bucket width (16, 32, 64)
PLENS = (5, 11, 11, 5)


@functools.lru_cache(maxsize=None)
def _models(arch):
    """(JAX cfg, port cfg, JAX params, port model)."""
    jcfg = jconfigs.get_smoke(arch, act_impl="cordic_pallas")
    cfg = configs.get_smoke(arch, act_impl="cordic_pallas")
    jparams = spec_params(JT.model_spec(jcfg), seed=4)
    if cfg.qkv_bias:
        rng = np.random.default_rng(4)
        attn = jparams["seg0"]["attn"]
        for k in ("bq", "bk", "bv"):
            attn[k] = jnp.asarray(rng.normal(0, 0.5, attn[k].shape), jnp.float32)
    model = T.load_jax_params(cfg, T.flatten_params(jparams), device="cpu")
    return jcfg, cfg, jparams, model


def _requests(mod, vocab, plens=PLENS, max_new=5):
    rng = np.random.default_rng(0)
    return [mod.Request(rid=i, prompt=rng.integers(0, vocab, n).astype(np.int32),
                        max_new_tokens=max_new) for i, n in enumerate(plens)]


def _serve(eng, reqs):
    for r in reqs:
        eng.submit(r)
    eng.run()
    return [r.out for r in reqs]


@functools.lru_cache(maxsize=None)
def _jax_tokens(arch):
    jcfg, cfg, jparams, _ = _models(arch)
    return _serve(JE.ServeEngine(jcfg, jparams, **KW), _requests(JE, cfg.vocab_size))


def _port(arch, **kw):
    _, cfg, _, model = _models(arch)
    return E.ServeEngine(cfg, model, device="cpu", **{**KW, **kw})


@pytest.mark.parametrize("arch", RECURRENT + ATTENTION)
def test_greedy_tokens_identical_to_jax_engine(arch):
    """The config's default plane (dense), 4 requests through 2 slots."""
    _, cfg, _, _ = _models(arch)
    eng = _port(arch)
    got = _serve(eng, _requests(E, cfg.vocab_size))
    assert got == _jax_tokens(arch)
    assert all(len(t) == 5 for t in got)


@pytest.mark.parametrize("arch", ATTENTION)
def test_paged_tokens_equal_dense_tokens(arch):
    """Bucketed prefill on the paged plane, decoded by the block-walking
    kernel's plain version (Qwen: a group of 2 here, 5 at full width) and
    by the table gather: the dense plane's tokens, which are JAX's."""
    _, cfg, _, _ = _models(arch)
    for attend in ("pallas", "gather"):
        eng = _port(arch, kv_impl="paged", paged_attend_impl=attend)
        assert _serve(eng, _requests(E, cfg.vocab_size)) == _jax_tokens(arch), attend
        assert eng.prefill_tokens == 16 * len(PLENS)      # one bucket each


@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_prefill_at_exact_length(arch):
    """No bucket padding reaches a recurrent state: the engine prefills
    each prompt at its length (5 and 11, no bucket width), and its tokens
    equal a manual exact-length prefill plus a one-row decode loop per
    request in a fresh one-slot cache (the JAX
    test_recurrent_arch_prefill_not_padded): slots leak no state into
    each other or into the next occupant."""
    _, cfg, _, model = _models(arch)
    eng = _port(arch)
    assert not eng._bucketed and eng.scheduler.buckets is None
    reqs = _requests(E, cfg.vocab_size)
    got = _serve(eng, reqs)
    assert eng.prefill_tokens == sum(PLENS)
    prefill = E.make_prefill_step(cfg)
    for r, toks in zip(reqs, got):
        cache = T.init_cache(cfg, 1, KW["max_len"], device="cpu")
        with torch.inference_mode():
            logits = prefill(model, cache, torch.as_tensor(r.prompt[None]).long())
            want = [int(logits.argmax(-1))]
            for _ in range(len(toks) - 1):
                logits = T.apply(model, {"tokens": torch.tensor([[want[-1]]])},
                                 cfg, cache)[0]
                want.append(int(logits[0, -1].argmax()))
        assert toks == want


@pytest.mark.parametrize("arch", RECURRENT)
@pytest.mark.parametrize("kw", [dict(kv_impl="paged"), dict(prefill_chunk=16),
                                dict(prefix_cache=True),
                                dict(kv_impl="paged", prefix_cache=True)],
                         ids=["paged", "chunked", "prefix", "paged-prefix"])
def test_recurrent_refusals_raise_the_jax_errors(arch, kw):
    jcfg, cfg, jparams, model = _models(arch)
    with pytest.raises(ValueError) as want:
        JE.ServeEngine(jcfg, jparams, **KW, **kw)
    with pytest.raises(ValueError) as got:
        E.ServeEngine(cfg, model, device="cpu", **KW, **kw)
    assert str(got.value) == str(want.value)


def test_over_capacity_rejection_text_matches_jax():
    """A paged request needing more blocks than the pool holds: req.error
    and the reject event's reason are the JAX engine's, word for word."""
    jcfg, cfg, jparams, model = _models("deepseek-coder-33b")
    kw = dict(KW, kv_impl="paged", num_blocks=3)
    prompt = np.arange(40, dtype=np.int32)
    out = []
    for eng, mod in ((JE.ServeEngine(jcfg, jparams, obs=jobs.Observability(trace=True),
                                     **kw), JE),
                     (E.ServeEngine(cfg, model, device="cpu",
                                    obs=obs_lib.Observability(trace=True), **kw), E)):
        req = mod.Request(rid=7, prompt=prompt, max_new_tokens=6)
        eng.submit(req)
        ev = [e for e in eng.obs.trace.events if e.get("name") == "reject"]
        out.append((req.error, req.done, [e["args"]["reason"] for e in ev]))
    assert out[1] == out[0]
    assert "admission budgets the unshared footprint" in out[1][0]


@pytest.mark.parametrize("arch", RECURRENT + ATTENTION)
def test_launcher_serves_on_the_cpu(arch, capsys):
    from repro_torch.launch import serve as launch

    assert launch.main(["--arch", arch, "--smoke", "--device", "cpu",
                        "--requests", "2", "--slots", "2", "--max-new", "3",
                        "--max-len", "32"]) == 0
    out = capsys.readouterr().out
    assert "2 requests, 6 tokens" in out
    assert ("kv=dense" if arch in RECURRENT else "kv=paged") in out


@pytest.mark.parametrize("arch", RECURRENT)
def test_launcher_refuses_an_explicit_paged_plane(arch):
    from repro_torch.launch import serve as launch

    with pytest.raises(ValueError, match="attention-cache-only arch"):
        launch.main(["--arch", arch, "--smoke", "--device", "cpu",
                     "--kv-impl", "paged"])


@pytest.mark.parametrize("arch", RECURRENT + ["phi3.5-moe-42b-a6.6b"])
def test_the_once_served_only_kinds_train(arch, tmp_path):
    """The recurrent kinds and Phi-3.5-MoE, once served only, train through
    the step and the launcher (their gradients against JAX:
    tests/test_torch_train_archs.py)."""
    from repro_torch.launch import train as launch_train
    from repro_torch.optim import adamw
    from repro_torch.train import loop as loop_lib
    from repro_torch.train import step as step_lib
    from repro_torch.data.pipeline import DataConfig, SyntheticLMDataset

    cfg = configs.get_smoke(arch)
    state = step_lib.init_state(cfg, 0, adamw.AdamWConfig(), device="cpu")
    batch = SyntheticLMDataset(DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                          global_batch=2)).batch_at(0)
    _, m = step_lib.make_train_step(cfg, adamw.AdamWConfig())(
        state, loop_lib.to_device(batch, "cpu"))
    assert np.isfinite(float(m["loss"])) and np.isfinite(float(m["grad_norm"]))
    assert launch_train.main(["--arch", arch, "--smoke", "--device", "cpu",
                              "--steps", "1", "--ckpt-dir", str(tmp_path)]) == 0


def test_qwen_bias_leaves_bridge():
    jcfg, cfg, jparams, model = _models("qwen2.5-32b")
    flat = T.flatten_params(jparams)
    for k in ("bq", "bk", "bv"):
        np.testing.assert_array_equal(getattr(model.blocks[1].attn, k).numpy(),
                                      flat[f"seg0/attn/{k}"][1])
    assert len(T.jax_layout(cfg)) == sum(1 for _ in model.parameters())


@pytest.mark.parametrize("impl", ["exact", "cordic_pallas"])
def test_gqa_decode_group_of_five_matches_jax(impl):
    """Qwen2.5-32B's 40 query heads over 8 KV heads (a group of 5, no power
    of two): the plan takes it, and the plain version equals the JAX kernel
    within the decode tests' ATOL at a small geometry with that group."""
    plan = PA.gqa_plan(4, 8, 5, 128, 16, 8)
    assert plan.score_heads == 5 and plan.softmax_grid == (40, 4, 1)
    rng = np.random.default_rng(5)
    B, KH, G, hd, L, M = 3, 2, 5, 8, 4, 3
    q = rng.normal(size=(B, KH, G, hd)).astype(np.float32)
    kp = rng.normal(size=(1 + B * M, L, KH, hd)).astype(np.float32)
    vp = rng.normal(size=kp.shape).astype(np.float32)
    tables = (1 + np.arange(B * M, dtype=np.int32)).reshape(B, M)
    k_len = np.asarray([12, 5, 1], np.int32)
    args = (q, kp, vp, tables, k_len)
    want = np.asarray(JP.gqa_decode(*map(jnp.asarray, args), scale=0.3,
                                    softmax_impl=impl, interpret=True))
    got = PA.gqa_decode(*map(torch.from_numpy, args), scale=0.3,
                        softmax_impl=impl).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)
