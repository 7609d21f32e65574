"""The embeds archs (musicgen-large: GELU MLP, 4 MHA heads at smoke size;
internvl2-1b: a group of 7) and their stub frontends against the JAX
package, tied embeddings, and both launchers on every arch.

Smoke configs in float32, JAX weights through the bridge, the CORDIC
activations and softmax on. Logits within test_torch_models.py's 1e-3 (the
same cause: float32 round-off of the products, and the Q2.14 code steps it
moves), medians within 1e-6, every argmax equal.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import frontends as jfe  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.checkpoint import manager as ckpt  # noqa: E402
from repro_torch.models import frontends as fe  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

ATOL = 1e-3
EMBEDS = ["musicgen-large", "internvl2-1b"]
IMPLS = dict(softmax_impl="cordic_pallas")



@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread for these smoke-size tests: beside the suite's
    other workers, each with a pool of one thread a core, their many small
    operations ran up to ~60x slower than alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _cfgs(arch, **kw):
    j = dataclasses.replace(jconfigs.get_smoke(arch, act_impl="cordic_pallas"),
                            **IMPLS, **kw)
    t = dataclasses.replace(configs.get_smoke(arch, act_impl="cordic_pallas"),
                            **IMPLS, **kw)
    return j, t


@functools.lru_cache(maxsize=None)
def _params(arch, **kw):
    j, t = _cfgs(arch, **kw)
    jparams = JT.init(j, jax.random.PRNGKey(0))
    return jparams, T.load_jax_params(t, T.flatten_params(jparams), device="cpu")


def _close(got, want, scale=1.0):
    """Within ATOL (median 1e-6) of logits of magnitude ``scale``."""
    diff = np.abs(got - want) / scale
    assert np.median(diff) < 1e-6 and diff.max() < ATOL, diff.max()
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("fn", ["audio_frame_embeddings", "vision_patch_embeddings"])
def test_stub_frontends_draw_the_jax_stubs_values(fn):
    for seed in (0, 3):
        want = np.asarray(getattr(jfe, fn)(2, 5, 24, seed=seed))
        got = getattr(fe, fn)(2, 5, 24, seed=seed, device="cpu")
        assert got.dtype == torch.float32 and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), want)


def test_embeds_archs_leaves_bridge():
    """musicgen's GELU MLP leaves (w_in, b_in, w_out, b_out) and internvl2's
    SwiGLU ones map onto the JAX tree, every leaf once."""
    for arch in EMBEDS:
        jparams, model = _params(arch)
        flat = T.flatten_params(jparams)
        named = dict(model.named_parameters())
        assert {p for _, p, _ in T.jax_layout(model.cfg)} == set(flat)
        for name, path, i in T.jax_layout(model.cfg):
            want = flat[path] if i is None else flat[path][i]
            np.testing.assert_array_equal(named[name].detach().float().numpy(), want)
    assert hasattr(_params("musicgen-large")[1].blocks[0].mlp, "b_in")


@pytest.mark.parametrize("arch", EMBEDS)
def test_embeds_forward_matches_jax(arch):
    j, t = _cfgs(arch)
    jparams, model = _params(arch)
    e = np.array(jfe.audio_frame_embeddings(2, 24, j.d_model, seed=5))
    want = np.asarray(jax.jit(lambda p, x: JT.apply(p, {"embeds": x}, j)[0])(jparams, e))
    got = T.apply(model, {"embeds": torch.from_numpy(e)}, t)[0].numpy()
    _close(got, want)


@pytest.mark.parametrize("arch", EMBEDS)
def test_decode_after_embeds_prefill_matches_jax(arch):
    """A 9-position embeds prefill into a dense cache, then one decode step
    of one more embedding, on both sides."""
    j, t = _cfgs(arch)
    jparams, model = _params(arch)
    B, P, L = 2, 9, 16
    e = np.array(jfe.vision_patch_embeddings(B, P + 1, j.d_model, seed=6))

    @jax.jit
    def jrun(p, x):
        cache = JT.init_cache(j, B, L, jnp.float32)
        pre, _, cache = JT.apply(p, {"embeds": x[:, :P]}, j, cache)
        dec, _, _ = JT.apply(p, {"embeds": x[:, P:]}, j, cache)
        return pre, dec

    jpre, jdec = (np.asarray(a) for a in jrun(jparams, e))
    cache = T.init_cache(t, B, L, torch.float32, device="cpu")
    x = torch.from_numpy(e)
    pre = T.apply(model, {"embeds": x[:, :P]}, t, cache)[0].numpy()
    dec = T.apply(model, {"embeds": x[:, P:]}, t, cache)[0].numpy()
    assert cache.idx.tolist() == [P + 1] * B
    _close(pre, jpre)
    _close(dec, jdec)
    # the decode step's logits equal the no-cache forward's last position
    full = T.apply(model, {"embeds": x}, t)[0].numpy()
    np.testing.assert_allclose(dec[:, 0], full[:, -1], rtol=0, atol=ATOL)


def test_tied_embeddings_match_jax():
    """cfg.tie_embeddings: no lm_head leaf; the logits come from the embed
    table, as the JAX model computes them."""
    j, t = _cfgs("yi-9b", tie_embeddings=True)
    jparams, model = _params("yi-9b", tie_embeddings=True)
    assert "lm_head" not in jparams and model.lm_head is None
    assert {p for _, p, _ in T.jax_layout(t)} == set(T.flatten_params(jparams))
    toks = np.random.default_rng(0).integers(0, t.vocab_size, (2, 12)).astype(np.int32)
    want = np.asarray(jax.jit(lambda p, x: JT.apply(p, {"tokens": x}, j)[0])(jparams, toks))
    got = T.apply(model, {"tokens": torch.from_numpy(toks).long()}, t)[0].numpy()
    # the table's N(0, 1) rows give logits of ~sqrt(d_model) in size, not
    # the untied head's 0.02 scale: the bound is relative to the largest
    _close(got, want, scale=float(np.abs(want).max()))


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_train_launcher_trains_every_arch_on_the_cpu(arch, tmp_path, capsys):
    from repro_torch.launch import train as launch

    assert launch.main(["--arch", arch, "--smoke", "--steps", "1", "--device", "cpu",
                        "--ckpt-dir", str(tmp_path), "--compress"]) == 0
    out = capsys.readouterr().out
    assert "compress=True" in out and "final loss" in out
    assert ckpt.latest_step(str(tmp_path)) == 1


@pytest.mark.parametrize("arch", EMBEDS)
def test_serve_launcher_serves_the_embeds_archs_on_tokens(arch, capsys):
    """As the JAX launcher, the embeds archs are served on token ids."""
    from repro_torch.launch import serve as launch

    assert launch.main(["--arch", arch, "--smoke", "--device", "cpu",
                        "--requests", "2", "--slots", "2", "--max-new", "3",
                        "--max-len", "32"]) == 0
    out = capsys.readouterr().out
    assert "2 requests, 6 tokens" in out and "kv=paged" in out


@pytest.mark.parametrize("act_impl", ["exact", "cordic_float", "cordic_fixed"])
def test_train_launcher_takes_every_act_impl(act_impl, tmp_path, capsys):
    from repro_torch.launch import train as launch

    assert launch.main(["--arch", "musicgen-large", "--smoke", "--steps", "1",
                        "--device", "cpu", "--act-impl", act_impl,
                        "--ckpt-dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert f"act={act_impl}" in out and "remat=none" in out
