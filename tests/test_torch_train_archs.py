"""The port's train path for every block kind against the JAX package:
MLA and GShard MoE (deepseek-v2-lite, phi3.5-moe), mLSTM / sLSTM
(xlstm), Mamba2 and the shared block (zamba2), the GELU MLP and embeds
inputs (musicgen-large, internvl2-1b); ``cfg.remat``; the int8
error-feedback gradient compression; checkpoint trees crossing between the
two packages.

Smoke configs in float32, every datapath on the CORDIC kernels
(``act_impl``, ``softmax_impl``, ``loss_impl`` all ``"cordic_pallas"``: the
JAX Pallas kernels in interpret mode, the port's plain versions), the same
weights on both sides (the port's seeded init, bridged to the JAX tree),
one 4 x 32-token batch of the synthetic pipeline (embeds archs: the stub
frontend's embeddings of that shape).

Tolerances, measured with jax 0.9 on the CPU:
* Step-0 loss: rtol 1e-6, the dense train test's bound (7.6e-8 to 6.8e-7
  seen).
* Each gradient leaf, ``||g_port - g_jax|| <= rtol ||g_jax||``: the dense
  test's 5e-5 (which it holds on the global gradient norm) where it holds,
  phi3.5-moe (3.5e-5 seen); the other archs have leaves past it, and each
  gets its measured largest leaf difference times ~2 in ``LEAF_RTOL``:
  deepseek 1.9e-4 (``blocks.1.attn.kv_norm``; 38 of 61 leaves past 5e-5),
  xlstm 1.5e-4 (``blocks.1.mixer.b_if``; 13 leaves), zamba2 1.5e-4
  (``blocks.2.mixer.dt_bias``; 45 leaves), musicgen 5.2e-5
  (``blocks.1.attn.wk``, the only one), internvl2 8.8e-5
  (``blocks.1.attn.wk``; 8 leaves). The dense Yi smoke model has them too
  (2.6e-4 at this batch with JAX's PRNGKey(0) weights). The cause is
  float32 itself: against a float64 run of the port (exact activations,
  JAX's weights), JAX's float32 gradients are off by 2.0e-4 (Yi's first
  attention), 3.7e-3 (xLSTM's first block) and 2.5e-4 (Zamba2's conv), and
  the port's by as much (1.5e-4, 3.3e-3, 4.2e-4); the CORDIC datapaths add
  a code step where a round-off difference crosses a Q2.14 rounding edge
  (tests/test_torch_models.py).
* The global gradient norm: rtol 5e-5 (7.4e-6 at most seen).
* ``remat`` "full" and "dots": gradients bit-equal to "none".
* ``compress_grads``: bit-equal to the jitted JAX function.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.checkpoint import manager as jckpt  # noqa: E402
from repro.distributed import compression as jcomp  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.train import step as jstep  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.checkpoint import manager as ckpt  # noqa: E402
from repro_torch.data import pipeline as data  # noqa: E402
from repro_torch.distributed import compression as comp  # noqa: E402
from repro_torch.models import frontends  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train import step as step_lib  # noqa: E402

IMPLS = dict(softmax_impl="cordic_pallas", loss_impl="cordic_pallas")
ARCHS = ["deepseek-v2-lite-16b", "phi3.5-moe-42b-a6.6b", "xlstm-1.3b",
         "zamba2-1.2b", "musicgen-large", "internvl2-1b"]
B, S = 4, 32
LEAF_RTOL = {"deepseek-v2-lite-16b": 4e-4, "phi3.5-moe-42b-a6.6b": 5e-5,
             "xlstm-1.3b": 3e-4, "zamba2-1.2b": 3e-4, "musicgen-large": 1e-4,
             "internvl2-1b": 2e-4}



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


def _batch(cfg):
    """numpy inputs and labels: tokens, or the stub frontend's embeddings."""
    b = data.SyntheticLMDataset(data.DataConfig(
        vocab_size=cfg.vocab_size, seq_len=S, global_batch=B, seed=0)).batch_at(0)
    if cfg.input_mode == "embeds":
        e = frontends.audio_frame_embeddings(B, S, cfg.d_model, seed=1,
                                             device="cpu").numpy()
        return {"embeds": e, "labels": b["labels"]}
    return b


@functools.lru_cache(maxsize=None)
def _weights(arch):
    """The port's seeded float32 init as flat JAX paths."""
    _, t = _cfgs(arch)
    model = tf.init(t, 0, "cpu", dtype=torch.float32)
    return tf.flatten_params(tf.jax_tree(t, step_lib.named_params(model)))


def _jax_tree(flat):
    return jax.tree.map(jnp.asarray, tf._nest(flat))


@functools.lru_cache(maxsize=None)
def _jax_grads(arch):
    """JAX: (loss, flat gradients) of one jitted value_and_grad."""
    j, _ = _cfgs(arch)
    batch = {k: jnp.asarray(v) for k, v in _batch(j).items()}
    f = jax.jit(jax.value_and_grad(lambda p, b: JT.loss_fn(p, b, j), has_aux=True))
    (loss, _), g = f(_jax_tree(_weights(arch)), batch)
    return float(loss), tf.flatten_params(jax.tree.map(np.asarray, g))


@functools.lru_cache(maxsize=None)
def _port_grads(arch, remat="none"):
    """The port: (loss, {name: gradient}) as the train step computes them."""
    _, t = _cfgs(arch, remat=remat)
    model = tf.load_jax_params(t, _weights(arch), device="cpu", dtype=torch.float32)
    batch = {k: torch.from_numpy(v) for k, v in _batch(t).items()}
    loss, _, grads = step_lib.grads_of(model, batch, t)
    return loss.item(), grads


@pytest.mark.parametrize("arch", ARCHS)
def test_step0_loss_and_every_gradient_leaf_match_jax(arch):
    jloss, jflat = _jax_grads(arch)
    loss, grads = _port_grads(arch)
    assert loss == pytest.approx(jloss, rel=1e-6)
    _, t = _cfgs(arch)
    want = tf.from_jax_flat(t, jflat)
    assert sorted(want) == sorted(grads)
    for k, g in grads.items():
        w = np.asarray(want[k], np.float64)
        d = np.linalg.norm(g.numpy().astype(np.float64) - w)
        n = np.linalg.norm(w)
        if n == 0.0:          # the embed table under embeds inputs
            assert d == 0.0 and k == "embed", k
            continue
        assert d <= LEAF_RTOL[arch] * n, (k, d / n)
    gn = np.sqrt(sum(float(g.double().square().sum()) for g in grads.values()))
    jgn = np.sqrt(sum(float(np.square(np.asarray(w, np.float64)).sum())
                      for w in want.values()))
    assert gn == pytest.approx(jgn, rel=5e-5)


@pytest.mark.parametrize("remat", ["full", "dots"])
@pytest.mark.parametrize("arch", ARCHS)
def test_remat_gradients_bit_equal_to_none(arch, remat):
    base_loss, base = _port_grads(arch)
    loss, grads = _port_grads(arch, remat=remat)
    assert loss == base_loss
    for k in base:
        assert torch.equal(grads[k], base[k]), k


def test_remat_recomputes_the_forward_kernels():
    """Under remat="full" the backward reruns each block's forward: the
    activation wrapper is entered twice as often as under "none"."""
    from repro_torch.kernels import cordic_act as K

    calls = []
    orig = K.act_2d

    def counting(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    counts = {}
    for remat in ("none", "full"):
        calls.clear()
        K.act_2d = counting
        try:
            _port_grads.__wrapped__("zamba2-1.2b", remat=remat)
        finally:
            K.act_2d = orig
        counts[remat] = len(calls)
    # the shared block is not wrapped (as in JAX); its launches stay once
    assert counts["none"] < counts["full"] < 2 * counts["none"] + 1


def _grad_dict(seed):
    """Gradients of varied scales, with values at the codes' rounding edges
    (x / scale at k + 1/2, +-1 ulp) and scales so small that the 1e-30 of
    the scale counts."""
    rng = np.random.default_rng(seed)
    out = {}
    for i in range(40):
        amax = np.float32(10.0 ** rng.uniform(-31, 3))
        scale = np.float32(np.float64(amax) * np.float64(np.float32(1 / 127.0))
                           + np.float64(np.float32(1e-30)))
        k = rng.integers(-126, 126, 64).astype(np.float32)
        x = ((k + np.float32(0.5)) * scale).astype(np.float32)
        x = np.nextafter(x, np.where(rng.random(64) < 0.5, np.inf, -np.inf)
                         .astype(np.float32))
        x = np.where(np.abs(x) > amax, np.float32(0), x).astype(np.float32)
        x[0] = amax
        out[f"g{i:02d}"] = x.reshape(8, 8) if i % 2 else x
    out["normal"] = rng.normal(size=(33, 17)).astype(np.float32)
    return out


def test_compress_grads_bit_equal_to_jitted_jax():
    g0, g1 = _grad_dict(0), _grad_dict(1)
    jf = jax.jit(jcomp.compress_grads)
    jerr = jax.tree.map(lambda a: jnp.zeros_like(a), g0)
    terr = comp.init_error_state({k: torch.from_numpy(v) for k, v in g0.items()})
    for g in (g0, g1):              # two rounds: the error feedback carried
        jg, jerr = jf(g, jerr)
        tg, terr = comp.compress_grads({k: torch.from_numpy(v) for k, v in g.items()},
                                       terr)
        for k in g:
            np.testing.assert_array_equal(tg[k].numpy(), np.asarray(jg[k]), err_msg=k)
            np.testing.assert_array_equal(terr[k].numpy(), np.asarray(jerr[k]),
                                          err_msg=k)
    x = g0["normal"]
    jq, js = jax.jit(jcomp.quantize_int8)(x)
    q, s = comp.quantize_int8(torch.from_numpy(x))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(s) == float(js)
    np.testing.assert_array_equal(comp.dequantize_int8(q, s).numpy(),
                                  np.asarray(jcomp.dequantize_int8(jq, js)))


def test_compressed_step_feeds_the_compressed_grads_to_adamw():
    """train_step(compress=True): the error buffers after a step are
    compress_grads of that step's gradients from zero buffers, and the
    update is AdamW's on the dequantized gradients."""
    _, t = _cfgs("deepseek-v2-lite-16b")
    batch = {k: torch.from_numpy(v) for k, v in _batch(t).items()}
    opt = adamw.AdamWConfig(lr=1e-2)
    st = step_lib.init_state(t, 0, opt, compress=True, device="cpu")
    assert all(torch.equal(e, torch.zeros_like(e)) for e in st.err.values())
    ref = step_lib.init_state(t, 0, opt, device="cpu")
    _, grads = _port_grads("deepseek-v2-lite-16b")
    g2, e2 = comp.compress_grads(grads, comp.init_error_state(grads))
    st, m = step_lib.make_train_step(t, opt, compress=True)(st, batch)
    for k in e2:
        assert torch.equal(st.err[k], e2[k]), k
    adamw.apply_updates(step_lib.named_params(ref.params), ref.opt, g2, opt, m["lr_scale"])
    for (k, a), b in zip(step_lib.named_params(st.params).items(),
                         ref.params.parameters()):
        assert torch.equal(a, b), k


def _jax_state(tree):
    """A JAX TrainState of the port's checkpoint tree (numpy leaves)."""
    arr = lambda t: None if t is None else jax.tree.map(jnp.asarray, t)  # noqa: E731
    return jstep.TrainState(
        params=arr(tree.params),
        opt=jadamw.AdamWState(jnp.asarray(tree.opt.step), arr(tree.opt.mu),
                              arr(tree.opt.nu)),
        err=arr(tree.err))


@pytest.mark.parametrize("arch,compress", [
    ("deepseek-v2-lite-16b", False), ("phi3.5-moe-42b-a6.6b", True),
    ("xlstm-1.3b", True), ("zamba2-1.2b", False)])
def test_checkpoint_trees_cross_both_ways(arch, compress, tmp_path):
    """The port's state after one step (moments, error buffers) -> a
    checkpoint JAX restores bit for bit into its own TrainState, with JAX's
    paths; a JAX checkpoint of that state -> the port's tensors."""
    j, t = _cfgs(arch)
    opt = adamw.AdamWConfig(lr=1e-2)
    st = step_lib.init_state(t, 0, opt, compress=compress, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch(t).items()}
    st, _ = step_lib.make_train_step(t, opt, compress=compress)(st, batch)
    tree = step_lib.checkpoint_tree(st)
    # JAX's own init (its shapes) gives the layout the checkpoint must have
    like = jax.eval_shape(lambda: jstep.init_state(
        j, jax.random.PRNGKey(0), jadamw.AdamWConfig(), compress=compress))
    assert sorted(ckpt.tree_paths(tree)) == sorted(jckpt.tree_paths(like))
    ckpt.save(str(tmp_path / "port"), 1, tree, extra={"data_step": 1})
    jstate, extra = jckpt.restore(str(tmp_path / "port"), 1, like)
    assert extra == {"data_step": 1} and int(jstate.opt.step) == 1
    want = ckpt._flatten_with_paths(tree)
    for path, leaf in jckpt._flatten_with_paths(jstate).items():
        np.testing.assert_array_equal(np.asarray(leaf), want[path], err_msg=path)
    # and back: JAX writes, the port restores into a fresh state
    jckpt.save(str(tmp_path / "jax"), 1, _jax_state(tree), extra={"data_step": 1})
    fresh = step_lib.init_state(t, 1, opt, compress=compress, device="cpu")
    got, _ = ckpt.restore(str(tmp_path / "jax"), 1,
                          step_lib.checkpoint_tree(fresh, like=True))
    fresh = step_lib.load_checkpoint_tree(fresh, got)
    for a, b in zip(st.params.parameters(), fresh.params.parameters()):
        assert torch.equal(a, b)
    for k in st.opt.mu:
        assert torch.equal(st.opt.mu[k], fresh.opt.mu[k])
        assert torch.equal(st.opt.nu[k], fresh.opt.nu[k])
        if compress:
            assert torch.equal(st.err[k], fresh.err[k])
    assert int(fresh.opt.step) == 1
