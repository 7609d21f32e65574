"""The port's train path (optim, data, losses, step, checkpoint, loop,
launcher) against the JAX package, on the Yi smoke config.

Tolerances:
* AdamW on the same inputs: rtol 1e-6 (float32; XLA may fuse a multiply-add
  the port rounds twice).
* Train-step parity, 5 steps from the JAX weights on one fixed batch (lr
  1e-2, warmup 2, total 5, all three impls "cordic_pallas"). Step 0: loss
  rtol 1e-6, grad norm rtol 5e-5 (float32 round-off of the matmuls, which
  sum in another order). Later steps: loss rtol 5e-4, grad norm rtol 5e-2
  (measured with jax 0.9 on the CPU: 4.7e-5 and 1.7e-2). The cause is the
  recipe, not the port: Adam divides each gradient entry by its own
  magnitude, so a round-off difference in a near-zero entry becomes a
  full-size update. ``test_parity_limits_match_the_recipes_own_spread``
  is the witness: JAX against itself with its weights nudged one float32
  ulp spreads by as much (9.0e-5 and 2.0e-2), while the order of the
  CORDIC row sums, the other place where port and JAX differ, moves
  nothing (those sums of dyadic codes are exact at the smoke widths).
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
from repro.data import pipeline as jdata  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import schedule as jsched  # noqa: E402
from repro.train import losses as jlosses  # noqa: E402
from repro.train import step as jstep  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.checkpoint import manager as ckpt  # noqa: E402
from repro_torch.data import pipeline as data  # noqa: E402
from repro_torch.distributed.fault_tolerance import FailureInjector  # noqa: E402
from repro_torch.kernels import softmax_cordic as SM  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.optim import adamw, schedule  # noqa: E402
from repro_torch.train import loop as loop_lib  # noqa: E402
from repro_torch.train import losses  # noqa: E402
from repro_torch.train import step as step_lib  # noqa: E402

IMPLS = dict(softmax_impl="cordic_pallas", loss_impl="cordic_pallas")
RECIPE = dict(warmup_steps=2, total_steps=5)
LR = 1e-2


def _cfgs():
    j = dataclasses.replace(jconfigs.get_smoke("yi-9b", act_impl="cordic_pallas"),
                            **IMPLS)
    t = dataclasses.replace(configs.get_smoke("yi-9b", act_impl="cordic_pallas"),
                            **IMPLS)
    return j, t


def _batch(step=0):
    j, _ = _cfgs()
    ds = data.SyntheticLMDataset(data.DataConfig(
        vocab_size=j.vocab_size, seq_len=32, global_batch=8, seed=0))
    return ds.batch_at(step)


# ---------------------------------------------------------------------------
# optim
# ---------------------------------------------------------------------------
def test_adamw_step_matches_jax():
    rng = np.random.default_rng(0)
    shapes = {"a": (5, 7), "b": (11,), "c": (3, 4, 2)}
    p = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    g = {k: rng.normal(size=s).astype(np.float32) * 3 for k, s in shapes.items()}
    mu = {k: rng.normal(size=s).astype(np.float32) * 0.1 for k, s in shapes.items()}
    nu = {k: rng.random(s).astype(np.float32) * 0.1 for k, s in shapes.items()}
    cfg = dict(lr=1e-2, grad_clip=1.0)
    jp, jst, jm = jadamw.apply_updates(
        jax.tree.map(jnp.asarray, p),
        jadamw.AdamWState(jnp.asarray(4, jnp.int32), jax.tree.map(jnp.asarray, mu),
                          jax.tree.map(jnp.asarray, nu)),
        jax.tree.map(jnp.asarray, g), jadamw.AdamWConfig(**cfg), 0.7)
    tp = {k: torch.from_numpy(v.copy()) for k, v in p.items()}
    st = adamw.AdamWState(torch.tensor(4, dtype=torch.int32),
                          {k: torch.from_numpy(v.copy()) for k, v in mu.items()},
                          {k: torch.from_numpy(v.copy()) for k, v in nu.items()})
    _, tst, tm = adamw.apply_updates(tp, st, {k: torch.from_numpy(v) for k, v in g.items()},
                                     adamw.AdamWConfig(**cfg), torch.tensor(0.7))
    assert int(tst.step) == int(jst.step) == 5
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-6)
    for k in shapes:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(tst.mu[k].numpy(), np.asarray(jst.mu[k]), rtol=1e-6)
        np.testing.assert_allclose(tst.nu[k].numpy(), np.asarray(jst.nu[k]), rtol=1e-6)
    clipped, gn = adamw.clip_by_global_norm({k: torch.from_numpy(v) for k, v in g.items()}, 1.0)
    jclipped, jgn = jadamw.clip_by_global_norm(jax.tree.map(jnp.asarray, g), 1.0)
    for k in shapes:
        np.testing.assert_allclose(clipped[k].numpy(), np.asarray(jclipped[k]), rtol=1e-6)


def test_schedules_match_jax():
    for kw in (dict(warmup_steps=2, total_steps=5), dict(warmup_steps=10, total_steps=100),
               dict(warmup_steps=0, total_steps=7)):
        steps = np.arange(0, kw["total_steps"] + 3)
        want = np.asarray(jsched.warmup_cosine(jnp.asarray(steps), **kw))
        got = schedule.warmup_cosine(torch.from_numpy(steps).int(), **kw).numpy()
        # equal up to a few float32 ulps: the cosine comes from another
        # library, and XLA may fuse the final multiply-add
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert float(schedule.constant(3, value=0.5)) == float(jsched.constant(3, value=0.5))


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------
def test_batches_identical_and_iterator_resume():
    kw = dict(vocab_size=512, seq_len=32, global_batch=8, seed=3)
    ours = data.SyntheticLMDataset(data.DataConfig(**kw))
    theirs = jdata.SyntheticLMDataset(jdata.DataConfig(**kw))
    it = data.DataIterator(ours)
    for step in range(4):
        got, want = next(it), theirs.batch_at(step)
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(got[k], want[k])
    resumed = data.DataIterator(ours)
    resumed.restore(it.state())
    np.testing.assert_array_equal(next(resumed)["tokens"], theirs.batch_at(4)["tokens"])


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("impl", ["exact", "cordic_pallas"])
def test_token_nll_backward_is_softmax_minus_onehot(impl):
    rng = np.random.default_rng(4)
    logits = torch.from_numpy(rng.normal(size=(2, 5, 33)).astype(np.float32) * 3)
    labels = torch.from_numpy(rng.integers(0, 33, (2, 5)).astype(np.int32))
    g = torch.from_numpy(rng.normal(size=(2, 5)).astype(np.float32))
    x = logits.clone().requires_grad_(True)
    nll = losses.token_nll(x, labels, impl)
    (nll * g).sum().backward()
    logp = losses.log_softmax_fn(impl)(logits)
    onehot = torch.nn.functional.one_hot(labels.long(), 33).float()
    assert torch.equal(x.grad, g[..., None] * (torch.exp(logp) - onehot))
    if impl == "exact":       # the CORDIC values: test_torch_softmax_cordic.py
        want = np.asarray(jlosses.token_nll(jnp.asarray(logits.numpy()),
                                            jnp.asarray(labels.numpy()), impl))
        np.testing.assert_allclose(nll.detach().numpy(), want, rtol=1e-6,
                                   atol=1e-6)


def test_masked_cross_entropy_matches_jax():
    rng = np.random.default_rng(5)
    logits = rng.normal(size=(3, 6, 40)).astype(np.float32)
    labels = rng.integers(0, 40, (3, 6)).astype(np.int32)
    mask = (rng.random((3, 6)) < 0.6).astype(np.float32)
    for m in (mask, np.zeros_like(mask), None):
        got = losses.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                                   None if m is None else torch.from_numpy(m))
        want = jlosses.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                     None if m is None else jnp.asarray(m))
        assert float(got) == pytest.approx(float(want), rel=1e-6, abs=1e-7)
    # loss_impl="cordic": the plain fixed-point log-softmax, as in JAX
    from repro.cordic_engine import functions as JF

    want = np.asarray(jax.jit(JF.log_softmax_fixed)(logits))
    got = losses.log_softmax_fn("cordic")(torch.from_numpy(logits)).numpy()
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# the train step against JAX, and checkpoints both ways
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _jax_run(ckpt_dir: str):
    """JAX: 5 steps of the recipe from PRNGKey(0) on batch_at(0), with a
    checkpoint written after 2 steps. Returns (initial flat params, [(loss,
    grad_norm)], the jitted step, the state after 2 steps)."""
    jcfg, _ = _cfgs()
    opt = jadamw.AdamWConfig(lr=LR)
    state = jstep.init_state(jcfg, jax.random.PRNGKey(0), opt)
    flat = tf.flatten_params(jax.tree.map(np.asarray, state.params))
    step = jax.jit(jstep.make_train_step(jcfg, opt, **RECIPE))
    batch = {k: jnp.asarray(v) for k, v in _batch().items()}
    hist, after2 = [], None
    for i in range(5):
        state, m = step(state, batch)
        hist.append((float(m["loss"]), float(m["grad_norm"])))
        if i == 1:
            jckpt.save(ckpt_dir, 2, state, extra={"data_step": 2})
            after2 = state
    return flat, hist, step, after2


JAX_CKPT_DIR = []


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    JAX_CKPT_DIR.append(str(tmp_path_factory.mktemp("jax_ckpt")))
    return _jax_run(JAX_CKPT_DIR[0])


def _port_state(flat):
    _, tcfg = _cfgs()
    params = tf.load_jax_params(tcfg, flat, device="cpu", dtype=torch.float32)
    return step_lib.TrainState(params, adamw.init(step_lib.named_params(params)), None)


def _port_step():
    _, tcfg = _cfgs()
    return step_lib.make_train_step(tcfg, adamw.AdamWConfig(lr=LR), **RECIPE)


def test_train_step_parity_with_jax(jax_run):
    flat, jhist, _, _ = jax_run
    state, train_step = _port_state(flat), _port_step()
    batch = loop_lib.to_device(_batch(), "cpu")
    for i, (jl, jg) in enumerate(jhist):
        state, m = train_step(state, batch)
        loss, gn = float(m["loss"]), float(m["grad_norm"])
        assert np.isfinite(loss) and np.isfinite(gn)
        assert loss == pytest.approx(jl, rel=1e-6 if i == 0 else 5e-4), i
        assert gn == pytest.approx(jg, rel=5e-5 if i == 0 else 5e-2), i
    assert jhist[-1][0] < jhist[0][0]


def _rel_spread(hist, ref):
    """Largest relative difference of (loss, grad norm) over steps 1-4."""
    return tuple(max(abs(h[i] - r[i]) / abs(r[i]) for h, r in zip(hist[1:], ref[1:]))
                 for i in (0, 1))


def test_parity_limits_match_the_recipes_own_spread(jax_run, monkeypatch):
    flat, jhist, jax_step, _ = jax_run
    # JAX against itself, every float32 weight nudged one ulp: it spreads
    # within the parity limits (5e-4, 5e-2) and by more than a tenth of them
    jcfg, _ = _cfgs()
    state = jstep.init_state(jcfg, jax.random.PRNGKey(0), jadamw.AdamWConfig(lr=LR))
    state = state._replace(params=jax.tree.map(
        lambda a: jnp.nextafter(a, jnp.inf) if a.dtype == jnp.float32 else a,
        state.params))
    batch = {k: jnp.asarray(v) for k, v in _batch().items()}
    nudged = []
    for _ in range(5):
        state, m = jax_step(state, batch)
        nudged.append((float(m["loss"]), float(m["grad_norm"])))
    loss_spread, gn_spread = _rel_spread(nudged, jhist)
    assert 5e-5 < loss_spread <= 5e-4 and 5e-3 < gn_spread <= 5e-2, nudged

    # the port with its CORDIC row sums in another order (XLA's windows
    # over the reversed row): the same 5 steps, bit for bit
    def run():
        state, train_step = _port_state(flat), _port_step()
        b = loop_lib.to_device(_batch(), "cpu")
        out = []
        for _ in range(5):
            state, m = train_step(state, b)
            out.append((float(m["loss"]), float(m["grad_norm"])))
        return out

    base = run()
    row_sum = SM._xla_row_sum
    monkeypatch.setattr(SM, "_xla_row_sum", lambda x: row_sum(x.flip(-1)))
    assert run() == base


def test_jax_checkpoint_restores_into_port(jax_run, tmp_path):
    flat, jhist, _, _ = jax_run
    jckpt_dir = JAX_CKPT_DIR[0]
    state = _port_state(flat)                     # any weights: overwritten
    tree, extra = ckpt.restore(jckpt_dir, 2, step_lib.checkpoint_tree(state, like=True))
    assert extra == {"data_step": 2}
    assert sorted(ckpt.tree_paths(tree)) == sorted(jckpt.tree_paths(jax_run[3]))
    state = step_lib.load_checkpoint_tree(state, tree)
    assert int(state.opt.step) == 2
    _, m = _port_step()(state, loop_lib.to_device(_batch(), "cpu"))
    assert float(m["loss"]) == pytest.approx(jhist[2][0], rel=1e-5)


def test_port_checkpoint_restores_into_jax(jax_run, tmp_path):
    flat, jhist, jax_step, after2 = jax_run
    state, train_step = _port_state(flat), _port_step()
    batch = loop_lib.to_device(_batch(), "cpu")
    for _ in range(2):
        state, _ = train_step(state, batch)
    ckpt.save(str(tmp_path), 2, step_lib.checkpoint_tree(state), extra={"data_step": 2})
    restored, extra = jckpt.restore(str(tmp_path), 2, after2)
    assert extra == {"data_step": 2} and int(restored.opt.step) == 2
    _, m = jax_step(restored, {k: jnp.asarray(v) for k, v in _batch().items()})
    assert float(m["loss"]) == pytest.approx(jhist[2][0], rel=5e-4)


# ---------------------------------------------------------------------------
# loop, launcher, devices
# ---------------------------------------------------------------------------
def test_loop_restart_reproduces_clean_run(tmp_path):
    _, tcfg = _cfgs()
    runs = {}
    for name, inj in (("clean", None), ("faulty", FailureInjector([3, 6]))):
        lc = loop_lib.LoopConfig(total_steps=8, ckpt_every=2, log_every=100,
                                 ckpt_dir=str(tmp_path / name))
        runs[name] = loop_lib.run(tcfg, lc, injector=inj, log=lambda *_: None,
                                  device="cpu")
    assert runs["faulty"]["restarts"] == 2 and runs["clean"]["restarts"] == 0
    assert runs["faulty"]["final_loss"] == runs["clean"]["final_loss"]
    for a, b in zip(runs["clean"]["state"].params.parameters(),
                    runs["faulty"]["state"].params.parameters()):
        assert torch.equal(a, b)
    # a new run over the same directory resumes at the end and trains no more
    lc = loop_lib.LoopConfig(total_steps=8, ckpt_dir=str(tmp_path / "clean"))
    again = loop_lib.run(tcfg, lc, log=lambda *_: None, device="cpu")
    assert again["history"] == []


def test_accum_averages_microbatch_grads():
    _, tcfg = _cfgs()
    batch = loop_lib.to_device(_batch(1), "cpu")
    state1 = step_lib.init_state(tcfg, 0, adamw.AdamWConfig(), device="cpu")
    state2 = step_lib.init_state(tcfg, 0, adamw.AdamWConfig(), device="cpu")
    s1 = step_lib.make_train_step(tcfg, adamw.AdamWConfig(), accum=1)
    s2 = step_lib.make_train_step(tcfg, adamw.AdamWConfig(), accum=2)
    _, m1 = s1(state1, batch)
    _, m2 = s2(state2, batch)
    # equal-sized microbatches: the mean of the halves' losses is the loss
    assert float(m2["loss"]) == pytest.approx(float(m1["loss"]), rel=1e-5)
    assert float(m2["grad_norm"]) == pytest.approx(float(m1["grad_norm"]), rel=1e-3)


def test_eval_step_runs_without_grad():
    _, tcfg = _cfgs()
    params = tf.init(tcfg, 0, "cpu", dtype=torch.float32)
    m = step_lib.make_eval_step(tcfg)(params, loop_lib.to_device(_batch(), "cpu"))
    assert not m["loss"].requires_grad and np.isfinite(float(m["loss"]))


def test_unported_options_raise(monkeypatch, tmp_path):
    from repro_torch import configs as tconfigs
    from repro_torch.launch import mesh as mesh_lib

    _, tcfg = _cfgs()
    # compression, remat and pad_heads_to build now, and so does a rank's
    # cut of the recurrent blocks (ROADMAP A.12b closed); a value outside
    # the JAX options raises
    padded = tf.init(dataclasses.replace(tcfg, pad_heads_to=8), 0, "cpu",
                     dtype=torch.float32)
    assert padded.blocks[0].attn.wk.shape[1] % 8 == 0
    mesh = mesh_lib.Mesh(shape={"data": 1, "model": 2}, rank=0, group=None,
                         backend="none")
    xcfg = tconfigs.get_smoke("xlstm-1.3b")
    shard = tf.init(xcfg, 0, "cpu", mesh=mesh)
    d_inner = int(xcfg.d_model * xcfg.xlstm.proj_factor)
    assert shard.blocks[0].mixer.up_proj.shape == (xcfg.d_model, d_inner)
    assert shard.blocks[0].mixer.down_proj.shape == (d_inner // 2, xcfg.d_model)
    with pytest.raises(ValueError, match="remat"):
        tf.init(dataclasses.replace(tcfg, remat="everything"), 0, "cpu")
    # no card and no device: every entry point refuses rather than falling
    # back to the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_train.main(["--arch", "yi-9b", "--smoke", "--steps", "1",
                           "--ckpt-dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        loop_lib.run(tcfg, loop_lib.LoopConfig(total_steps=1, ckpt_dir=str(tmp_path)))


def test_launcher_trains_on_the_cpu(tmp_path, capsys):
    assert launch_train.main(["--arch", "yi-9b", "--smoke", "--steps", "3",
                              "--device", "cpu", "--ckpt-dir", str(tmp_path)]) == 0
    assert "final loss" in capsys.readouterr().out
    assert ckpt.latest_step(str(tmp_path)) == 3
