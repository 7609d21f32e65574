"""The train step on a ("data", "model") mesh (train/step.py with
``mesh=``, ``launch/train.rank_train``) against the port's one-rank step
and the JAX package's unsharded ``make_train_step``.

One group of spawned ranks per mesh, (1, 2), (2, 1) and (2, 2), started
once for the module; each runs every case while this process computes the
references. Smoke configs with every datapath exact (the mesh logic is the
datapath's business nowhere; the CORDIC datapaths on a mesh run on the
card, chip_smoke.py): yi-9b (one KV head: whole ``wk/wv`` at tp 2, their
gradients partial), deepseek-v2-lite-16b (MLA's whole ``wkv_a``/``kv_norm``,
the replicated router and the aux loss under dp), zamba2-1.2b (Mamba2's
whole ``dt_bias``/``A_log``/``D``/``norm`` and whole B / C columns, the
shared block), xlstm-1.3b under both ``slstm_state`` values, and yi-9b
with ``tie_embeddings`` (the vocabulary-cut table read by the lookup and
the head). One 8 x 16-token batch made with numpy, its mask different on
every row; a rank takes its data rank's share of each microbatch
(``step.rank_rows``); 2 AdamW steps (no warmup).

Bounds, measured on the CPU (the largest deviation seen in brackets):
* against the one-rank step (float32 reduction order alone): the step-0
  loss within rtol 1e-6 (2.1e-7); every gradient leaf, gathered whole,
  within ``||g_mesh - g_one|| <= 2e-5 ||g_one||`` (9.4e-6, Zamba2's
  ``A_log`` on (2, 2)); the parameters after 2 steps within 1e-2 of each
  leaf's norm (1.4e-3: the sLSTM's bias ``b``, zeros at init, whose
  gradient entries near zero AdamW's m / sqrt(v) turns into updates of
  +-lr, so a round-off there moves such an entry by up to 2 lr a step);
* against JAX on the same weights: the same loss bound (2.3e-7), the
  per-arch gradient bounds of tests/test_torch_train_archs.py
  (``LEAF_RTOL``; Yi's 5e-4, from the dense smoke model's 2.6e-4 noted
  there; 1.04e-5 seen, Zamba2's ``A_log``) and the parameter bound (3.0e-3,
  the sLSTM's ``b`` again);
* ``accum=2`` at dp 2: microbatch i is global rows [4i, 4i + 4), each data
  rank holding two of them, against the one-rank ``accum=2`` step and
  JAX's ``make_train_step(accum=2)`` on the batch as given; the same loss
  and parameter bounds;
* remat "full" and ZeRO-1: bit-equal to remat "none" and to no ZeRO-1 on
  the same mesh (gradients, parameters and moments);
* ``compress``: the codes (as dequantized gradients) and the residuals of
  the mesh's round trip, gathered, bit-equal to the jitted JAX
  ``compress_grads`` on the whole reduced gradients.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.distributed import compression as jcomp  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.train import step as jstep  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train import step as step_lib  # noqa: E402

EXACT = dict(softmax_impl="exact", loss_impl="exact")
#: case -> (arch, config overrides)
CASES = {
    "yi": ("yi-9b", {}),
    "deepseek": ("deepseek-v2-lite-16b", {}),
    "zamba2": ("zamba2-1.2b", {}),
    "xlstm-auto": ("xlstm-1.3b", {}),
    "xlstm-replicated": ("xlstm-1.3b", {"slstm_state": "replicated"}),
    "tied": ("yi-9b", {"tie_embeddings": True}),
}
MESHES = ((1, 2), (2, 1), (2, 2))
B, S, STEPS = 8, 16, 2
LOSS_RTOL, GRAD_RTOL, PARAM_RTOL = 1e-6, 2e-5, 1e-2
#: tests/test_torch_train_archs.py's LEAF_RTOL, and Yi's
JAX_RTOL = {"yi-9b": 5e-4, "deepseek-v2-lite-16b": 4e-4, "zamba2-1.2b": 3e-4,
            "xlstm-1.3b": 3e-4}
ACCUM = ("yi", "deepseek")
REMAT = ("yi", "deepseek", "zamba2", "xlstm-auto")
COMPRESS = ("yi", "zamba2")
TRAIN = "repro_torch.launch.train:rank_train"
#: the dry run's train cells held against the (2, 2) group's: smoke
#: configs, rows per data rank and positions (``dryrun.rank_train_steps``)
STEP_ARCHS = ("yi-9b", "deepseek-v2-lite-16b", "xlstm-1.3b", "zamba2-1.2b")
STEP_ROWS, STEP_SEQ = 2, 8


def _cfgs(case):
    arch, kw = CASES[case]
    j = dataclasses.replace(jconfigs.get_smoke(arch, act_impl="exact"), **EXACT, **kw)
    t = dataclasses.replace(configs.get_smoke(arch, act_impl="exact"), **EXACT, **kw)
    return j, t


def _batch(cfg):
    rng = np.random.default_rng(7)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1))
    return {"tokens": toks[:, :-1].astype(np.int64),
            "labels": toks[:, 1:].astype(np.int64),
            "mask": (rng.random((B, S)) < 0.7).astype(np.float32)}


def _job(case, tp, **kw):
    _, t = _cfgs(case)
    return (TRAIN, dict(cfg=t, tp=tp, batch=_batch(t), steps=STEPS, grads=True,
                        tree=True, **kw))


def _mesh_jobs(dp, tp):
    """(job names, jobs) one mesh's group runs, in order."""
    names, jobs = [], []

    def add(name, case, **kw):
        names.append(name)
        jobs.append(_job(case, tp, **kw))

    for case in CASES:
        add(case, case, zero1=dp > 1)
    if dp > 1:
        for case in CASES if (dp, tp) == (2, 1) else ("deepseek", "zamba2"):
            add(f"{case}/no-zero1", case)
        for case in ACCUM:
            add(f"{case}/accum", case, accum=2, zero1=True)
    if (dp, tp) == (2, 2):
        for case in REMAT:
            _, t = _cfgs(case)
            names.append(f"{case}/remat-full")
            jobs.append((TRAIN, dict(cfg=dataclasses.replace(t, remat="full"), tp=tp,
                                     batch=_batch(t), steps=STEPS, grads=True,
                                     tree=True, zero1=True)))
        for case in COMPRESS:
            add(f"{case}/compress", case, compress=True, zero1=True)
        names.append("dry-steps")
        jobs.append(("repro_torch.launch.dryrun:rank_train_steps",
                     dict(archs=STEP_ARCHS, rows=STEP_ROWS, seq=STEP_SEQ, tp=tp,
                          zero1=True)))
    return names, jobs


def _one_rank(case, accum=1):
    """The port's one-rank step: (step-0 loss, {name: gradient}, the JAX
    layout tree after STEPS steps)."""
    _, t = _cfgs(case)
    batch = {k: torch.as_tensor(v) for k, v in _batch(t).items()}
    st = step_lib.init_state(t, 0, adamw.AdamWConfig(), device="cpu")
    loss, _, g = step_lib.grads_of(st.params, batch, t)
    grads = {k: v.detach().numpy().copy() for k, v in g.items()}
    fn = step_lib.make_train_step(t, adamw.AdamWConfig(), accum=accum,
                                  warmup_steps=0, total_steps=100)
    losses = []
    for _ in range(STEPS):
        st, m = fn(st, batch)
        losses.append(float(m["loss"]))
    return float(loss), grads, losses, step_lib.checkpoint_tree(st)


def _jax(case, accum=1):
    """JAX's unsharded make_train_step on the port's seeded weights: (loss,
    flat gradients of the whole batch, losses, the state after STEPS
    steps), one jit."""
    j, t = _cfgs(case)
    named = step_lib.named_params(tf.init(t, 0, "cpu", dtype=torch.float32))
    params = jax.tree.map(jnp.asarray, tf.jax_tree(t, named))
    batch = {k: jnp.asarray(v, jnp.int32 if v.dtype == np.int64 else None)
             for k, v in _batch(t).items()}
    step = jstep.make_train_step(j, jadamw.AdamWConfig(), accum=accum, warmup_steps=0,
                                 total_steps=100)
    grad = jax.value_and_grad(lambda p, b: JT.loss_fn(p, b, j), has_aux=True)
    both = jax.jit(lambda st, b: (step(st, b), grad(st.params, b)))
    st = jstep.TrainState(params, jadamw.init(params), None)
    losses, first = [], None
    for _ in range(STEPS):
        (st, m), ((loss, _), g) = both(st, batch)
        first = first or (float(loss), tf.flatten_params(jax.tree.map(np.asarray, g)))
        losses.append(float(m["loss"]))
    return first[0], first[1], losses, jax.tree.map(np.asarray, st)


@pytest.fixture(scope="module")
def runs():
    """{"mesh": {(dp, tp): (names, [per-rank results])}, "one": {...},
    "jax": {...}}: the rank groups run while this process computes the
    one-rank and JAX references."""
    groups = {}
    for dp, tp in MESHES:
        names, jobs = _mesh_jobs(dp, tp)
        groups[dp, tp] = (names, M.RankGroup(M.rank_jobs, dp * tp, jobs, timeout=900))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = {"one": {c: _one_rank(c) for c in CASES}, "jax": {}, "mesh": {}}
        for c in ACCUM:
            out["one"][c, "accum"] = _one_rank(c, 2)
            out["jax"][c, "accum"] = _jax(c, 2)
        for c in CASES:
            if c != "xlstm-replicated":      # the same JAX program as auto
                out["jax"][c] = _jax(c)
        out["jax"]["xlstm-replicated"] = out["jax"]["xlstm-auto"]
    finally:
        torch.set_num_threads(n)
    for key, (names, g) in groups.items():
        out["mesh"][key] = (names, g.join())
    return out


def _res(runs, mesh, name, rank=0):
    names, res = runs["mesh"][mesh]
    return res[rank][names.index(name)]


def _rel(a, b):
    return float(np.linalg.norm(np.asarray(a, np.float64) - b)
                 / max(np.linalg.norm(np.asarray(b, np.float64)), 1e-30))


def _worst(got, want, keys=None):
    return max((_rel(got[k], want[k]), k) for k in (keys or want))


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_every_rank_reports_the_same_losses(runs, mesh):
    names, res = runs["mesh"][mesh]
    for i, name in enumerate(names):
        if name == "dry-steps":
            continue
        losses = [r[i]["losses"] for r in res]
        assert all(l == losses[0] for l in losses), (name, losses)
        assert losses[0][-1] < losses[0][0], name


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("case", list(CASES))
def test_mesh_step_matches_the_one_rank_step(runs, case, mesh):
    loss, grads, losses, tree = runs["one"][case]
    got = _res(runs, mesh, case)
    assert got["losses"][0] == pytest.approx(losses[0], rel=LOSS_RTOL)
    assert got["losses"][1] == pytest.approx(losses[1], rel=LOSS_RTOL)
    assert set(got["grads"]) == set(grads)
    worst = _worst(got["grads"], grads)
    assert worst[0] <= GRAD_RTOL, worst
    want = tf.flatten_params(tree.params)
    worst = _worst(tf.flatten_params(got["tree"].params), want)
    assert worst[0] <= PARAM_RTOL, worst
    assert int(got["tree"].opt.step) == STEPS


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("case", list(CASES))
def test_mesh_step_matches_jax_make_train_step(runs, case, mesh):
    jloss, jgrads, jlosses, jstate = runs["jax"][case]
    _, t = _cfgs(case)
    got = _res(runs, mesh, case)
    assert got["losses"][0] == pytest.approx(jloss, rel=LOSS_RTOL)
    assert got["losses"][0] == pytest.approx(jlosses[0], rel=LOSS_RTOL)
    flat = tf.from_jax_flat(t, jgrads)
    worst = _worst(got["grads"], flat)
    assert worst[0] <= JAX_RTOL[CASES[case][0]], worst
    want = tf.flatten_params(jstate.params)
    worst = _worst(tf.flatten_params(got["tree"].params), want)
    assert worst[0] <= PARAM_RTOL, worst


@pytest.mark.parametrize("mesh", [(2, 1), (2, 2)], ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("case", ACCUM)
def test_accum_over_the_ranks_rows(runs, case, mesh):
    """accum=2 at dp 2 against the one-rank accum=2 step and JAX's
    make_train_step(accum=2) on the same global batch: microbatch i is the
    global rows [4i, 4i + 4) on the mesh too, each data rank holding its
    share, and the masks differ between the rows, so each microbatch's
    masked mean over its global rows is what is held."""
    got = _res(runs, mesh, f"{case}/accum")
    for ref in (runs["one"][case, "accum"], runs["jax"][case, "accum"]):
        _, _, losses, tree = ref
        np.testing.assert_allclose(got["losses"], losses, rtol=LOSS_RTOL)
        worst = _worst(tf.flatten_params(got["tree"].params),
                       tf.flatten_params(tree.params))
        assert worst[0] <= PARAM_RTOL, worst


def _bit_equal_trees(a, b):
    for part in ("params", "opt", "err"):
        fa = jax.tree_util.tree_leaves(getattr(a, part))
        fb = jax.tree_util.tree_leaves(getattr(b, part))
        assert len(fa) == len(fb)
        for x, y in zip(fa, fb):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("case", REMAT)
def test_remat_full_is_bit_equal_on_the_mesh(runs, case):
    base, full = (_res(runs, (2, 2), n) for n in (case, f"{case}/remat-full"))
    assert base["losses"] == full["losses"]
    for k in base["grads"]:
        np.testing.assert_array_equal(full["grads"][k], base["grads"][k])
    _bit_equal_trees(full["tree"], base["tree"])


@pytest.mark.parametrize("mesh,case", [((2, 1), c) for c in CASES]
                         + [((2, 2), c) for c in ("deepseek", "zamba2")],
                         ids=lambda v: f"{v[0]}x{v[1]}" if isinstance(v, tuple) else v)
def test_zero1_is_bit_equal_to_whole_moments(runs, mesh, case):
    z, whole = (_res(runs, mesh, n) for n in (case, f"{case}/no-zero1"))
    assert z["losses"] == whole["losses"]
    _bit_equal_trees(z["tree"], whole["tree"])


@pytest.mark.parametrize("case", COMPRESS)
def test_compressed_codes_and_residuals_equal_jax_on_the_whole_leaf(runs, case):
    got = _res(runs, (2, 2), f"{case}/compress")
    g = {k: jnp.asarray(v) for k, v in got["grads"].items()}
    deq, err = jax.jit(jcomp.compress_grads)(g, jax.tree.map(jnp.zeros_like, g))
    for k in g:
        np.testing.assert_array_equal(got["compressed"][k], np.asarray(deq[k]), err_msg=k)
        np.testing.assert_array_equal(got["residual"][k], np.asarray(err[k]), err_msg=k)
    # the step itself ran the round trip: the buffers it carried are set
    assert any(np.abs(v).max() > 0 for v in
               jax.tree_util.tree_leaves(got["tree"].err))


@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_dry_train_step_books_the_collectives_a_rank_group_runs(runs, arch):
    """The dry run's train cell (meta tensors, a dry (2, 2) mesh) books the
    collectives, of each kind and with their bytes, that the (2, 2) group
    of ranks runs in the same step (ZeRO-1, remat "full", backward
    included)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun

    mesh = M.dry_mesh(2, data=2)
    rec = dryrun.lower_cell(arch, "train", smoke=True, act_impl="exact", mesh=mesh,
                            shape=ShapeConfig("t", STEP_SEQ, 2 * STEP_ROWS, "train"),
                            zero1=True)
    assert rec["status"] == "ok"
    want = {k: v for k, v in _res(runs, (2, 2), "dry-steps")[arch].items() if v}
    assert {k: v for k, v in mesh.stats.items() if v} == want
    assert want["all_gather"] > 0 and want["all_reduce"] > 0


@functools.lru_cache(maxsize=None)
def _dry_model(case, tp):
    _, t = _cfgs(case)
    return tf.init(t, 0, "cpu", dtype=torch.float32, mesh=M.dry_mesh(tp, 0, 2),
                   train=True)


@pytest.mark.parametrize("case,want", [
    ("yi", {"attn.wk", "attn.wv"}),
    ("deepseek", {"attn.wkv_a", "attn.kv_norm"}),
    ("zamba2", {"mixer.dt_bias", "mixer.A_log", "mixer.D", "mixer.norm",
                "mixer.in_proj", "mixer.conv_w", "mixer.conv_b"}),
    ("xlstm-auto", {"mixer.b_if", "mixer.norm", "mixer.r"}),
    ("xlstm-replicated", {"mixer.b_if", "mixer.norm"}),
])
def test_partial_leaves_are_the_whole_leaves_read_in_part(case, want):
    """The leaves whose gradients a rank sums over the model axis: every
    whole leaf a cut module reads in part, nothing else (the norms of the
    blocks, the sLSTM's post-norm, the router and b_out are alike on every
    rank)."""
    model = _dry_model(case, 2)
    got = {k.split(".", 2)[2] for k in shd.partial_leaves(model)}
    assert got == want
    if case == "zamba2":
        # Mamba2's one group: the B / C columns whole, the rest cut
        # (z | x: 64 columns each of d_inner 128 | B, C: 16 each | dt: 4 of 8)
        ranges = shd.partial_leaves(model)["blocks.0.mixer.in_proj"]
        assert ranges == [(1, 128, 144), (1, 144, 160)]


def test_training_cut_cuts_the_embedding_and_the_tied_head():
    """The training cut follows the JAX params_shardings: the embedding is
    vocabulary-cut (the serving cut keeps it whole); the router stays
    whole in both."""
    mesh = M.dry_mesh(2)
    _, t = _cfgs("tied")
    train = tf.init(t, 0, "cpu", dtype=torch.float32, mesh=mesh, train=True)
    serve = tf.init(t, 0, "cpu", mesh=mesh)
    assert train.embed.shape == (t.vocab_size // 2, t.d_model)
    assert serve.embed.shape == (t.vocab_size, t.d_model)
    _, d = _cfgs("deepseek")
    moe = tf.init(d, 0, "cpu", dtype=torch.float32, mesh=mesh, train=True)
    assert moe.blocks[1].ffn.router.shape == (d.d_model, d.moe.num_experts)


@pytest.mark.parametrize("dp,accum", [(1, 1), (2, 1), (2, 2), (4, 2)])
def test_rank_rows_are_each_ranks_share_of_each_microbatch(dp, accum):
    """The data ranks' rows, microbatch by microbatch, put together in
    data-rank order, are the global microbatches in order: microbatch i
    of every rank is its share of global rows [i * B / accum, (i + 1) *
    B / accum), as the JAX step splits the batch."""
    rows = [step_lib.rank_rows(B, M.dry_mesh(1, r, dp), accum) for r in range(dp)]
    share = B // accum // dp
    got = [j for i in range(accum) for r in rows for j in r[i * share:(i + 1) * share]]
    assert got == list(range(B))
    with pytest.raises(ValueError, match="microbatches"):
        step_lib.rank_rows(B + 2, M.dry_mesh(1, 0, dp), 4)
