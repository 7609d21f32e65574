"""Tensor-parallel serving of the port (``ServeEngine(..., tp=N)``, one
process per rank under gloo) against its own tp = 1 engine and the JAX
engine's tp = 1, then ``pad_heads_to`` and ``score_dtype="bf16_mxu"``
against the JAX functions.

The recurrent archs (xLSTM and Zamba2 smoke configs, the xLSTM one with 4
heads so that tp 4 cuts it, under both ``slstm_state`` values) serve the
same way on the dense plane, and the 2-head xLSTM at tp 4 falls back to
whole mixers. The same rank groups also run the dry run's prefill and
decode steps (launch/dryrun.py ``rank_steps``), whose collective counts
and bytes the dry mesh must book identically.

At tp 2 the same group serves ``kv_shard="seq_model"`` (the dense caches'
positions cut over the ranks, models/attention.py): Yi's smoke config, the
DeepSeek-V2-Lite smoke config and Zamba2's on the dense plane against tp 1
and the JAX engine (which serves the knob with the heads cut, so its
tokens are the reference), Yi on the CORDIC kernels' plain versions (the
split softmax) against tp 1 and on the paged plane, where the knob changes
nothing, and each attention sublayer's output (``launch/serve.rank_attend``)
against tp 1's within ``SEQ_ATOL``.

The traces are the JAX suite's (``tests/test_sharded_serving.py``): six
requests, greedy and seeded sampling mixed, slots 3, max_len 64, block_len
8, on the GQA test config (KH 4) and the DeepSeek-V2-Lite smoke config
(MLA + GShard MoE), with the JAX engine's weights carried over. Each group
of ranks (tp 2, tp 4) is spawned once for the module and serves every case
in one go; the JAX engine runs once per arch (its planes emit the same
tokens, which its own suite holds).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.configs.base import ModelConfig as JModelConfig  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import common as jcm  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serve.engine import Request as JRequest  # noqa: E402
from repro.serve.engine import ServeEngine as JEngine  # noqa: E402
from repro.serve.sampling import SamplingParams as JSP  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402
from repro_torch.launch import serve as launcher  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from repro_torch.serve.sampling import SamplingParams  # noqa: E402

GQA_KW = dict(name="tp-gqa", family="dense", num_layers=2, d_model=64,
              num_heads=8, num_kv_heads=4, d_ff=192, vocab_size=512,
              rope_theta=1e4, dtype="float32", act_impl="exact",
              softmax_impl="exact")
ENGINE = dict(slots=3, max_len=64, seed=0, block_len=8)
PLANES = [("dense", "gather"), ("paged", "gather"), ("paged", "pallas")]
CHUNKS = [None, 16]
VARIANTS = [(kv, pai, c) for kv, pai in PLANES for c in CHUNKS]
SCORE_PROMPT = np.arange(1, 9, dtype=np.int32)


def _cfgs(arch):
    if arch == "gqa":
        return JModelConfig(**GQA_KW), ModelConfig(**GQA_KW)
    jcfg = jconfigs.get_smoke("deepseek-v2-lite-16b", act_impl="exact")
    cfg = configs.get_smoke("deepseek-v2-lite-16b", act_impl="exact")
    return (dataclasses.replace(jcfg, input_mode="tokens", softmax_impl="exact"),
            dataclasses.replace(cfg, input_mode="tokens", softmax_impl="exact"))


def _trace(vocab, sp):
    """The JAX suite's ``_serve`` trace: (rid, prompt, max_new, sampling)."""
    rng = np.random.default_rng(0)
    out = []
    for i in range(6):
        plen = int(rng.integers(4, 40))
        samp = (sp(greedy=True) if i % 2 == 0 else sp(temperature=0.7, top_k=6))
        out.append((i, rng.integers(0, vocab, plen).astype(np.int32), 8, samp))
    return out


def _prefix_trace(vocab):
    """The JAX suite's ``_serve_shared_prefix`` trace."""
    rng = np.random.default_rng(3)
    sys_prompt = rng.integers(0, vocab, 24).astype(np.int32)
    out = []
    for i in range(6):
        tail = rng.integers(0, vocab, int(rng.integers(4, 13))).astype(np.int32)
        samp = (SamplingParams(greedy=True) if i % 2 == 0
                else SamplingParams(temperature=0.7, top_k=6))
        out.append((i, np.concatenate([sys_prompt, tail]), 8, samp))
    return out


def _variant(kv, pai, chunk):
    return dict(ENGINE, kv_impl=kv, paged_attend_impl=pai, prefill_chunk=chunk)


def _jobs(flats, tp):
    """Every case, for one group of ranks: per arch the six plane/chunk
    variants (the GQA paged-kernel one with observability and a score),
    then, at tp 1 and 2, GQA's prefix-cache trace off and on and Yi's smoke
    config (KH 1: the whole-KV-heads cut) on the CORDIC kernels' plain
    versions, dense and paged."""
    jobs = []
    for arch in ("gqa", "mla"):
        _, cfg = _cfgs(arch)
        cases = [dict(engine=_variant(*v), requests=_trace(cfg.vocab_size, SamplingParams),
                      obs=(arch == "gqa" and v == ("paged", "pallas", None)),
                      scores=[SCORE_PROMPT] if v == VARIANTS[0] else [])
                 for v in VARIANTS]
        if arch == "gqa" and tp < 4:
            cases += [dict(engine=dict(ENGINE, kv_impl="paged", paged_attend_impl="pallas",
                                       prefix_cache=pc),
                           requests=_prefix_trace(cfg.vocab_size)) for pc in (False, True)]
        jobs.append(dict(cfg=cfg, flat=flats[arch], tp=tp, cases=cases))
    yi = configs.get_smoke("yi-9b", act_impl="cordic_pallas")
    yi = dataclasses.replace(yi, softmax_impl="cordic_pallas")
    if tp < 4:
        jobs.append(dict(cfg=yi, seed=4, tp=tp, cases=[
            dict(engine=_variant(kv, "gather", None),
                 requests=_trace(yi.vocab_size, SamplingParams))
            for kv in ("dense", "paged")]))
    if tp < 4:
        jobs += _seq_jobs(flats, tp)
    for name in RECURRENT:
        cfg = _rec_cfgs(name)[1]
        job = dict(cfg=cfg, tp=tp, cases=[dict(engine=ENGINE,
                                               requests=_rec_trace(cfg.vocab_size))])
        jobs.append(dict(job, flat=flats[name]) if name in flats
                    else dict(job, seed=6))
    return jobs


#: the kv_shard="seq_model" jobs at tp 1 and 2, after Yi's (``SEQ_JOB``):
#: the exact-softmax smoke configs against the JAX engine, then Yi on the
#: CORDIC softmax's plain versions, dense and paged
SEQ_ARCHS = ("yi", "mla", "zamba2")
SEQ_JOB = {name: 3 + i for i, name in enumerate(SEQ_ARCHS + ("yi-cordic",))}
#: the rank_attend probe: each attention sublayer's prefill and decode
#: output at tp 2 against tp 1's, over max |tp 1| (CPU float32, the P.V
#: partials and the row-parallel sums reordered: ~3e-7 measured)
SEQ_ATOL = 2e-6


def _seq_cfg(name):
    """(JAX config, port config) of a seq job: exact softmax, float32."""
    if name == "mla":
        return _cfgs("mla")
    arch = "zamba2-1.2b" if name == "zamba2" else "yi-9b"
    jcfg = dataclasses.replace(jconfigs.get_smoke(arch, act_impl="exact"),
                               softmax_impl="exact")
    cfg = dataclasses.replace(configs.get_smoke(arch, act_impl="exact"),
                              softmax_impl="exact")
    return jcfg, cfg


def _seq_trace(name, vocab):
    return _rec_trace(vocab) if name == "zamba2" else _trace(vocab, SamplingParams)


def _seq_jobs(flats, tp):
    """The seq jobs: every case on the dense plane (max_len 64: a span of
    32 positions at tp 2) with the knob on."""
    jobs = []
    for name in SEQ_ARCHS:
        cfg = dataclasses.replace(_seq_cfg(name)[1], kv_shard="seq_model")
        jobs.append(dict(cfg=cfg, flat=flats[name], tp=tp, cases=[dict(
            engine=dict(ENGINE, kv_impl="dense"),
            requests=_seq_trace(name, cfg.vocab_size))]))
    yi = dataclasses.replace(configs.get_smoke("yi-9b", act_impl="cordic_pallas"),
                             softmax_impl="cordic_pallas", kv_shard="seq_model")
    jobs.append(dict(cfg=yi, seed=4, tp=tp, cases=[
        dict(engine=_variant(kv, "gather", None),
             requests=_trace(yi.vocab_size, SamplingParams))
        for kv in ("dense", "paged")]))
    return jobs


def _attend_jobs(tp):
    """``rank_attend`` on each seq arch: Yi on the CORDIC softmax, DeepSeek
    on cordic_fixed, Zamba2's shared block exact; 12 positions of prefill
    and one decode position into a 64-position cache."""
    rng = np.random.default_rng(9)
    jobs = []
    for arch, impl in (("yi-9b", "cordic_pallas"), ("deepseek-v2-lite-16b", "cordic_fixed"),
                       ("zamba2-1.2b", "exact")):
        cfg = dataclasses.replace(configs.get_smoke(arch, act_impl="exact"),
                                  softmax_impl=impl, kv_shard="seq_model")
        jobs.append(dict(cfg=cfg, seed=0, tp=tp, max_len=64,
                         x=rng.standard_normal((2, 12, cfg.d_model)).astype(np.float32),
                         x1=rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)))
    return jobs


#: the recurrent jobs, after the attention archs' (``_rec_job``): xLSTM
#: with 4 heads under slstm_state "auto" and "replicated", Zamba2, the
#: 2-head xLSTM smoke config (cut at tp 2, whole mixers at tp 4), and
#: Zamba2 with two Mamba2 groups (B / C cut by group at tp 2, whole at tp
#: 4 with each head reading its group's row)
RECURRENT = ("xlstm4-auto", "xlstm4-replicated", "zamba2", "xlstm2", "zamba2-g2")
#: the recurrent prompts: one length (the JAX engine compiles a prefill
#: per length), greedy
REC_PLENS = (7, 7, 7, 7)


def _rec_cfgs(name):
    """(JAX config, port config) of a recurrent job (float32, exact)."""
    arch = "zamba2-1.2b" if name.startswith("zamba2") else "xlstm-1.3b"
    jcfg = jconfigs.get_smoke(arch, act_impl="exact")
    cfg = configs.get_smoke(arch, act_impl="exact")
    if name.startswith("xlstm4"):
        kw = dict(num_heads=4, num_kv_heads=4, slstm_state=name.split("-")[1])
        jcfg, cfg = dataclasses.replace(jcfg, **kw), dataclasses.replace(cfg, **kw)
    if name == "zamba2-g2":
        cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm, n_groups=2))
    return jcfg, cfg


def _rec_trace(vocab):
    rng = np.random.default_rng(5)
    return [(i, rng.integers(0, vocab, n).astype(np.int32), 6, SamplingParams(greedy=True))
            for i, n in enumerate(REC_PLENS)]


def _rec_job(served, tp, name):
    """The index of a recurrent job in a rank's results."""
    return len(served[tp][0]) - len(RECURRENT) + RECURRENT.index(name)


#: the dry run's steps held against the rank groups': smoke configs, rows
#: and positions (``rank_steps``)
STEP_ARCHS = ("yi-9b", "deepseek-v2-lite-16b", "xlstm-1.3b", "zamba2-1.2b")
STEP_ROWS, STEP_SEQ = 2, 12


@pytest.fixture(scope="module")
def served():
    """{"jax": {arch: (tokens, score)}, tp: [per-rank job results]} with tp
    1 run in this process and tp 2 and 4 on spawned ranks."""
    flats, jparams, out = {}, {}, {"jax": {}}
    for arch in ("gqa", "mla"):
        jcfg, _ = _cfgs(arch)
        jparams[arch] = JT.init(jcfg, jax.random.PRNGKey(0))
        flats[arch] = T.flatten_params(jparams[arch])
    for name in ("xlstm4-auto", "zamba2", "yi"):
        # the port's seeded weights bridged to the JAX tree (skips JAX's
        # init, seconds an arch)
        cfg = _seq_cfg(name)[1] if name == "yi" else _rec_cfgs(name)[1]
        model = T.init(cfg, seed=1, device="cpu")
        flats[name] = T.flatten_params(T.jax_tree(cfg, dict(model.named_parameters())))
        jparams[name] = jax.tree.map(jnp.asarray, T._nest(flats[name]))
    flats["xlstm4-replicated"] = flats["xlstm4-auto"]
    # the rank groups run while this process serves the references
    steps = dict(archs=STEP_ARCHS, rows=STEP_ROWS, seq=STEP_SEQ, tp=2)
    groups = {tp: M.RankGroup(M.rank_jobs, tp, [
        ("repro_torch.launch.serve:rank_serve", _jobs(flats, tp))]
        + ([("repro_torch.launch.dryrun:rank_steps", steps),
            ("repro_torch.launch.serve:rank_attend", _attend_jobs(tp))]
           if tp == 2 else []),
        timeout=600) for tp in (2, 4)}
    for arch in ("gqa", "mla"):
        jcfg, _ = _cfgs(arch)
        # a MoE routes by the dispatch width: chunking changes its tokens
        for chunk in CHUNKS if arch == "mla" else CHUNKS[:1]:
            eng = JEngine(jcfg, jparams[arch], kv_impl="paged",
                          paged_attend_impl="gather", prefill_chunk=chunk, **ENGINE)
            reqs = [JRequest(rid=r, prompt=p, max_new_tokens=n, sampling=s)
                    for r, p, n, s in _trace(jcfg.vocab_size, JSP)]
            for r in reqs:
                eng.submit(r)
            eng.run()
            out["jax"][arch, chunk] = ({r.rid: list(r.out) for r in reqs},
                                       np.asarray(eng.score(SCORE_PROMPT)))
    for name in ("xlstm4-auto", "zamba2"):
        jcfg = _rec_cfgs(name)[0]
        eng = JEngine(jcfg, jparams[name], **ENGINE)
        reqs = [JRequest(rid=r, prompt=p, max_new_tokens=n)
                for r, p, n, _ in _rec_trace(jcfg.vocab_size)]
        for r in reqs:
            eng.submit(r)
        eng.run()
        out["jax"][name] = {r.rid: list(r.out) for r in reqs}
    # Yi's smoke config on the dense plane: the seq jobs' reference
    jcfg = _seq_cfg("yi")[0]
    eng = JEngine(jcfg, jparams["yi"], kv_impl="dense", **ENGINE)
    reqs = [JRequest(rid=r, prompt=p, max_new_tokens=n, sampling=s)
            for r, p, n, s in _trace(jcfg.vocab_size, JSP)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    out["jax"]["yi"] = {r.rid: list(r.out) for r in reqs}
    out[1] = [launcher.rank_serve(_jobs(flats, 1))]
    out["attend", 1] = launcher.rank_attend(_attend_jobs(1))
    for tp, g in groups.items():
        res = g.join()
        out[tp] = [r[0] for r in res]
        if tp == 2:
            out["steps"] = [r[1] for r in res]
            out["attend", 2] = [r[2] for r in res]
    return out


def _jax(served, arch, chunk):
    return served["jax"][arch, chunk if arch == "mla" else None]


def _case(served, tp, job, case, rank=0):
    return served[tp][rank][job]["cases"][case]


@pytest.mark.parametrize("variant", VARIANTS, ids=lambda v: f"{v[0]}-{v[1]}-{v[2]}")
@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("arch", ["gqa", "mla"])
def test_tokens_equal_tp1_and_the_jax_engine(served, arch, tp, variant):
    job, case = ("gqa", "mla").index(arch), VARIANTS.index(variant)
    want = _jax(served, arch, variant[2])[0]
    assert any(len(o) > 1 for o in want.values())
    assert _case(served, 1, job, case)["tokens"] == want
    got = _case(served, tp, job, case)
    assert got["tp"] == tp
    assert got["tokens"] == want, f"tp={tp} tokens diverged"


def test_every_rank_emits_the_same_tokens(served):
    for tp in (2, 4):
        for job in range(len(served[tp][0])):
            for case in range(len(served[tp][0][job]["cases"])):
                toks = [_case(served, tp, job, case, r)["tokens"] for r in range(tp)]
                assert all(t == toks[0] for t in toks), (tp, job, case)


def test_whole_kv_heads_when_they_do_not_divide(served):
    """Yi's smoke config has one KV head: at tp 2 every rank computes it
    whole (whole pools) and attends with its two query heads."""
    for case in range(2):
        want = _case(served, 1, 2, case)
        assert _case(served, 2, 2, case)["tokens"] == want["tokens"], case
    # the paged pool stays whole: the same bytes on every rank
    assert _case(served, 2, 2, 1)["kv_pool_bytes"] == _case(served, 1, 2, 1)["kv_pool_bytes"]


def test_prefix_cache_on_equals_off_at_tp2(served):
    n = len(VARIANTS)
    off1, off2, on2 = (_case(served, 1, 0, n), _case(served, 2, 0, n),
                       _case(served, 2, 0, n + 1))
    assert any(len(o) > 1 for o in off1["tokens"].values())
    assert off2["tokens"] == off1["tokens"]
    assert on2["tokens"] == off1["tokens"]
    hits, hit_blocks = on2["prefix_hits"]
    assert hits >= 1 and hit_blocks >= 1


def test_score_at_tp2(served):
    want = _jax(served, "gqa", None)[1]
    for tp in (1, 2, 4):
        got = _case(served, tp, 0, 0)["scores"][0]
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_rank_pools_and_gauges(served):
    """GQA KV pools hold KH / tp heads per rank (1/tp of the bytes), MLA's
    latent pools are whole; the mesh gauges read the mesh and every decode
    step has a collective span."""
    pk = VARIANTS.index(("paged", "pallas", None))
    base = _case(served, 1, 0, pk)
    for tp in (2, 4):
        got = _case(served, tp, 0, pk)
        n, L, kh, hd = base["pool_shapes"]["k_pool"]
        assert got["pool_shapes"]["k_pool"] == (n, L, kh // tp, hd)
        assert got["kv_pool_bytes"] * tp == base["kv_pool_bytes"]
        g = got["gauges"]
        assert g["tp"] == tp and g["devices"] == tp and g["collective_count"] > 0
        # two row-parallel sums a layer per apply, one logits gather a decode
        assert got["collectives"]["all_reduce"] > 0
        mla = _case(served, tp, 1, pk)
        assert mla["pool_shapes"] == _case(served, 1, 1, pk)["pool_shapes"]
    assert base["gauges"] == {"tp": 1, "devices": 1, "collective_count": 0}


def _fake_mesh(tp):
    return M.Mesh(shape={"data": 1, "model": tp}, rank=0, group=None,
                  backend="none")


def test_kernel_path_needs_heads_divisible_by_tp():
    yi = configs.get_smoke("yi-9b")                 # KH 1
    model = T.init(yi, device="cpu")
    with pytest.raises(ValueError, match="kv heads \\(padded\\)=1 is not divisible by tp=2"):
        ServeEngine(yi, model, kv_impl="paged", paged_attend_impl="pallas",
                    mesh=_fake_mesh(2), device="cpu")
    ds = configs.get_smoke("deepseek-v2-lite-16b")  # H 4
    with pytest.raises(ValueError, match="num_heads=4 is not divisible by tp=8"):
        ServeEngine(ds, T.init(ds, device="cpu"), kv_impl="paged",
                    paged_attend_impl="pallas", mesh=_fake_mesh(8), device="cpu")
    # padding the KV heads to 2 makes them divide
    padded = dataclasses.replace(yi, pad_heads_to=2)
    eng = ServeEngine(padded, T.init(padded, device="cpu"), kv_impl="paged",
                      paged_attend_impl="pallas", mesh=_fake_mesh(2), device="cpu")
    assert eng._caches.layers[0]["k_pool"].shape[2] == 1


def test_recurrent_archs_raise_naming_a12b():
    """The recurrent archs no longer refuse a mesh (ROADMAP A.12b closed):
    on a rank's view of a tp 2 mesh the engine builds with each mixer cut
    by head and its state at the rank's width, and serves; at tp 8 the
    xLSTM's 2 heads do not divide, so its mixers stay whole."""
    for arch in ("xlstm-1.3b", "zamba2-1.2b"):
        cfg = configs.get_smoke(arch)
        model = T.init(cfg, device="cpu")
        eng = ServeEngine(cfg, model, mesh=_fake_mesh(2), device="cpu")
        whole = ServeEngine(cfg, model, device="cpu")
        assert 0 < eng.state_bytes() < whole.state_bytes()
        eng.submit(launcher.Request(rid=0, prompt=np.arange(1, 6, dtype=np.int32),
                                    max_new_tokens=2))
        assert len(eng.run()[0].out) == 2
    cfg = configs.get_smoke("xlstm-1.3b")
    shard = T.init(cfg, device="cpu", mesh=_fake_mesh(8))
    cut = {n for n in shd.leaf_cuts(shard) if ".mixer." in n and ".ffn." not in n}
    assert not cut
    assert ServeEngine(cfg, shard, mesh=shard.mesh, device="cpu").state_bytes() == \
        ServeEngine(cfg, T.init(cfg, device="cpu"), device="cpu").state_bytes()


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("name", RECURRENT[:3])
def test_recurrent_tokens_equal_tp1_and_the_jax_engine(served, name, tp):
    want = served["jax"]["zamba2" if name == "zamba2" else "xlstm4-auto"]
    assert all(len(o) == 6 for o in want.values())
    assert _case(served, 1, _rec_job(served, 1, name), 0)["tokens"] == want
    for r in range(tp):
        got = _case(served, tp, _rec_job(served, tp, name), 0, r)
        assert got["tp"] == tp
        assert got["tokens"] == want, f"{name} tp={tp} rank {r} tokens diverged"
        assert got["collectives"]["all_reduce"] > 0


def _state_bytes_want(name, cfg, tp, base):
    """tp 1's state bytes over tp, but for Mamba2's whole B / C conv
    columns and a replicated sLSTM state."""
    rows = ENGINE["slots"]
    if name == "zamba2":
        s = cfg.ssm
        extra = 2 * s.n_groups * s.d_state * (s.d_conv - 1) * rows * 4
        n = cfg.block_pattern.count("mamba2")
        return (base - n * extra) // tp + n * extra
    if name == "xlstm4-replicated":
        sl = 4 * rows * cfg.d_model * 4 * cfg.block_pattern.count("slstm")
        return (base - sl) // tp + sl
    return base // tp


@pytest.mark.parametrize("tp", [2, 4])
def test_recurrent_rank_state_and_whole_mixer_fallback(served, tp):
    """Each rank's state is 1/tp of tp 1's (but the stated exceptions),
    with the rank's shapes; the 2-head xLSTM is cut at tp 2 and whole at
    tp 4, and serves tp 1's tokens either way, as Zamba2 with two groups
    does with its B / C cut by group (tp 2) or whole (tp 4)."""
    for name in RECURRENT[:3]:
        cfg = _rec_cfgs(name)[1]
        base = _case(served, 1, _rec_job(served, 1, name), 0)
        for r in range(tp):
            got = _case(served, tp, _rec_job(served, tp, name), 0, r)
            assert got["state_bytes"] == _state_bytes_want(name, cfg, tp, base["state_bytes"])
    groups = _case(served, tp, _rec_job(served, tp, "zamba2-g2"), 0)
    assert groups["tokens"] == _case(served, 1, _rec_job(served, 1, "zamba2-g2"), 0)["tokens"]
    fall = _rec_job(served, tp, "xlstm2")
    want = _case(served, 1, _rec_job(served, 1, "xlstm2"), 0)
    got = _case(served, tp, fall, 0)
    assert got["tokens"] == want["tokens"]
    if tp == 4:
        assert got["state_bytes"] == want["state_bytes"]
        assert got["state_shapes"] == want["state_shapes"]
    else:
        assert got["state_bytes"] * 2 == want["state_bytes"]


@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_dry_mesh_books_the_gloo_collectives(served, arch):
    """The dry run's prefill and decode steps on a dry tp 2 mesh (meta
    tensors, no process group) book the collective counts and bytes that
    the same steps record on two gloo ranks."""
    for kind in ("prefill", "decode"):
        rec = dryrun.lower_cell(arch, kind, smoke=True, act_impl="exact",
                                mesh=M.dry_mesh(2),
                                shape=ShapeConfig(kind, STEP_SEQ, STEP_ROWS, kind))
        assert rec["status"] == "ok"
        coll = rec["collective"]
        for rank in range(2):
            want = served["steps"][rank][arch][kind]
            assert want["all_reduce"] > 0
            assert coll["op_counts"]["all-reduce"] == want["all_reduce"], (kind, rank)
            assert coll["per_kind_bytes"]["all-reduce"] == want["bytes"], (kind, rank)
        assert coll["weighted_bytes"] == 2 * want["bytes"]


# ---------------------------------------------------------------------------
# kv_shard="seq_model" at tp 2
# ---------------------------------------------------------------------------
def _seq_want(served, name):
    if name == "mla":
        return _jax(served, "mla", None)[0]
    return served["jax"][name]


@pytest.mark.parametrize("name", SEQ_ARCHS)
def test_seq_model_tokens_equal_tp1_and_the_jax_engine(served, name):
    """Yi's, DeepSeek-V2-Lite's and Zamba2's smoke configs with their dense
    caches' positions cut over two ranks serve tp 1's tokens and the JAX
    engine's, on every rank, each rank holding 32 of the 64 positions of
    every KV head (of MLA's latent and rope key)."""
    want = _seq_want(served, name)
    assert any(len(o) > 1 for o in want.values())
    base = _case(served, 1, SEQ_JOB[name], 0)
    assert base["tokens"] == want
    for r in range(2):
        got = _case(served, 2, SEQ_JOB[name], 0, r)
        assert got["tp"] == 2 and got["kv_shard"] == "seq_model"
        assert got["tokens"] == want, f"{name} rank {r} tokens diverged"
        for k, shape in base["pool_shapes"].items():
            assert got["pool_shapes"][k] == (shape[0], shape[1] // 2) + shape[2:], k
    if name == "zamba2":
        return
    assert set(base["pool_shapes"]) == ({"c_kv", "k_rope"} if name == "mla" else {"k", "v"})


def test_seq_model_cordic_split_serves_tp1_tokens(served):
    """Yi on the CORDIC softmax's plain versions: the split softmax (the
    spans' window sums gathered) serves tp 1's tokens, those of the heads
    cut; the paged plane never reads the knob: its tokens and pools are the
    heads cut's and the engine's knob reads "auto"."""
    job = SEQ_JOB["yi-cordic"]
    dense1, paged1 = (_case(served, 1, 2, c) for c in range(2))
    assert _case(served, 1, job, 0)["tokens"] == dense1["tokens"]
    for r in range(2):
        dense, paged = (_case(served, 2, job, c, r) for c in range(2))
        assert dense["tokens"] == dense1["tokens"], r
        assert dense["pool_shapes"]["k"][1] * 2 == dense1["pool_shapes"]["k"][1]
        assert dense["collectives"]["all_gather"] > 0
        assert paged["kv_shard"] == "auto" and dense["kv_shard"] == "seq_model"
        assert paged["tokens"] == paged1["tokens"] == _case(served, 2, 2, 1, r)["tokens"]
        assert paged["pool_shapes"] == _case(served, 2, 2, 1, r)["pool_shapes"]


def test_seq_model_attention_sublayers_within_bound(served):
    """Each attention sublayer (Yi cordic_pallas, DeepSeek cordic_fixed,
    Zamba2's shared block exact) on each rank of the position cut: its
    prefill and decode outputs against tp 1's within SEQ_ATOL of max |tp 1|,
    its cache 32 of the 64 positions."""
    base = served["attend", 1]
    for r, ranks in enumerate(served["attend", 2]):
        for job, want in zip(ranks, base):
            assert len(job) == len(want) > 0
            for (name, y, y1, shape), (_, w, w1, wshape) in zip(job, want):
                assert shape == (wshape[0], wshape[1] // 2) + wshape[2:], name
                for a, b in ((y, w), (y1, w1)):
                    err = np.abs(a - b).max() / np.abs(b).max()
                    assert err <= SEQ_ATOL, (r, name, err)


def test_launcher_tp2(capfd):
    assert launcher.main(["--arch", "deepseek-v2-lite-16b", "--smoke", "--device",
                          "cpu", "--tp", "2", "--requests", "3", "--max-new", "4"]) == 0
    out = capfd.readouterr().out
    assert "[serve] mesh: {'data': 1, 'model': 2} over 2 ranks, backend gloo" in out
    assert "[serve] 3 requests, 12 tokens" in out


# ---------------------------------------------------------------------------
# pad_heads_to
# ---------------------------------------------------------------------------
def _padded_pair():
    """The JAX suite's padded GQA layer (qwen2.5 smoke, KH 2 -> 3, H 4 ->
    6): real weights copied in, padded k/v rows zero. Returns (cfg, cfg_pad,
    JAX params, JAX padded params)."""
    jcfg = jconfigs.get_smoke("qwen2.5-32b", act_impl="exact")
    jpad = dataclasses.replace(jcfg, pad_heads_to=3)
    params = jcm.init_params(JA.gqa_spec(jcfg), jax.random.PRNGKey(10))
    pp = {k: np.asarray(v) for k, v in
          jcm.init_params(JA.gqa_spec(jpad), jax.random.PRNGKey(11)).items()}
    H, KH = jcfg.num_heads, jcfg.num_kv_heads
    for w, n in (("wq", H), ("wk", KH), ("wv", KH)):
        out = pp[w] * 0.0
        out[:, :n] = np.asarray(params[w])
        pp[w] = out
    wo = np.zeros_like(pp["wo"])
    wo[:H] = np.asarray(params["wo"])
    pp["wo"] = wo
    for b, n in (("bq", H), ("bk", KH), ("bv", KH)):
        arr = np.zeros_like(pp[b])
        arr[:n] = np.asarray(params[b])
        pp[b] = arr
    cfg = configs.get_smoke("qwen2.5-32b", act_impl="exact")
    return cfg, dataclasses.replace(cfg, pad_heads_to=3), params, pp


def _jax_logits(jcfg):
    """The JAX forward's logits, jitted (eager dispatch takes seconds)."""
    return jax.jit(lambda p, t: JT.apply(p, {"tokens": t}, jcfg)[0])


def _port_gqa(cfg, arrays):
    layer = A.GQAttention(cfg, dtype=torch.float32, device=torch.device("cpu"))
    T.copy_into(dict(layer.named_parameters()), {k: np.asarray(v) for k, v in arrays.items()})
    return layer


def test_pad_heads_forward_exact_against_jax():
    cfg, cfg_pad, params, pp = _padded_pair()
    jpad = dataclasses.replace(jconfigs.get_smoke("qwen2.5-32b", act_impl="exact"),
                               pad_heads_to=3)
    x = np.random.default_rng(12).normal(0, 0.5, (2, 16, cfg.d_model)).astype(np.float32)
    want = jax.jit(lambda p, x: JA.gqa_apply(p, x, jpad)[0])(
        {k: jnp.asarray(v) for k, v in pp.items()}, jnp.asarray(x))
    layer = _port_gqa(cfg_pad, pp)
    assert tuple(layer.wq.shape) == (cfg.d_model, 6, cfg.head_dim)
    with torch.no_grad():
        got = A.gqa_apply(layer, torch.from_numpy(x), cfg_pad)
        ref = A.gqa_apply(_port_gqa(cfg, params), torch.from_numpy(x), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-5)
    # the padded heads add nothing: the unpadded layer's output
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=2e-5)


def test_pad_heads_cache_and_pool_shapes():
    _, cfg_pad, _, _ = _padded_pair()
    jpad = dataclasses.replace(jconfigs.get_smoke("qwen2.5-32b", act_impl="exact"),
                               pad_heads_to=3)
    dense = A.gqa_init_cache(cfg_pad, 2, 8, device="cpu")
    want = JA.gqa_init_cache(jpad, 2, 8, jnp.float32)
    assert tuple(dense["k"].shape) == want["k"].shape == (2, 8, 3, cfg_pad.head_dim)
    paged = A.gqa_init_paged_cache(cfg_pad, 2, 5, 4, 2, device="cpu")
    jp = JA.gqa_init_paged_cache(jpad, 2, 5, 4, 2, jnp.float32)
    for k in ("k_pool", "v_pool"):
        assert tuple(paged[k].shape) == jp[k].shape


def test_pad_heads_model_weights_carry_over():
    """A padded JAX tree loads into the port (``load_jax_params``) and its
    logits match the JAX forward."""
    jcfg = dataclasses.replace(jconfigs.get_smoke("yi-9b", act_impl="exact"),
                               pad_heads_to=2, softmax_impl="exact")
    cfg = dataclasses.replace(configs.get_smoke("yi-9b", act_impl="exact"),
                              pad_heads_to=2, softmax_impl="exact")
    jparams = JT.init(jcfg, jax.random.PRNGKey(1))
    model = T.load_jax_params(cfg, T.flatten_params(jparams), device="cpu")
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 12))
    want = np.asarray(_jax_logits(jcfg)(jparams, jnp.asarray(tokens)))
    with torch.no_grad():
        got = T.apply(model, {"tokens": torch.from_numpy(tokens)}, cfg)[0]
    assert model.blocks[0].attn.wk.shape[1] == 2
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


# ---------------------------------------------------------------------------
# score_dtype="bf16_mxu"
# ---------------------------------------------------------------------------
def _bf16(shape, rng, scale=1.0):
    x = (rng.standard_normal(shape) * scale).astype(np.float32)
    return jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)


#: bf16_mxu against the JAX function on the same bfloat16 inputs: both
#: score exact float32 products of bfloat16 values in float32; the sums'
#: order differs, so outputs agree to float32 rounding of O(1) values
BF16_MXU_ATOL = 1e-5


def test_bf16_mxu_attend_rows_against_jax():
    rng = np.random.default_rng(7)
    B, S, T_, KH, G, D = 2, 3, 24, 2, 2, 16
    qj, qt = _bf16((B, S, KH, G, D), rng)
    kj, kt = _bf16((B, T_, KH, D), rng)
    vj, vt = _bf16((B, T_, KH, D), rng)
    pos = np.array([[5, 6, 7], [20, 21, 22]])
    klen = np.array([8, 23])
    scale = 1.0 / np.sqrt(D)
    want = np.asarray(JA._attend_rows(qj, kj, vj, jnp.asarray(pos), jnp.asarray(klen),
                                      scale, "bf16_mxu"))
    got = A._attend_rows(qt, kt, vt, torch.from_numpy(pos), torch.from_numpy(klen),
                         scale, "bf16_mxu")
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=BF16_MXU_ATOL)
    # the probabilities round to bfloat16 before P.V: not the f32 path's
    f32 = A._attend_rows(qt, kt, vt, torch.from_numpy(pos), torch.from_numpy(klen),
                         scale, "f32")
    assert not torch.equal(got, f32)
    wantb = np.asarray(JA._attend_block(qj[:1], kj[:1], vj[:1], jnp.arange(3) + 4,
                                        jnp.arange(T_), scale, "bf16_mxu"))
    gotb = A._attend_block(qt[:1], kt[:1], vt[:1], torch.arange(3) + 4,
                           torch.arange(T_), scale, "bf16_mxu")
    np.testing.assert_allclose(gotb.numpy(), wantb, rtol=0, atol=BF16_MXU_ATOL)


def test_bf16_mxu_mla_absorbed_decode_against_jax():
    rng = np.random.default_rng(8)
    B, H, T_, R, P, nope, vd = 2, 4, 16, 32, 8, 16, 16
    qn, qnt = _bf16((B, 1, H, nope), rng)
    qr, qrt = _bf16((B, 1, H, P), rng)
    cc, cct = _bf16((B, T_, R), rng)
    cr, crt = _bf16((B, T_, P), rng)
    wk, wkt = _bf16((R, H, nope), rng, 0.2)
    wv, wvt = _bf16((R, H, vd), rng, 0.2)
    valid = (np.arange(T_)[None, :] < np.array([[9], [16]]))[:, None, None, :]
    # the latent buffers in float32, as the engine's caches hold them
    want = np.asarray(JA._mla_absorbed_decode(
        qn, qr, cc.astype(jnp.float32), cr.astype(jnp.float32), wk, wv, 0.2,
        jnp.asarray(valid), "bf16_mxu", "exact"))
    got = A._mla_absorbed_decode(qnt, qrt, cct.float(), crt.float(), wkt, wvt, 0.2,
                                 torch.from_numpy(valid), "bf16_mxu", "exact")
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


def test_bf16_mxu_model_against_jax_and_kernel_path_refuses():
    """Yi's smoke config in bfloat16 with bf16_mxu scoring: the port's
    logits against the JAX forward on the same weights; the decode
    kernel's path refuses it with the JAX message. Both frameworks round
    every op to bfloat16, which put them 0.017 of max|logit| apart here,
    while the JAX model's f32 and bf16_mxu logits lie 0.015 apart: at
    model level the bound cannot tell the score dtypes apart, so the
    dtype is held by the unit test of ``_attend_rows`` above (1e-5 on
    bfloat16 inputs, where the f32 path's output differs), and this test
    holds the wiring (config to module) and the refusal."""
    jcfg = dataclasses.replace(jconfigs.get_smoke("yi-9b", act_impl="exact"),
                               dtype="bfloat16", score_dtype="bf16_mxu")
    cfg = dataclasses.replace(configs.get_smoke("yi-9b", act_impl="exact"),
                              dtype="bfloat16", score_dtype="bf16_mxu")
    jparams = JT.init(jcfg, jax.random.PRNGKey(2))
    model = T.load_jax_params(cfg, T.flatten_params(jparams), device="cpu")
    tokens = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 10))
    want = np.asarray(_jax_logits(jcfg)(jparams, jnp.asarray(tokens)))
    with torch.no_grad():
        got = T.apply(model, {"tokens": torch.from_numpy(tokens)}, cfg)[0].numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=0.03 * np.abs(want).max())
    eng = ServeEngine(cfg, model, kv_impl="paged", paged_attend_impl="gather",
                      slots=2, max_len=32, device="cpu")
    eng.submit(launcher.Request(rid=0, prompt=tokens[0].astype(np.int32), max_new_tokens=3))
    assert len(eng.run()[0].out) == 3
    with pytest.raises(ValueError, match="score_dtype='f32' only"):
        ServeEngine(cfg, model, kv_impl="paged", paged_attend_impl="pallas",
                    device="cpu")
    with pytest.raises(ValueError, match="use the gather path for bf16_mxu"):
        A._paged_attend_impl(dataclasses.replace(cfg, paged_attend_impl="pallas"))
