"""PyTorch port of the paged serving engine against the JAX engine, plus
the port's package boundary and its copies of the pure-Python serving
modules."""
import functools
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serve import engine as JE  # noqa: E402
from repro.serve import kv_pager as jkvp  # noqa: E402
from repro.serve import scheduler as jsched  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serve import engine as E  # noqa: E402
from repro_torch.serve import kv_pager as kvp  # noqa: E402
from repro_torch.serve import scheduler as sched  # noqa: E402
from test_torch_models import spec_params  # noqa: E402

ENGINE_KW = dict(slots=2, max_len=64, softmax_impl="cordic_pallas",
                 kv_impl="paged", paged_attend_impl="pallas")


def _prompts(vocab, n=3, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, int(rng.integers(4, 12))).astype(np.int32)
            for _ in range(n)]


def test_greedy_tokens_identical_to_jax_engine():
    """Yi smoke config, paged pools, decode-kernel attend, CORDIC act and
    softmax; 3 requests through 2 slots, 8 new tokens each."""
    jcfg = jconfigs.get_smoke("yi-9b", act_impl="cordic_pallas")
    cfg = configs.get_smoke("yi-9b", act_impl="cordic_pallas")
    jparams = JT.init(jcfg, jax.random.PRNGKey(0))
    prompts = _prompts(cfg.vocab_size)

    jeng = JE.ServeEngine(jcfg, jparams, **ENGINE_KW)
    for i, p in enumerate(prompts):
        jeng.submit(JE.Request(rid=i, prompt=p, max_new_tokens=8))
    want = {r.rid: r.out for r in jeng.run()}

    model = T.load_jax_params(cfg, T.flatten_params(jparams), device="cpu")
    eng = E.ServeEngine(cfg, model, device="cpu", **ENGINE_KW)
    for i, p in enumerate(prompts):
        eng.submit(E.Request(rid=i, prompt=p, max_new_tokens=8))
    got = {r.rid: r.out for r in eng.run()}
    assert got == want
    assert all(len(v) == 8 for v in got.values())
    assert eng.pager.blocks_in_use == 0


def test_gather_and_kernel_decode_emit_the_same_tokens():
    """The decode kernel's plain version against the table-gather attend
    (_pool_gather + _attend_rows), as the JAX suite holds its kernel."""
    cfg = configs.get_smoke("yi-9b", act_impl="cordic_pallas")
    model = T.init(cfg, seed=3, device="cpu")
    outs = []
    for impl in ("pallas", "gather"):
        eng = E.ServeEngine(cfg, model, device="cpu",
                            **{**ENGINE_KW, "paged_attend_impl": impl})
        for i, p in enumerate(_prompts(cfg.vocab_size, seed=1)):
            eng.submit(E.Request(rid=i, prompt=p, max_new_tokens=8))
        outs.append({r.rid: r.out for r in eng.run()})
    assert outs[0] == outs[1]


# ---------------------------------------------------------------------------
# DeepSeek-V2-Lite smoke: MLA pools, the MLA decode kernel's plain version,
# GShard MoE routing at the bucket width
# ---------------------------------------------------------------------------
DS = "deepseek-v2-lite-16b"


@functools.lru_cache(maxsize=None)
def _ds_params():
    """The JAX smoke model's tree, drawn with numpy at its spec's scales
    (jax.random init of the MoE stacks is the slow part of a JAX init)."""
    return spec_params(JT.model_spec(jconfigs.get_smoke(DS)))


def test_deepseek_greedy_tokens_identical_to_jax_engine():
    """DeepSeek-V2-Lite smoke config, paged latent/rope pools, the MLA
    decode kernel's plain version, CORDIC act and softmax; 3 requests
    through 2 slots, 8 new tokens each."""
    jcfg = jconfigs.get_smoke(DS, act_impl="cordic_pallas")
    cfg = configs.get_smoke(DS, act_impl="cordic_pallas")
    jparams = _ds_params()
    prompts = _prompts(cfg.vocab_size)

    jeng = JE.ServeEngine(jcfg, jparams, **ENGINE_KW)
    for i, p in enumerate(prompts):
        jeng.submit(JE.Request(rid=i, prompt=p, max_new_tokens=8))
    want = {r.rid: r.out for r in jeng.run()}

    model = T.load_jax_params(cfg, T.flatten_params(jparams), device="cpu")
    eng = E.ServeEngine(cfg, model, device="cpu", **ENGINE_KW)
    m = cfg.mla
    assert eng.kv_pool_bytes() == jeng.kv_pool_bytes() == (
        cfg.num_layers * eng.pager.num_blocks * eng.block_len
        * (m.kv_lora_rank + m.qk_rope_dim) * 4)
    assert eng.pager.block_bytes == eng.kv_pool_bytes() // eng.pager.num_blocks
    for i, p in enumerate(prompts):
        eng.submit(E.Request(rid=i, prompt=p, max_new_tokens=8))
    got = {r.rid: r.out for r in eng.run()}
    assert got == want
    assert all(len(v) == 8 for v in got.values())
    assert eng.pager.blocks_in_use == 0


def test_deepseek_gather_and_kernel_decode_emit_the_same_tokens():
    cfg = configs.get_smoke(DS, act_impl="cordic_pallas")
    model = T.init(cfg, seed=3, device="cpu")
    outs = []
    for impl in ("pallas", "gather"):
        eng = E.ServeEngine(cfg, model, device="cpu",
                            **{**ENGINE_KW, "paged_attend_impl": impl})
        for i, p in enumerate(_prompts(cfg.vocab_size, seed=1)):
            eng.submit(E.Request(rid=i, prompt=p, max_new_tokens=8))
        outs.append({r.rid: r.out for r in eng.run()})
    assert outs[0] == outs[1]


@pytest.mark.parametrize("arch", ["yi-9b", DS])
def test_cordic_fixed_greedy_tokens_identical_to_jax_engine(arch):
    """The paper-faithful datapath (act_impl and softmax_impl
    "cordic_fixed"): paged pools, the decode kernels' cordic_fixed plain
    versions, 3 requests through 2 slots, 8 new tokens each, against the
    JAX engine with its Pallas decode in interpret mode."""
    kw = {**ENGINE_KW, "softmax_impl": "cordic_fixed"}
    jcfg = jconfigs.get_smoke(arch, act_impl="cordic_fixed")
    cfg = configs.get_smoke(arch, act_impl="cordic_fixed")
    jparams = (_ds_params() if arch == DS
               else JT.init(jcfg, jax.random.PRNGKey(0)))
    prompts = _prompts(cfg.vocab_size)
    jeng = JE.ServeEngine(jcfg, jparams, **kw)
    for i, p in enumerate(prompts):
        jeng.submit(JE.Request(rid=i, prompt=p, max_new_tokens=8))
    want = {r.rid: r.out for r in jeng.run()}

    model = T.load_jax_params(cfg, T.flatten_params(jparams), device="cpu")
    eng = E.ServeEngine(cfg, model, device="cpu", **kw)
    for i, p in enumerate(prompts):
        eng.submit(E.Request(rid=i, prompt=p, max_new_tokens=8))
    got = {r.rid: r.out for r in eng.run()}
    assert got == want
    assert all(len(v) == 8 for v in got.values())


def test_deepseek_launcher_serves_on_the_cpu(capsys):
    from repro_torch.launch import serve as launch

    assert launch.main(["--arch", DS, "--smoke", "--device", "cpu",
                        "--requests", "3", "--slots", "2", "--max-new", "4",
                        "--max-len", "64"]) == 0
    assert "3 requests, 12 tokens" in capsys.readouterr().out


def test_kv_quant_with_mla_is_rejected_as_in_jax():
    cfg = configs.get_smoke(DS, act_impl="cordic_pallas")
    with pytest.raises(ValueError, match="GQA paged pools only"):
        E.ServeEngine(cfg, T.init(cfg, device="cpu"), device="cpu",
                      **{**ENGINE_KW, "kv_quant": "int8"})


def test_mla_moe_training_is_not_ported_yet():
    """MLA/MoE training was not ported until ROADMAP A.11 closed: one step
    of DeepSeek-V2-Lite's smoke config trains now, the router included
    (its gradients against JAX: tests/test_torch_train_archs.py)."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLMDataset
    from repro_torch.optim import adamw
    from repro_torch.train import loop as loop_lib
    from repro_torch.train import step as step_lib

    cfg = configs.get_smoke(DS, act_impl="cordic_pallas")
    state = step_lib.init_state(cfg, 0, adamw.AdamWConfig(), device="cpu")
    router = state.params.blocks[1].ffn.router.detach().clone()
    batch = SyntheticLMDataset(DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                          global_batch=2)).batch_at(0)
    state, m = step_lib.make_train_step(cfg, adamw.AdamWConfig(), warmup_steps=0)(
        state, loop_lib.to_device(batch, "cpu"))
    assert np.isfinite(float(m["loss"])) and float(m["aux"]) > 0
    assert not torch.equal(state.params.blocks[1].ffn.router, router)


def test_launcher_serves_on_the_cpu(capsys):
    from repro_torch.launch import serve as launch

    assert launch.main(["--arch", "yi-9b", "--smoke", "--device", "cpu",
                        "--requests", "3", "--slots", "2", "--max-new", "4",
                        "--max-len", "64"]) == 0
    assert "3 requests, 12 tokens" in capsys.readouterr().out
    assert launch.main(["--arch", "yi-9b", "--smoke", "--device", "cpu",
                        "--requests", "3", "--slots", "2", "--max-new", "4",
                        "--max-len", "64", "--prefix-cache"]) == 0
    assert "prefix cache (lru): 1 hits / 2 blocks reused" in capsys.readouterr().out


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import pkgutil, sys, importlib, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'repro' or m.startswith('repro.')]\n"
        "print(len([m for m in sys.modules if m.startswith('repro_torch')]), bad)\n"
        "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[0]) >= 20


def test_engine_without_gpu_raises_unless_cpu_requested():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    cfg = configs.get_smoke("yi-9b", act_impl="cordic_pallas")
    model = T.init(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        E.ServeEngine(cfg, model, **ENGINE_KW)


@pytest.mark.parametrize("kw,entry", [
    (dict(tp=2), "run_ranks"),
])
def test_unported_engine_options_raise(kw, entry):
    """Tensor parallelism serves every arch now, the recurrent ones too
    (tests/test_torch_tp.py): ``tp=2`` without a process group of two
    ranks raises the mesh's ValueError, which names ``run_ranks``; within
    one (here a rank's view of the mesh) the xLSTM engine builds and
    serves."""
    from repro_torch.launch import mesh as mesh_lib

    cfg = configs.get_smoke("xlstm-1.3b")
    model = T.init(cfg, device="cpu")
    with pytest.raises(ValueError, match=entry):
        E.ServeEngine(cfg, model, device="cpu", **kw)
    eng = E.ServeEngine(cfg, model, device="cpu", mesh=mesh_lib.dry_mesh(2))
    assert eng.tp == 2
    eng.submit(E.Request(rid=0, prompt=np.arange(1, 7, dtype=np.int32), max_new_tokens=2))
    assert len(eng.run()[0].out) == 2


@pytest.mark.parametrize("flags,want", [
    (["--kv-impl", "dense"], "attend=gather"),
    (["--temperature", "0.8", "--top-k", "40"], "temperature=0.8 top_k=40"),
    (["--metrics-json", "{tmp}/metrics.json", "--trace-out", "{tmp}/trace.json"],
     "wrote Chrome trace"),
], ids=["kv-impl-dense", "temperature-top-k", "metrics-trace"])
def test_launcher_takes_the_jax_launchers_flags(flags, want, tmp_path, capsys):
    """The dense plane, seeded sampling and observability through the
    launcher on the smoke config."""
    import json

    from repro_torch.launch import serve as launch
    from repro_torch.obs import validate_chrome_trace

    flags = [f.format(tmp=tmp_path) for f in flags]
    assert launch.main(["--arch", "yi-9b", "--smoke", "--device", "cpu",
                        "--requests", "3", "--slots", "2", "--max-new", "4",
                        "--max-len", "64", *flags]) == 0
    out = capsys.readouterr().out
    assert "3 requests, 12 tokens" in out and want in out
    if "--metrics-json" in flags:
        assert "ttft p50/p99" in out and "tpot p50" in out
        snap = json.loads((tmp_path / "metrics.json").read_text())["metrics"]
        assert snap["engine.tokens.emitted"]["value"] == 12
        assert snap["engine.requests.finished"]["value"] == 3
        validate_chrome_trace(json.loads((tmp_path / "trace.json").read_text()))


def test_submit_rejects_and_clamps():
    cfg = configs.get_smoke("yi-9b", act_impl="cordic_pallas")
    eng = E.ServeEngine(cfg, T.init(cfg, device="cpu"), device="cpu", **ENGINE_KW)
    bad = E.Request(rid=0, prompt=np.zeros(65, np.int32))
    empty = E.Request(rid=1, prompt=np.zeros(0, np.int32))
    ok = E.Request(rid=2, prompt=np.ones(60, np.int32), max_new_tokens=16)
    for r in (bad, empty, ok):
        eng.submit(r)
    assert bad.done and "max_len" in bad.error and empty.done
    assert ok.max_new_tokens == 5 and not ok.done


# ---------------------------------------------------------------------------
# The port's copies of kv_pager / scheduler pass the JAX suite's own cases
# (tests/test_kv_pager.py, tests/test_scheduler.py), run on both modules
# ---------------------------------------------------------------------------
PAGERS = pytest.mark.parametrize("pager", [jkvp, kvp], ids=["jax", "torch"])
SCHEDS = pytest.mark.parametrize("sm", [(jsched, jkvp), (sched, kvp)],
                                 ids=["jax", "torch"])


@PAGERS
def test_pager_buckets_and_blocks(pager):
    assert pager.bucket_lengths(256, 16) == (16, 32, 64, 128, 256)
    assert pager.bucket_lengths(96, 16) == (16, 32, 64, 96)
    assert pager.bucket_for(17, (16, 32, 64)) == 32
    assert pager.blocks_needed(33, 16) == 3 and pager.blocks_needed(32, 16) == 2


@PAGERS
def test_pager_alloc_free_all_or_nothing(pager):
    p = pager.KVPager(num_blocks=6, block_len=4, slots=3)
    assert p.capacity == 5                       # block 0 is scratch
    got = p.alloc(0, 3)
    assert len(got) == 3 and pager.SCRATCH_BLOCK not in got
    assert p.alloc(1, 3) is None                 # only 2 left: nothing taken
    assert p.blocks_free == 2
    p.free(0)
    assert p.blocks_free == 5 and p.stats().peak_in_use == 3


@SCHEDS
def test_scheduler_single_shot_fifo_and_budget(sm):
    module, pager = sm
    s = module.IterationScheduler(buckets=pager.bucket_lengths(64, 16),
                                  block_len=16, max_len=64, prefill_chunk=None,
                                  max_prefill_tokens=48)

    class R:
        def __init__(self, n):
            self.prompt = np.zeros(n, np.int32)

    for n in (5, 20, 7):
        s.enqueue(R(n))
    free = iter([0, 1, 2])
    rows = s.plan(lambda req: next(free))
    # widths are the buckets; the 48-token budget stops after 16 + 32
    assert [(r.slot, r.width, r.final, r.fresh) for r in rows] == \
        [(0, 16, True, True), (1, 32, True, True)]
    assert len(s.queue) == 1
    assert s.plan(lambda req: None) == [] and len(s.queue) == 1
