"""The port's observability layer (repro_torch.obs) and the engine's hooks:
the registry against numpy quantiles, the JSON snapshot, the null
registry; the port's Chrome trace against both packages' validators; equal
tokens with observability on and off; request lifecycle order;
``attach_obs`` after warm-up; the saturation counters; and the metric
names the port registers against ``docs/observability.md``, both ways
(tests/test_docs.py's rules over the port's files)."""
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.obs import trace as jtrace  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch import obs as obs_lib  # noqa: E402
from repro_torch.core import fixed_point as fp  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.obs.metrics import Histogram, MetricsRegistry, NULL_REGISTRY  # noqa: E402
from repro_torch.obs.trace import TraceRecorder, validate_chrome_trace  # noqa: E402
from repro_torch.serve import engine as E  # noqa: E402
from repro_torch.serve import kv_pager as kvp  # noqa: E402
from repro_torch.serve.sampling import SamplingParams  # noqa: E402
import test_docs  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
#: the port's files whose registrations the doc must mirror
PORT_METRIC_FILES = [*sorted((PORT / "obs").glob("*.py")),
                     PORT / "serve" / "engine.py", PORT / "serve" / "kv_pager.py"]

_MODEL = {}


def _model():
    if not _MODEL:
        cfg = configs.get_smoke("yi-9b", act_impl="cordic_pallas")
        _MODEL["m"] = (cfg, T.init(cfg, seed=1, device="cpu"))
    return _MODEL["m"]


def _engine(kv_impl="paged", **kw):
    cfg, model = _model()
    return E.ServeEngine(cfg, model, slots=2, max_len=64, kv_impl=kv_impl,
                         softmax_impl="cordic_pallas", device="cpu", **kw)


def _requests(n, max_new=5, seed=0):
    """n requests of 3-8 tokens; odd rids sampled."""
    cfg, _ = _model()
    rng = np.random.default_rng(seed)
    return [E.Request(rid=i, prompt=rng.integers(0, cfg.vocab_size,
                                                 int(rng.integers(3, 9))).astype(np.int32),
                      max_new_tokens=max_new,
                      sampling=SamplingParams(temperature=0.8, top_k=8) if i % 2 else None)
            for i in range(n)]


def _serve(eng, reqs):
    for r in reqs:
        eng.submit(r)
    steps = 0
    while eng.step():
        steps += 1
        assert steps < 500
    return [list(r.out) for r in reqs]


# --------------------------------------------------------------------------
# registry and trace
# --------------------------------------------------------------------------
@pytest.mark.parametrize("dist", ["uniform", "lognormal", "bimodal"])
def test_histogram_quantiles_match_numpy(dist):
    rng = np.random.default_rng(42)
    if dist == "uniform":
        xs = rng.uniform(0.5, 50.0, 5000)
    elif dist == "lognormal":
        xs = rng.lognormal(1.0, 1.5, 5000)
    else:
        xs = np.abs(np.concatenate([rng.normal(2.0, 0.1, 2000),
                                    rng.normal(200.0, 5.0, 3000)]))
    h = Histogram("h", growth=1.07)
    for x in xs:
        h.observe(float(x))
    assert h.count == len(xs)
    assert h.min == pytest.approx(xs.min()) and h.max == pytest.approx(xs.max())
    assert h.sum == pytest.approx(xs.sum(), rel=1e-9)
    for q in (0.50, 0.90, 0.99):
        # log-bucket growth 1.07 bounds the relative error by ~sqrt(1.07)
        assert h.quantile(q) == pytest.approx(np.percentile(xs, q * 100), rel=0.08)


def test_counter_gauge_and_snapshot_json(tmp_path):
    reg = MetricsRegistry()
    c = reg.counter("a.count", unit="tok")
    c.inc(3)
    with pytest.raises(ValueError):
        c.inc(-1)
    g = reg.gauge("b.depth")
    for v in (3.0, 7.0, 2.0):
        g.set(v)
    assert g.last == 2.0 and g.peak == 7.0 and g.mean == pytest.approx(4.0)
    with pytest.raises(TypeError):
        reg.gauge("a.count")
    h = reg.histogram("c.lat_ms", unit="ms")
    for v in (1.0, 2.0, 10.0):
        h.observe(v)
    snap = reg.snapshot()
    assert snap["a.count"]["value"] == 3 and snap["c.lat_ms"]["count"] == 3
    assert set(snap["c.lat_ms"]) >= {"p50", "p90", "p99", "min", "max"}
    reg.to_json(str(tmp_path / "m.json"))
    assert json.loads((tmp_path / "m.json").read_text())["metrics"] == \
        json.loads(json.dumps(snap))


def test_null_registry_and_null_obs_are_inert():
    c = NULL_REGISTRY.counter("x")
    c.inc(10)
    assert c.value == 0
    NULL_REGISTRY.gauge("y").set(5.0)
    NULL_REGISTRY.histogram("z").observe(1.0)
    assert NULL_REGISTRY.snapshot() == {}
    with pytest.raises(RuntimeError):
        NULL_REGISTRY.to_json("/dev/null")
    with obs_lib.NULL.phase("dispatch"):
        pass
    assert obs_lib.NULL.now() == 0.0 and obs_lib.NULL.trace is None


def test_trace_recorder_schema_and_both_validators(tmp_path):
    tr = TraceRecorder()
    tr.instant("enqueue", 10.0, track="req 0", args={"prompt_len": 4})
    tr.complete("prefill", 20.0, 15.0, track="req 0")
    tr.counter("engine.load", 30.0, {"queue_depth": 2})
    for validate in (validate_chrome_trace, jtrace.validate_chrome_trace):
        validate(tr.to_dict())
    with pytest.raises(ValueError):
        validate_chrome_trace({"traceEvents": [
            {"name": "x", "ph": "X", "ts": 0.0, "pid": 1, "tid": 0}]})


# --------------------------------------------------------------------------
# the engine's hooks
# --------------------------------------------------------------------------
@pytest.mark.parametrize("kv_impl", ["dense", "paged"])
def test_tokens_equal_with_obs_on_and_off(kv_impl, tmp_path):
    """Greedy and sampled requests: the same tokens with metrics, tracing
    and saturation accounting on; the trace passes the port's and the JAX
    package's validator after a JSON round trip."""
    off = _serve(_engine(kv_impl), _requests(5))
    ob = obs_lib.Observability(trace=True)
    with obs_lib.observe_saturation(ob.metrics):
        on = _serve(_engine(kv_impl, obs=ob), _requests(5))
    assert on == off
    ob.trace.export(str(tmp_path / "t.json"))
    doc = json.loads((tmp_path / "t.json").read_text())
    validate_chrome_trace(doc)
    jtrace.validate_chrome_trace(doc)
    m = ob.metrics
    assert m.get("engine.tokens.emitted").value == sum(len(t) for t in on)
    assert m.get("fixed_point.saturation.elements{fmt=Q2.14}").value > 0


def test_lifecycle_event_order():
    """Per request: enqueue, admit, first_token, a token per decode step
    (steps 2..n), finish, in time order; each step's phase spans."""
    ob = obs_lib.Observability(trace=True)
    reqs = _requests(5)
    _serve(_engine(obs=ob), reqs)
    for r in reqs:
        evs = ob.trace.track_events(f"req {r.rid}")
        names = [e["name"] for e in evs]
        assert names[:2] == ["enqueue", "admit"] and names[-1] == "finish"
        assert "first_token" in names and "prefill" in names
        ts = [e["ts"] for e in evs if e["ph"] == "i"]
        assert ts == sorted(ts)
        assert [e["args"]["step"] for e in evs if e["name"] == "token"] == \
            list(range(2, len(r.out) + 1))
        assert 0 <= r.t_enqueue <= r.t_admit <= r.t_first <= r.t_finish
    spans = {e["name"] for e in ob.trace.track_events("engine") if e["ph"] == "X"}
    assert {"admit", "dispatch", "host_sync", "sample_copy"} <= spans


def test_engine_metrics_populated():
    ob = obs_lib.Observability()
    eng = _engine(obs=ob)
    reqs = _requests(4, max_new=4)
    _serve(eng, reqs)
    m = ob.metrics
    assert m.get("engine.requests.submitted").value == 4
    assert m.get("engine.requests.finished").value == 4
    assert m.get("engine.tokens.emitted").value == 16
    for h in ("engine.ttft_ms", "engine.tpot_ms", "engine.e2e_ms",
              "engine.prefill_ms"):
        assert m.get(h).count == 4, h
    assert m.get("engine.batch_occupancy").peak == 2.0
    assert m.get("engine.compiles.prefill").value == 0
    assert m.get("engine.compiles.decode").value == 0
    assert m.get("engine.mesh.tp").last == 1.0 and m.get("engine.mesh.devices").last == 1.0
    assert m.get("kv.quant.code_bits").last == 32.0
    assert m.get("kv.pool.allocs").value == 4
    assert m.get("kv.pool.blocks_in_use").last == 0.0
    assert m.get("kv.pool.blocks_in_use").peak > 0
    steps = m.get("engine.step_ms").count
    for ph in ("admit", "dispatch", "host_sync", "sample_copy"):
        assert m.get(f"engine.phase.{ph}_ms").count >= steps


def test_attach_obs_after_warmup():
    """A handle attached after warm-up sees only the traffic after it, and
    the requests queued before it still reach TTFT and e2e."""
    eng = _engine("dense")
    _serve(eng, _requests(2, max_new=2))
    queued = _requests(3, max_new=3, seed=1)
    for r in queued:
        eng.submit(r)
    ob = obs_lib.Observability(trace=True)
    eng.attach_obs(ob)
    while eng.step():
        pass
    m = ob.metrics
    assert m.get("engine.requests.submitted") is not None
    assert m.get("engine.requests.submitted").value == 0
    assert m.get("engine.ttft_ms").count == 3 and m.get("engine.e2e_ms").count == 3
    assert m.get("engine.requests.finished").value == 3
    eng.attach_obs(None)
    _serve(eng, _requests(1, max_new=2, seed=2))
    assert m.get("engine.requests.finished").value == 3


def test_pager_metrics_through_the_registry():
    ob = obs_lib.Observability()
    pager = kvp.KVPager(4, 16, 2, metrics=ob.metrics)
    assert pager.alloc(0, 3) is not None
    assert pager.alloc(1, 2) is None            # only 0 free: backpressure
    assert ob.metrics.get("kv.pool.alloc_failures").value == 1
    pager.free(0)
    assert ob.metrics.get("kv.pool.blocks_freed").value == 3
    assert ob.metrics.get("kv.pool.blocks_in_use").peak == 3.0


def test_saturation_counters_fire_on_overflowing_q2_14():
    reg = MetricsRegistry()
    with obs_lib.observe_saturation(reg):
        fp.quantize(torch.full((8,), 3.0), fp.Q2_14)    # every element clips
        fp.quantize(torch.full((4,), 0.5), fp.Q2_14)
    clips = reg.get("fixed_point.saturation.clips{fmt=Q2.14}")
    assert clips.value == 8
    assert reg.get("fixed_point.saturation.elements{fmt=Q2.14}").value == 12
    fp.quantize(torch.full((8,), 3.0), fp.Q2_14)        # scope closed
    assert clips.value == 8
    audit = obs_lib.saturation_audit({"inrange": torch.linspace(-1.5, 1.5, 64),
                                      "logits": np.linspace(-20.0, 0.0, 64)}, reg)
    for prof in ("q2_14", "q2_20", "q2_29"):
        assert audit[prof]["inrange"]["clipped"] == 0
        assert 0 < audit[prof]["logits"]["clipped"] <= 64


def test_registered_metric_names_are_the_documented_ones():
    """Every metric name the port registers (obs/, serve/engine.py,
    serve/kv_pager.py) is in docs/observability.md, and every one there is
    registered."""
    code = set()
    for path in PORT_METRIC_FILES:
        for m in test_docs._REG_RE.finditer(path.read_text()):
            name = test_docs._normalize_code_name(m.group(2), bool(m.group(1)))
            if name.startswith(test_docs.METRIC_PREFIXES):
                code.add(name)
    doc = test_docs._doc_metric_names()
    assert code == doc, (sorted(code - doc), sorted(doc - code))
