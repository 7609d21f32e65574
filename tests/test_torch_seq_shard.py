"""``kv_shard="seq_model"``: the dense caches' positions cut over the model
axis (models/attention.py), on one process.

The split CORDIC softmax (``softmax_cordic.softmax_split_*``, the plain
versions the wrappers run on CPU tensors) is held bit for bit against the
whole row's ``softmax_2d_plain`` and, for ``cordic_fixed``, against
``functions.softmax_fixed``, with each span's launches run in turn and the
reductions between them done here (a max, a concatenation in span order);
once against the JAX kernel in interpret mode. The spans' writes
(``_dense_write`` with a span) land where the whole buffer's would; the
cache cut, the span rule's refusal, the knob's fallbacks, the C.6 device
set-up of ``rank_train`` and the dry run's ``--remat`` flag close the file.
The engines at tp 2 on spawned ranks are in ``tests/test_torch_tp.py``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import softmax_cordic as JS  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.cordic_engine import functions as F  # noqa: E402
from repro_torch.core import numerics as nx  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.kernels import softmax_cordic as SM  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402


def _rows(seed, rows, cols, masked):
    """Scale-4 rows; ``masked``: a causal staircase of -1e30 tails, one row
    masked but for its first lane, and one whose far lanes sit more than
    e^-20 below the max (exactly 0 out)."""
    x = np.random.default_rng(seed).normal(size=(rows, cols)).astype(np.float32) * 4
    if masked:
        for r in range(rows - 2):
            x[r, (r + 1) * cols // rows:] = -1e30
        x[-2, 1:] = -1e30
        x[-1, :] = 0.0
        x[-1, 0] = 30.0
    return torch.from_numpy(x)


def _split_cordic(x, spans):
    """The three launches span by span, the reductions between them here."""
    xs = [t.contiguous() for t in x.chunk(spans, dim=-1)]
    m = torch.stack([SM.softmax_split_max(t) for t in xs]).amax(0)
    w = torch.cat([SM.softmax_split_windows(t, m) for t in xs], dim=-1)
    return torch.cat([SM.softmax_split_probs(t, m, w) for t in xs], dim=-1)


def _split_fixed(x, spans):
    """``cordic_fixed``'s split (``attention._split_softmax``) span by span."""
    m = x.amax(dim=-1, keepdim=True)
    es = [F.exp_fixed(t - m) for t in x.chunk(spans, dim=-1)]
    w = torch.cat([nx.window_sums(e) for e in es], dim=-1)
    return torch.cat([F.divide_fixed(e, nx.xla_sum(w, -1, keepdim=True)) for e in es],
                     dim=-1)


@pytest.mark.parametrize("masked", [False, True], ids=["dense", "masked"])
@pytest.mark.parametrize("windows", [1, 3, 32])
@pytest.mark.parametrize("spans", [2, 4])
@pytest.mark.parametrize("impl", ["cordic_pallas", "cordic_fixed"])
def test_split_softmax_bit_equal_to_the_whole_row(impl, spans, windows, masked):
    """Spans of 32 k lanes: the split equals the whole row bit for bit,
    masked tails, a row of one live lane and underflowing lanes included.
    Rows of 2 x 32 and 4 x 32 lanes pad to 128 (zero windows past the
    spans), 4 x 3 x 32 to 384, 2 x 32 x 32 is a second level of windows."""
    x = _rows(spans * 10 + windows, 6, spans * windows * 32, masked)
    if impl == "cordic_pallas":
        want, got = SM.softmax_2d_plain(x), _split_cordic(x, spans)
    else:
        want, got = F.softmax_fixed(x), _split_fixed(x, spans)
    assert torch.equal(got, want)


def test_split_softmax_equals_the_jax_kernel():
    """One small shape against the JAX kernel in interpret mode, and the
    rows whose sums land on a rounding edge of the mantissa
    (test_torch_softmax_cordic.py's edge rows: another order moves a lane
    by a code step) against the whole row at four spans."""
    x = _rows(5, 6, 256, masked=True)
    want = np.asarray(JS.softmax_2d(jnp.asarray(x.numpy()), interpret=True))
    np.testing.assert_array_equal(_split_cordic(x, 4).numpy(), want)
    edge = torch.from_numpy(
        (np.random.default_rng(2).normal(size=(300, 4096)).astype(np.float32)
         * np.float32(0.5))[[41, 164, 257]])
    assert torch.equal(_split_cordic(edge, 4), SM.softmax_2d_plain(edge))


def test_split_span_must_be_whole_windows():
    x = _rows(0, 2, 48, masked=False)
    with pytest.raises(ValueError, match="multiple of 32 lanes"):
        SM.softmax_split_windows(x, x.amax(-1))


@pytest.mark.parametrize("S", [1, 5, 24], ids=["decode", "prefill", "wide_prefill"])
def test_dense_write_lands_in_the_owning_span(S):
    """Each rank's span of a buffer written with its (lo, total) equals the
    whole buffer's slice after the same write: a decode position, a
    prefill inside one span and across both, a prefill wider than a span,
    and a vacant slot whose idx runs past the buffer (clamped in global
    positions)."""
    T, tp, B = 16, 2, 4
    g = torch.Generator().manual_seed(S)
    whole = torch.randn(B, T, 3, generator=g)
    spans = [whole[:, r * T // tp:(r + 1) * T // tp].clone() for r in range(tp)]
    idx = torch.tensor([0, 6, T - 1, T + 40], dtype=torch.int32)
    new = torch.randn(B, S, 3, generator=g)
    A._dense_write(whole, idx, new)
    for r, buf in enumerate(spans):
        A._dense_write(buf, idx, new, r * T // tp, T)
        assert torch.equal(buf, whole[:, r * T // tp:(r + 1) * T // tp]), r


def _mesh(tp, rank=0):
    return M.Mesh(shape={"data": 1, "model": tp}, rank=rank, group=None, backend="none")


@pytest.mark.parametrize("arch", ["yi-9b", "deepseek-v2-lite-16b", "zamba2-1.2b"])
def test_rank_cache_holds_its_span_of_every_kv_head(arch):
    """At tp 2 each rank's dense buffers hold T/2 positions of every KV
    head (GQA k/v, MLA's latent and rope key, Zamba2's shared block); the
    heads cut keeps T positions; the recurrent state is untouched."""
    cfg = dataclasses.replace(configs.get_smoke(arch), kv_shard="seq_model")
    auto = dataclasses.replace(cfg, kv_shard="auto")
    mesh = _mesh(2)
    cut = T.init_cache(cfg, 3, 64, device="cpu", kv_heads=shd.local_kv_heads(cfg, mesh),
                       mesh=mesh)
    whole = T.init_cache(auto, 3, 64, device="cpu", mesh=mesh)
    kh = A.padded_heads(cfg)[1]
    seen = 0
    for c, w in zip(cut.layers, whole.layers):
        for k in ("k", "v", "c_kv", "k_rope"):
            if k in c:
                seen += 1
                assert c[k].shape[1] == 32 and w[k].shape[1] == 64
                if k in ("k", "v"):
                    assert c[k].shape[2] == kh
        if "idx" not in c:
            assert {k: v.shape for k, v in c.items()} == {k: v.shape for k, v in w.items()}
    assert seen > 0
    with pytest.raises(ValueError, match="does not divide"):
        T.init_cache(cfg, 3, 63, device="cpu", mesh=mesh)


def test_engine_refuses_a_span_of_partial_windows():
    """A CORDIC softmax whose span max_len / tp is not whole 32-lane
    windows is refused at init, naming the rule; the exact softmax takes
    it; where tp does not divide max_len, and on the paged plane, the heads
    cut stays and the knob reads "auto"."""
    base = dataclasses.replace(configs.get_smoke("yi-9b"), kv_shard="seq_model")
    model = T.init(base, device="cpu")
    for impl in ("cordic_pallas", "cordic_fixed"):
        cfg = dataclasses.replace(base, softmax_impl=impl)
        with pytest.raises(ValueError, match="multiple of 32 lanes"):
            ServeEngine(cfg, model, max_len=96, mesh=_mesh(2), device="cpu")
    eng = ServeEngine(base, model, max_len=96, mesh=_mesh(2), device="cpu")
    assert eng.cfg.kv_shard == "seq_model"
    assert eng._caches.layers[0]["k"].shape[1] == 48
    odd = ServeEngine(base, model, max_len=97, mesh=_mesh(2), device="cpu")
    assert odd.cfg.kv_shard == "auto" and odd._caches.layers[0]["k"].shape[1] == 97
    paged = ServeEngine(base, model, max_len=96, mesh=_mesh(2), device="cpu",
                        kv_impl="paged", block_len=16)
    assert paged.cfg.kv_shard == "auto"
    with pytest.raises(ValueError, match="unknown kv_shard"):
        ServeEngine(dataclasses.replace(base, kv_shard="seq"), model, mesh=_mesh(2),
                    device="cpu")


def test_rank_train_keeps_each_ranks_card(monkeypatch):
    """C.6: under NCCL (a card a rank) each rank of ``rank_train`` stays on
    its own card; under gloo, ranks sharing the one card, every rank takes
    card 0; the CPU stays the CPU."""
    calls = []
    monkeypatch.setattr(torch.cuda, "set_device", calls.append)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    backend = M.pick_backend(2, "cuda")
    assert backend == "nccl"
    assert [launch_train.rank_device("cuda", r, backend) for r in (0, 1)] == [
        "cuda:0", "cuda:1"]
    assert calls == [0, 1]
    monkeypatch.setattr(M, "pick_backend", lambda world, device: "gloo")
    calls.clear()
    backend = M.pick_backend(2, "cuda")
    assert [launch_train.rank_device("cuda", r, backend) for r in (0, 1)] == [
        "cuda:0", "cuda:0"]
    assert calls == [0, 0]
    assert launch_train.rank_device("cpu", 1, "gloo") == "cpu"


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
def test_dryrun_takes_remat(remat, monkeypatch):
    """``--remat`` reaches ``lower_cell`` as the JAX dry run passes it."""
    seen = []

    def lower(arch, shape, **kw):
        seen.append(kw)
        return {"arch": arch, "shape": shape, "status": "skipped", "reason": "stub"}

    monkeypatch.setattr(dryrun, "lower_cell", lower)
    assert dryrun.main(["--arch", "yi-9b", "--shape", "train_4k", "--remat", remat]) == 0
    assert [kw["remat"] for kw in seen] == [remat]
    with pytest.raises(SystemExit):
        dryrun.main(["--arch", "yi-9b", "--shape", "train_4k", "--remat", "some"])
