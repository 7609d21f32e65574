"""PyTorch port of the quantized paged KV plane (``core/kv_quant.py``, the
quantized pool writes and gather of ``models/attention.py``, the ``kv_quant``
branch of ``gqa_decode``, the engine's int8 / q2_14 pools) against the JAX
package.

Inputs are drawn with numpy from a seed and handed to both sides. The
format functions and the pool writes are held bit for bit against jitted
JAX (the engine jits them); the decode against the JAX kernel in interpret
mode within the reference's ATOL 2e-5, and bit for bit on the CORDIC
impls (the dequantized operands are the same floats, and both dots run in
XLA:CPU's order at this geometry; ``exact`` differs by its exponential
alone); the engines by their greedy tokens and pool bytes.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.configs.base import ModelConfig as JModelConfig  # noqa: E402
from repro.core import kv_quant as jkvq  # noqa: E402
from repro.kernels import paged_attention as JP  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serve import engine as JE  # noqa: E402
from repro.serve.sampling import SamplingParams as JSamplingParams  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.core import kv_quant as kvq  # noqa: E402
from repro_torch.kernels import paged_attention as P  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serve import engine as E  # noqa: E402

FORMATS = ("int8", "q2_14")
IMPLS = ("exact", "cordic_pallas", "cordic_fixed")
ATOL = 2e-5


def _bits(a):
    return np.asarray(a).view(np.int32 if np.asarray(a).dtype == np.float32
                              else np.asarray(a).dtype)


# ---------------------------------------------------------------------------
# core/kv_quant.py
# ---------------------------------------------------------------------------
def test_spec_for_and_spec_fields():
    for name in FORMATS:
        s, js = kvq.spec_for(name), jkvq.spec_for(name)
        assert s.fmt_max == js.fmt_max and s.code_bits == js.code_bits
        assert str(s.fmt) == str(js.fmt)
        assert np.dtype(str(s.code_dtype).split(".")[1]) == np.dtype(js.code_dtype)
    assert kvq.spec_for("none") is None and kvq.spec_for(None) is None
    with pytest.raises(ValueError, match="int8"):
        kvq.spec_for("int4")
    assert kvq.KV_QUANT_IMPLS == jkvq.KV_QUANT_IMPLS


def _codes_and_scales(fmt, n=1 << 14, seed=0):
    """Random codes of the format (0, +-1 and the extreme codes included)
    and scales spanning 1e-8..1e3 (float32 tiny included)."""
    info = np.iinfo(np.int8 if fmt == "int8" else np.int16)
    rng = np.random.default_rng(seed)
    codes = rng.integers(info.min, info.max + 1, n).astype(info.dtype)
    codes[:5] = [0, 1, -1, info.min, info.max]
    scale = (10.0 ** rng.uniform(-8, 3, n)).astype(np.float32)
    scale[5] = np.finfo(np.float32).tiny
    return codes, scale


@pytest.mark.parametrize("fmt", FORMATS)
def test_dequantize_bit_equal_to_jitted_jax(fmt):
    codes, scale = _codes_and_scales(fmt)
    js = jkvq.spec_for(fmt)
    want = np.asarray(jax.jit(lambda c, s: jkvq.dequantize(c, js, s))(codes, scale))
    got = kvq.dequantize(torch.from_numpy(codes), kvq.spec_for(fmt),
                         torch.from_numpy(scale)).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert got[0] == 0.0 and np.isfinite(got).all()


@pytest.mark.parametrize("fmt", FORMATS)
def test_block_scale_and_quantize_bit_equal_to_jitted_jax(fmt):
    """block_scale (amax / fmt_max, which jitted XLA turns into a product
    with the float32 reciprocal) and quantize, on blocks of mixed
    magnitudes and an all-zero block (the tiny floor)."""
    rng = np.random.default_rng(1)
    x = (rng.normal(size=(64, 16, 4, 32))
         * rng.uniform(1e-3, 1e2, (64, 1, 4, 1))).astype(np.float32)
    x[0] = 0.0
    js, s = jkvq.spec_for(fmt), kvq.spec_for(fmt)
    ws = np.asarray(jax.jit(lambda v: jkvq.block_scale(v, js))(x))
    gs = kvq.block_scale(torch.from_numpy(x), s)
    np.testing.assert_array_equal(_bits(gs.numpy()), _bits(ws))
    assert gs.shape == (64, 1, 4, 1)
    wq = np.asarray(jax.jit(lambda v, c: jkvq.quantize(v, js, c))(x, ws))
    gq = kvq.quantize(torch.from_numpy(x), s, gs)
    assert gq.dtype == s.code_dtype
    np.testing.assert_array_equal(gq.numpy(), wq)


def test_quantize_feeds_the_saturation_observer():
    from repro_torch.core import fixed_point as fp

    seen = []
    prev = fp.set_saturation_observer(lambda f, c, t: seen.append((f, c, t)))
    try:
        kvq.quantize(torch.tensor([1.0, 300.0, -300.0]), kvq.spec_for("int8"),
                     torch.tensor(1.0))
    finally:
        fp.set_saturation_observer(prev)
    assert seen == [("Q8.0", 2, 3)]


# ---------------------------------------------------------------------------
# models/attention.py: _pool_write_quant and _pool_gather_dequant
# ---------------------------------------------------------------------------
N_BLOCKS, L, KH, HD = 9, 4, 2, 8


def _jax_write(fmt):
    return jax.jit(functools.partial(JA._pool_write_quant, spec=jkvq.spec_for(fmt)))


def _write_both(fmt, pool, scales, tables, lens, new):
    """One write on both sides from the same state: (port pool, port
    scales, JAX pool, JAX scales) as numpy."""
    jp, js = _jax_write(fmt)(pool, scales, tables, lens, new)
    tp, ts = torch.from_numpy(pool.copy()), torch.from_numpy(scales.copy())
    A._pool_write_quant(tp, ts, torch.from_numpy(tables), torch.from_numpy(lens),
                        torch.from_numpy(new), kvq.spec_for(fmt))
    return tp.numpy(), ts.numpy(), np.asarray(jp), np.asarray(js)


def _prefilled(fmt, seed=0):
    """Pools after a two-row, two-block prefill (bucket padding in the
    amax), each pool block 0 scratch."""
    rng = np.random.default_rng(seed)
    dt = np.int8 if fmt == "int8" else np.int16
    pool = np.zeros((N_BLOCKS, L, KH, HD), dt)
    scales = np.ones((N_BLOCKS, 1, KH, 1), np.float32)
    tables = np.array([[1, 2, 0], [3, 4, 0], [0, 0, 0], [5, 6, 0]], np.int32)
    lens = np.zeros(4, np.int32)
    new = (rng.normal(size=(4, 2 * L, KH, HD))
           * rng.uniform(0.1, 10, (4, 1, KH, 1))).astype(np.float32)
    return pool, scales, tables, lens, new


@pytest.mark.parametrize("fmt", FORMATS)
def test_pool_write_quant_prefill_bit_equal(fmt):
    pool, scales, tables, lens, new = _prefilled(fmt)
    tp, ts, jp, js = _write_both(fmt, pool, scales, tables, lens, new)
    # block 0 takes the vacant row's writes on both sides
    np.testing.assert_array_equal(tp[1:], jp[1:])
    np.testing.assert_array_equal(_bits(ts[1:]), _bits(js[1:]))
    assert (ts[1:7] != 1.0).all()


@pytest.mark.parametrize("fmt", FORMATS)
def test_pool_write_quant_decode_bit_equal(fmt):
    """One decode write per row from a prefilled state: row 0 opens a fresh
    block (lens % L == 0), row 1 appends a small element (the scale holds,
    the block's codes survive bit for bit), row 2 is vacant (all-zero
    table, scratch block 0), row 3 appends a large element (the scale
    grows and the block is re-quantized)."""
    pool, scales, tables, lens, new = _prefilled(fmt)
    tp, ts, _, _ = _write_both(fmt, pool, scales, tables, lens, new)
    pool, scales = tp, ts
    tables[0, 2] = 7
    lens = np.array([2 * L, L + 1, 0, L + 2], np.int32)
    rng = np.random.default_rng(5)
    elem = rng.normal(size=(4, 1, KH, HD)).astype(np.float32)
    elem[1] *= 1e-3
    elem[3] *= 1e3
    tp, ts, jp, js = _write_both(fmt, pool, scales, tables, lens, elem)
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(_bits(ts), _bits(js))
    # row 0: the fresh block 7 took the element's own scale
    np.testing.assert_array_equal(
        _bits(ts[7]), _bits(kvq.block_scale(torch.from_numpy(elem[0:1]),
                                            kvq.spec_for(fmt)).numpy()[0]))
    # row 1 (block 4, position 1): scale unchanged, other codes unchanged
    assert np.array_equal(ts[4], scales[4])
    keep = [0, 2, 3]
    np.testing.assert_array_equal(tp[4, keep], pool[4, keep])
    # row 3 (block 6, position 2): the scale grew, old codes shrank
    assert (ts[6] > scales[6]).all()
    assert np.abs(tp[6, :2].astype(np.int64)).sum() < \
        np.abs(pool[6, :2].astype(np.int64)).sum()


@pytest.mark.parametrize("fmt", FORMATS)
def test_pool_gather_dequant_bit_equal(fmt):
    pool, scales, tables, lens, new = _prefilled(fmt, seed=3)
    tp, ts, jp, js = _write_both(fmt, pool, scales, tables, lens, new)
    want = np.asarray(jax.jit(functools.partial(
        JA._pool_gather_dequant, spec=jkvq.spec_for(fmt)))(jp, js, tables))
    got = A._pool_gather_dequant(torch.from_numpy(tp), torch.from_numpy(ts),
                                 torch.from_numpy(tables), kvq.spec_for(fmt))
    assert got.shape == (4, 3 * L, KH, HD)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


def test_quantized_paged_cache_leaves():
    cfg = dataclasses.replace(configs.get_smoke("yi-9b"), kv_quant="q2_14")
    c = A.gqa_init_paged_cache(cfg, 2, 5, L, 3, device="cpu")
    assert c["k_pool"].dtype == torch.int16 and c["v_pool"].shape == (5, L, cfg.num_kv_heads,
                                                                     cfg.head_dim)
    assert c["k_scale_pool"].shape == (5, 1, cfg.num_kv_heads, 1)
    assert bool((c["v_scale_pool"] == 1.0).all())


# ---------------------------------------------------------------------------
# kernels/paged_attention.py: the kv_quant branch of gqa_decode
# ---------------------------------------------------------------------------
#: live lengths per row: on and off the block boundaries, one block, a
#: vacant row (0: all-zero table, k_len 1), a long row
KLENS = [1, 4, 5, 0, 13, 16, 3]


def _quant_case(fmt, G=2, seed=0):
    """Pools block-scaled and coded as the prefill write codes them."""
    spec = kvq.spec_for(fmt)
    rng = np.random.default_rng(seed)
    B = len(KLENS)
    M = max(-(-k // L) for k in KLENS)
    N = 1 + B * M
    q = rng.normal(size=(B, KH, G, HD)).astype(np.float32)
    kf = torch.from_numpy((rng.normal(size=(N, L, KH, HD)) * 3).astype(np.float32))
    vf = torch.from_numpy(rng.normal(size=(N, L, KH, HD)).astype(np.float32))
    ks, vs = kvq.block_scale(kf, spec), kvq.block_scale(vf, spec)
    kp, vp = kvq.quantize(kf, spec, ks), kvq.quantize(vf, spec, vs)
    tables = np.zeros((B, M), np.int32)
    nxt = 1
    for b, klen in enumerate(KLENS):
        for c in range(-(-klen // L)):
            tables[b, c] = nxt
            nxt += 1
    k_len = np.asarray([max(k, 1) for k in KLENS], np.int32)
    return (q, kp.numpy(), vp.numpy(), tables, k_len, ks.numpy(), vs.numpy())


@functools.lru_cache(maxsize=None)
def _decode_pair(fmt, impl, kvd):
    q, kp, vp, tables, k_len, ks, vs = _quant_case(fmt, seed=IMPLS.index(impl))
    want = np.asarray(JP.gqa_decode(
        *map(jnp.asarray, (q, kp, vp, tables, k_len)), scale=0.3,
        softmax_impl=impl, kv_dtype=getattr(jnp, kvd) if kvd else None,
        kv_quant=fmt, k_scale_pool=jnp.asarray(ks), v_scale_pool=jnp.asarray(vs),
        interpret=True))
    t = [torch.from_numpy(a) for a in (q, kp, vp, tables, k_len, ks, vs)]
    got = P.gqa_decode(*t[:5], scale=0.3, softmax_impl=impl,
                       kv_dtype=getattr(torch, kvd) if kvd else None,
                       kv_quant=fmt, k_scale_pool=t[5], v_scale_pool=t[6]).numpy()
    return got, want


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("fmt", FORMATS)
def test_gqa_decode_quant_vs_jax(fmt, impl):
    got, want = _decode_pair(fmt, impl, None)
    assert got.dtype == np.float32 and np.isfinite(got).all()
    assert np.abs(got - want).max() < ATOL, np.abs(got - want).max()
    np.testing.assert_array_equal(got.reshape(got.shape[0], -1).argmax(-1),
                                  want.reshape(want.shape[0], -1).argmax(-1))
    assert P.dot_order("gqa", 2, HD, L).mapped and P.pv_order("gqa", 2, HD, L).mapped
    if impl != "exact":
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("fmt", FORMATS)
def test_gqa_decode_quant_kv_dtype_bf16_vs_jax(fmt):
    """The kv_dtype round after the dequant (the engine's bf16 seam)."""
    got, want = _decode_pair(fmt, "cordic_pallas", "bfloat16")
    assert np.abs(got - want).max() < ATOL, np.abs(got - want).max()
    np.testing.assert_array_equal(got, want)
    plain, _ = _decode_pair(fmt, "cordic_pallas", None)
    assert np.abs(plain - got).max() > 1e-5      # the round is load-bearing


def test_gqa_decode_quant_plain_dequantizes_every_block():
    """gqa_decode_plain over codes equals gqa_decode_plain over the
    dequantized float pools, bit for bit (the branch only changes what a
    block stages)."""
    q, kp, vp, tables, k_len, ks, vs = (torch.from_numpy(a) for a in
                                        _quant_case("q2_14", seed=9))
    spec = kvq.spec_for("q2_14")
    for impl in IMPLS:
        a = P.gqa_decode_plain(q, kp, vp, tables, k_len, scale=0.3,
                               softmax_impl=impl, kv_quant="q2_14",
                               k_scale_pool=ks, v_scale_pool=vs)
        b = P.gqa_decode_plain(q, kvq.dequantize(kp, spec, ks),
                               kvq.dequantize(vp, spec, vs), tables, k_len,
                               scale=0.3, softmax_impl=impl)
        assert torch.equal(a, b), impl


def test_gqa_decode_quant_requires_scale_pools():
    """kv_quant and the scale pools come together, checked before the
    kv_dtype resolution (JAX's test of the same name)."""
    q, kp, vp, tables, k_len, ks, vs = (torch.from_numpy(a) for a in
                                        _quant_case("int8"))
    with pytest.raises(ValueError, match="scale"):
        P.gqa_decode(q, kp, vp, tables, k_len, scale=0.3, kv_quant="int8")
    with pytest.raises(ValueError, match="scale"):
        P.gqa_decode(q, kp, vp, tables, k_len, scale=0.3, k_scale_pool=ks,
                     v_scale_pool=vs)
    with pytest.raises(ValueError, match="int8"):
        P.gqa_decode(q, kp, vp, tables, k_len, scale=0.3, kv_quant="int4",
                     k_scale_pool=ks, v_scale_pool=vs)


# ---------------------------------------------------------------------------
# The engine: Yi smoke config on int8 / q2_14 pools
# ---------------------------------------------------------------------------
ENGINE_KW = dict(slots=2, max_len=64, kv_impl="paged")


def _prompts(vocab, n=3, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, int(rng.integers(4, 12))).astype(np.int32)
            for _ in range(n)]


@functools.lru_cache(maxsize=None)
def _yi_params(act_impl):
    return JT.init(jconfigs.get_smoke("yi-9b", act_impl=act_impl),
                   jax.random.PRNGKey(0))


@pytest.mark.parametrize("attend", ["pallas", "gather"])
@pytest.mark.parametrize("fmt", FORMATS)
def test_engine_tokens_identical_to_jax_engine(fmt, attend):
    """Yi smoke config, 3 requests through 2 slots, 6 new tokens each; the
    decode kernel's quantized branch (plain version) or the dequantizing
    gather against the JAX engine (its Pallas kernel in interpret mode)."""
    kw = dict(ENGINE_KW, paged_attend_impl=attend, kv_quant=fmt,
              softmax_impl="cordic_pallas")
    jcfg = jconfigs.get_smoke("yi-9b", act_impl="exact")
    cfg = configs.get_smoke("yi-9b", act_impl="exact")
    jparams = _yi_params("exact")
    prompts = _prompts(cfg.vocab_size)
    jeng = JE.ServeEngine(jcfg, jparams, **kw)
    for i, p in enumerate(prompts):
        jeng.submit(JE.Request(rid=i, prompt=p, max_new_tokens=6))
    want = {r.rid: r.out for r in jeng.run()}

    model = T.load_jax_params(cfg, T.flatten_params(jparams), device="cpu")
    eng = E.ServeEngine(cfg, model, device="cpu", **kw)
    assert eng.kv_quant == fmt and eng._kv_quant_spec.name == fmt
    assert eng.kv_pool_bytes() == jeng.kv_pool_bytes()
    for i, p in enumerate(prompts):
        eng.submit(E.Request(rid=i, prompt=p, max_new_tokens=6))
    got = {r.rid: r.out for r in eng.run()}
    assert got == want
    assert all(len(v) == 6 for v in got.values())
    assert eng.pager.blocks_in_use == 0


def test_engine_pool_bytes_count_codes_and_scales():
    cfg = configs.get_smoke("yi-9b", act_impl="exact")
    model = T.init(cfg, device="cpu")
    nb = ENGINE_KW["slots"] * ENGINE_KW["max_len"] // 16 + 1
    per_pos = cfg.num_layers * 2 * cfg.num_kv_heads * cfg.head_dim
    scale_bytes = cfg.num_layers * 2 * nb * cfg.num_kv_heads * 4
    for fmt, width in (("none", 4), ("int8", 1), ("q2_14", 2)):
        eng = E.ServeEngine(cfg, model, device="cpu", kv_quant=fmt, **ENGINE_KW)
        want = nb * 16 * per_pos * width + (0 if fmt == "none" else scale_bytes)
        assert eng.kv_pool_bytes() == want, fmt
        assert eng.pager.block_bytes == want // nb


#: the JAX bench's kv_quant trace (benchmarks/serving.py: _cfg(smoke=True),
#: _requests, _kvq_serve): 8 requests of 8 tokens, 8 new tokens each, 4
#: slots, max_len 64, greedy, gather attend
BENCH = dict(name="serve-bench-smoke", family="dense", num_layers=2,
             d_model=128, num_heads=4, num_kv_heads=2, d_ff=384,
             vocab_size=1024, act_impl="exact", rope_theta=1e4,
             dtype="float32")


def _bench_requests(vocab, make):
    rng = np.random.default_rng(0)
    return [make(rid=i, prompt=rng.integers(0, vocab, 8).astype(np.int32),
                 max_new_tokens=8) for i in range(8)]


def _bench_serve(eng, make):
    reqs = _bench_requests(BENCH["vocab_size"], make)
    for r in reqs:
        eng.submit(r)
    eng.run()
    return [list(map(int, r.out)) for r in reqs], eng.kv_pool_bytes()


def _match_rate(base, toks):
    matched = sum(a == b for s1, s2 in zip(base, toks) for a, b in zip(s1, s2))
    return matched / sum(len(t) for t in base)


def test_bench_kv_quant_trace_reproduced():
    """The JAX bench's kv_quant section through the port, with the JAX
    model's weights: match rates against the unquantized stream and pool
    bytes equal to the JAX engine's on the same trace (BENCH_serving.json
    records 0.875 / 1.0 and 278528 / 70176 / 139808 bytes)."""
    jcfg, cfg = JModelConfig(**BENCH), ModelConfig(**BENCH)
    jparams = JT.init(jcfg, jax.random.PRNGKey(0))
    model = T.load_jax_params(cfg, T.flatten_params(jparams), device="cpu")
    kw = dict(slots=4, max_len=64, kv_impl="paged", paged_attend_impl="gather")
    out = {}
    for fmt in ("none",) + FORMATS:
        jeng = JE.ServeEngine(jcfg, jparams, seed=0, kv_quant=fmt,
                              sampling=JSamplingParams(greedy=True), **kw)
        eng = E.ServeEngine(cfg, model, device="cpu", kv_quant=fmt, **kw)
        out[fmt] = (_bench_serve(jeng, JE.Request), _bench_serve(eng, E.Request))
    assert [out[f][1][1] for f in out] == [278528, 70176, 139808]
    for fmt in out:
        (jt, jb), (tt, tb) = out[fmt]
        assert tb == jb and tt == jt, fmt
    for fmt in FORMATS:
        assert _match_rate(out["none"][1][0], out[fmt][1][0]) == \
            _match_rate(out["none"][0][0], out[fmt][0][0])


def test_launcher_serves_kv_quant_on_the_cpu(capsys):
    from repro_torch.launch import serve as launch

    assert launch.main(["--arch", "yi-9b", "--smoke", "--device", "cpu",
                        "--requests", "3", "--slots", "2", "--max-new", "4",
                        "--max-len", "64", "--kv-quant", "int8"]) == 0
    out = capsys.readouterr().out
    assert "kv_quant=int8" in out and "3 requests, 12 tokens" in out
