"""The port's radix prefix cache (``serve/prefix_cache.py``, a copy of the
JAX module) and the engine's prefix-sharing admission against the JAX
package.

The tree cases of tests/test_prefix_cache.py run on both copies (the JAX
module and the port's, each over its own pager). The engine cases hold
cache-on tokens to cache-off tokens and to the JAX engine with the cache
on, float32 and int8 pools, GQA and MLA, chunked and not (the JAX engine's
acceptance bar), and check that a shared block's bytes never change while
a sibling request prefills and decodes through it.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serve import engine as JE  # noqa: E402
from repro.serve import kv_pager as jkvp  # noqa: E402
from repro.serve import prefix_cache as jpc  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import common as cm  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serve import engine as E  # noqa: E402
from repro_torch.serve import kv_pager as kvp  # noqa: E402
from repro_torch.serve import prefix_cache as pc  # noqa: E402

MODS = pytest.mark.parametrize("mods", [(jpc, jkvp), (pc, kvp)],
                               ids=["jax", "torch"])


def _pager_and_cache(mods, num_blocks=32, block_len=4, policy="lru"):
    cache_mod, pager_mod = mods
    p = pager_mod.KVPager(num_blocks=num_blocks, block_len=block_len, slots=8)
    return p, cache_mod.PrefixCache(p, block_len, policy=policy)


def _toks(*vals):
    return np.asarray(vals, np.int32)


# ---------------------------------------------------------------------------
# Radix index: insert / match / split at block granularity
# ---------------------------------------------------------------------------
@MODS
def test_match_on_empty_cache_is_miss(mods):
    _, c = _pager_and_cache(mods)
    assert c.match(_toks(*range(12))) == []
    assert c.hits == 0


@MODS
def test_insert_then_match_at_block_granularity(mods):
    p, c = _pager_and_cache(mods, block_len=4)
    toks = _toks(*range(11))                 # 2 full blocks + partial
    blocks = p.alloc(0, 3)
    assert c.insert(toks, blocks) == 2       # only full prompt blocks
    assert p.refcount(blocks[0]) == 2        # slot + cache
    assert p.refcount(blocks[2]) == 1        # partial block never indexed
    got = c.match(toks)                      # cap (11-1)//4 = 2
    assert got == blocks[:2]
    assert p.refcount(blocks[0]) == 3        # match pinned it for the caller
    p.release(got)


@MODS
def test_match_cap_leaves_one_token_to_prefill(mods):
    p, c = _pager_and_cache(mods, block_len=4)
    toks = _toks(*range(8))                  # exactly 2 blocks
    c.insert(toks, p.alloc(0, 2))
    got = c.match(toks)
    assert len(got) == 1                     # (8-1)//4 = 1, never 2
    p.release(got)


@MODS
def test_match_stops_at_divergence_and_partial_edge(mods):
    p, c = _pager_and_cache(mods, block_len=2)
    blocks = p.alloc(0, 3)
    c.insert(_toks(1, 2, 3, 4, 5, 6), blocks)
    got = c.match(_toks(1, 2, 9, 9, 5, 6, 7))
    assert got == blocks[:1]
    p.release(got)


@MODS
def test_insert_splits_edge_on_divergence(mods):
    p, c = _pager_and_cache(mods, block_len=2)
    a = p.alloc(0, 3)
    c.insert(_toks(1, 2, 3, 4, 5, 6), a)
    b = p.alloc(1, 3)
    assert c.insert(_toks(1, 2, 7, 8, 9, 10), b) == 2   # suffix only
    assert p.refcount(a[0]) == 2
    assert p.refcount(b[0]) == 1            # duplicate of a[0]: not indexed
    ga = c.match(_toks(1, 2, 3, 4, 5, 6, 99))
    gb = c.match(_toks(1, 2, 7, 8, 9, 10, 99))
    assert ga == a and gb == [a[0]] + b[1:]
    p.release(ga)
    p.release(gb)


@MODS
def test_insert_duplicate_keeps_incumbent_blocks(mods):
    p, c = _pager_and_cache(mods, block_len=4)
    toks = _toks(*range(9))
    a = p.alloc(0, 2)
    assert c.insert(toks, a) == 2
    b = p.alloc(1, 2)
    assert c.insert(toks, b) == 0           # incumbent wins, no new pins
    assert p.refcount(b[0]) == 1
    got = c.match(toks)
    assert got == a[:2]
    p.release(got)


# ---------------------------------------------------------------------------
# Eviction
# ---------------------------------------------------------------------------
@MODS
def test_evict_lru_order_and_live_blocks_survive(mods):
    p, c = _pager_and_cache(mods, num_blocks=9, block_len=2)
    a = p.alloc(0, 2)
    c.insert(_toks(1, 2, 3, 4), a)
    b = p.alloc(1, 2)
    c.insert(_toks(9, 8, 7, 6), b)
    p.free(0)
    p.free(1)
    got = c.match(_toks(9, 8, 7, 6, 0))     # touch b: a becomes LRU victim
    p.release(got)
    assert c.evict_until(6)
    assert p.blocks_free >= 6
    assert p.refcount(a[0]) == 0
    assert p.refcount(b[0]) == 1


@MODS
def test_evict_fifo_order(mods):
    p, c = _pager_and_cache(mods, num_blocks=9, block_len=2, policy="fifo")
    a = p.alloc(0, 2)
    c.insert(_toks(1, 2, 3, 4), a)
    b = p.alloc(1, 2)
    c.insert(_toks(9, 8, 7, 6), b)
    p.free(0)
    p.free(1)
    got = c.match(_toks(1, 2, 3, 4, 0))     # touching a does NOT save it
    p.release(got)
    assert c.evict_until(6)
    assert p.refcount(a[0]) == 0            # oldest-inserted evicted first
    assert p.refcount(b[0]) == 1


@MODS
def test_evict_never_touches_slot_bound_blocks(mods):
    p, c = _pager_and_cache(mods, num_blocks=5, block_len=2)
    a = p.alloc(0, 2)
    c.insert(_toks(1, 2, 3, 4), a)          # slot 0 alive: refcounts 2
    assert not c.evict_until(4)             # nothing evictable
    assert p.refcount(a[0]) == 2
    p.free(0)                               # cache-only now
    assert c.evict_until(4)
    assert p.blocks_free == 4


@MODS
def test_evicted_prefix_no_longer_matches(mods):
    p, c = _pager_and_cache(mods, num_blocks=5, block_len=2)
    a = p.alloc(0, 2)
    c.insert(_toks(1, 2, 3, 4), a)
    p.free(0)
    assert c.evict_until(4)
    assert c.match(_toks(1, 2, 3, 4, 5)) == []


@MODS
def test_unknown_policy_and_block_len_mismatch_raise(mods):
    cache_mod, pager_mod = mods
    p = pager_mod.KVPager(num_blocks=4, block_len=4, slots=1)
    with pytest.raises(ValueError, match="eviction policy"):
        cache_mod.PrefixCache(p, 4, policy="random")
    with pytest.raises(ValueError, match="block_len"):
        cache_mod.PrefixCache(p, 8)


# ---------------------------------------------------------------------------
# The engine: prefix-sharing admission
# ---------------------------------------------------------------------------
KW = dict(max_len=64, kv_impl="paged", softmax_impl="cordic_pallas")


@functools.lru_cache(maxsize=None)
def _yi():
    jcfg = jconfigs.get_smoke("yi-9b", act_impl="exact")
    cfg = configs.get_smoke("yi-9b", act_impl="exact")
    jparams = JT.init(jcfg, jax.random.PRNGKey(3))
    return jcfg, cfg, jparams, T.load_jax_params(cfg, T.flatten_params(jparams),
                                                 device="cpu")


def _wave(vocab, make, seed=5, shared_len=32, tails=(3, 7, 5, 11)):
    """A prime request of the shared prompt (2 blocks), then requests of
    that prompt plus a tail."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, vocab, shared_len).astype(np.int32)
    prime = make(rid=0, prompt=shared.copy(), max_new_tokens=4)
    rest = [make(rid=1 + i, prompt=np.concatenate(
        [shared, rng.integers(0, vocab, t).astype(np.int32)]), max_new_tokens=4)
        for i, t in enumerate(tails)]
    return prime, rest


def _serve_wave(eng, make, vocab):
    """Serve the prime to completion first (its blocks are then indexed),
    then the wave; returns (token streams, engine)."""
    prime, rest = _wave(vocab, make)
    eng.submit(prime)
    eng.run()
    for r in rest:
        eng.submit(r)
    eng.run()
    return [r.out for r in [prime] + rest], eng


@pytest.mark.parametrize("kv_quant,attend", [("none", "pallas"),
                                             ("int8", "pallas"),
                                             ("none", "gather")])
def test_prefix_cache_tokens_equal_cache_off_and_jax(kv_quant, attend):
    """Cache on against cache off in the port, and against the JAX engine
    with the cache on; the shared blocks carry codes and scales under
    int8 (the quantized variant of tests/test_kv_quant.py's
    test_engine_quant_with_prefix_cache_identical)."""
    jcfg, cfg, jparams, model = _yi()
    kw = dict(KW, slots=3, kv_quant=kv_quant, paged_attend_impl=attend)
    want, jeng = _serve_wave(JE.ServeEngine(jcfg, jparams, prefix_cache=True, **kw),
                             JE.Request, cfg.vocab_size)
    off, _ = _serve_wave(E.ServeEngine(cfg, model, device="cpu", **kw),
                         E.Request, cfg.vocab_size)
    on, eng = _serve_wave(E.ServeEngine(cfg, model, device="cpu",
                                        prefix_cache=True, **kw),
                          E.Request, cfg.vocab_size)
    assert on == off == want
    assert eng.prefix.hits == jeng.prefix.hits > 0
    assert eng.prefix.hit_blocks == jeng.prefix.hit_blocks
    assert eng.prefix_hit_tokens == 4 * 32        # the prime's 2 blocks each
    assert eng.pager.blocks_in_use == eng.prefix.num_blocks


def test_prefix_hits_skip_prefill_tokens():
    _, cfg, _, model = _yi()
    kw = dict(KW, slots=3)
    _, off = _serve_wave(E.ServeEngine(cfg, model, device="cpu", **kw),
                         E.Request, cfg.vocab_size)
    _, on = _serve_wave(E.ServeEngine(cfg, model, device="cpu",
                                      prefix_cache=True, **kw),
                        E.Request, cfg.vocab_size)
    assert off.prefix is None and off.prefix_hit_tokens == 0
    # the prime's prefill (32) and four 64-wide buckets against four tails
    # resumed at 32: 16-wide buckets
    assert off.prefill_tokens == 32 + 4 * 64
    assert on.prefill_tokens == 32 + 4 * 16


def test_cow_shared_block_bytes_never_mutate():
    """While a sibling prefills and decodes through a shared prefix, the
    shared blocks' codes and scales stay bit-identical (int8 pools)."""
    _, cfg, _, model = _yi()
    rng = np.random.default_rng(2)
    shared = rng.integers(0, cfg.vocab_size, 24).astype(np.int32)
    a = E.Request(rid=0, prompt=np.concatenate(
        [shared, rng.integers(0, cfg.vocab_size, 3).astype(np.int32)]),
        max_new_tokens=12)
    eng = E.ServeEngine(cfg, model, device="cpu", slots=2, block_len=8,
                        prefix_cache=True, kv_quant="int8",
                        **{k: v for k, v in KW.items()})
    eng.submit(a)
    eng.step()                              # a prefilled and indexed
    blocks = torch.tensor([int(x) for x in eng.pager.owned(0)[:3]])

    def pools():
        return [t[blocks].clone() for layer in eng._caches.layers
                for k, t in layer.items() if k.endswith("_pool")]

    before = pools()
    b = E.Request(rid=1, prompt=np.concatenate(
        [shared, rng.integers(0, cfg.vocab_size, 7).astype(np.int32)]),
        max_new_tokens=12)
    eng.submit(b)
    for _ in range(6):
        eng.step()                          # b resumes through the prefix
    assert len(b.out) >= 1 and eng.prefix.hit_blocks >= 3
    assert eng.pager.blocks_shared >= 3
    for x, y in zip(before, pools()):
        assert torch.equal(x, y)
    eng.run()
    assert a.done and b.done


def test_eviction_under_pressure_keeps_serving():
    """One slot and 4 allocatable blocks: prompt A, A + tail (a hit), then
    prompt B, whose 3 blocks need A's cached blocks evicted, then B + tail
    (a hit). Tokens equal the cache-off run's."""
    _, cfg, _, model = _yi()
    rng = np.random.default_rng(8)
    a, b = (rng.integers(0, cfg.vocab_size, 32).astype(np.int32) for _ in range(2))
    tail = rng.integers(0, cfg.vocab_size, 5).astype(np.int32)
    prompts = [a, np.concatenate([a, tail]), b, np.concatenate([b, tail])]

    def serve(prefix_cache):
        eng = E.ServeEngine(cfg, model, device="cpu", slots=1, num_blocks=5,
                            prefix_cache=prefix_cache, **KW)
        reqs = [E.Request(rid=i, prompt=p, max_new_tokens=4)
                for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        eng.run()
        return [r.out for r in reqs], eng

    off, _ = serve(False)
    on, eng = serve(True)
    assert on == off and all(len(o) == 4 for o in on)
    assert eng.prefix.hits == 2 and eng.prefix.evicted_blocks == 2


def test_launcher_serves_prefix_cache_on_the_cpu(capsys):
    from repro_torch.launch import serve as launch

    assert launch.main(["--arch", "yi-9b", "--smoke", "--device", "cpu",
                        "--requests", "4", "--slots", "2", "--max-new", "4",
                        "--max-len", "64", "--kv-quant", "int8",
                        "--prefix-cache"]) == 0
    out = capsys.readouterr().out
    assert "4 requests, 16 tokens" in out
    assert "prefix cache (lru): 2 hits / 4 blocks reused" in out


# ---------------------------------------------------------------------------
# Whole-row, multi-row prefill under the cache (ROADMAP B.10)
# ---------------------------------------------------------------------------
def test_prefill_pieces_only_with_the_prefix_cache(monkeypatch):
    """The block-wide pieces are gone: cache on or off, a prompt prefills in
    one apply at its bucket width, chunked rows pack several to a dispatch
    under the cache too, and the paged prefill's view runs the invariant
    products on a model without MoE layers (torch's on an MoE one, whose
    routing follows the dispatch width as in JAX)."""
    _, cfg, _, model = _yi()
    shapes, views = [], []
    apply, view = T.apply, T.PagedCache.view
    monkeypatch.setattr(E.tf, "apply", lambda p, b, *a, **k: (
        shapes.append(tuple(b["tokens"].shape)), apply(p, b, *a, **k))[1])
    monkeypatch.setattr(T.PagedCache, "view", lambda self, *a: (
        views.append(a[2]), view(self, *a))[1])
    prompt = np.arange(37, dtype=np.int32)
    for prefix_cache in (True, False):
        eng = E.ServeEngine(cfg, model, device="cpu", slots=1,
                            prefix_cache=prefix_cache, **KW)
        eng.submit(E.Request(rid=0, prompt=prompt, max_new_tokens=1))
        shapes.clear()
        eng.run()
        assert shapes == [(1, 64)]
        assert not hasattr(eng, "prefill_piece")
    assert views and all(v is cm.INVARIANT for v in views)
    # chunked under the cache: three requests resuming behind a primed
    # 32-token prefix ride one dispatch, and emit cache off's tokens
    prime = np.arange(32, dtype=np.int32)
    wave = [np.concatenate([prime, np.arange(5 + i, dtype=np.int32)]) for i in range(3)]
    outs = {}
    for prefix_cache in (True, False):
        eng = E.ServeEngine(cfg, model, device="cpu", slots=4, prefill_chunk=16,
                            prefix_cache=prefix_cache, **KW)
        assert eng.prefill_batch == 4
        eng.submit(E.Request(rid=0, prompt=prime, max_new_tokens=1))
        eng.run()
        reqs = [E.Request(rid=1 + i, prompt=p, max_new_tokens=3) for i, p in enumerate(wave)]
        for r in reqs:
            eng.submit(r)
        shapes.clear()
        eng.run()
        outs[prefix_cache] = [r.out for r in reqs]
        if prefix_cache:
            assert shapes[0] == (4, 16) and eng.prefix_hit_tokens == 3 * 32
    assert outs[True] == outs[False]
    ds = configs.get_smoke("deepseek-v2-lite-16b")
    eng = E.ServeEngine(ds, T.init(ds, seed=0, device="cpu"), device="cpu",
                        slots=1, prefix_cache=True, **KW)
    views.clear()
    eng.submit(E.Request(rid=0, prompt=prompt, max_new_tokens=1))
    eng.run()
    assert views == [cm.LIBRARY]                 # MoE capacity


def _mixed(vocab, make, sampling, seed=7, shared_len=24):
    """The JAX bar's requests (tests/test_prefix_cache.py ``_mk_reqs``):
    two shared system prompts, unique tails, greedy and sampled rows."""
    rng = np.random.default_rng(seed)
    sys_prompts = [rng.integers(0, vocab, shared_len) for _ in range(2)]
    kinds = [sampling(greedy=True), sampling(temperature=2.5),
             sampling(temperature=1.5, top_k=8), None]
    return [make(rid=i, prompt=np.concatenate(
        [sys_prompts[i % 2], rng.integers(0, vocab, t)]).astype(np.int32),
        max_new_tokens=5, sampling=kinds[i % len(kinds)])
        for i, t in enumerate([5, 11, 2, 8, 15, 4])]


@functools.lru_cache(maxsize=None)
def _mla_dense():
    """DeepSeek-V2-Lite's smoke config with MLA and the dense FFN in every
    block (the JAX bar's MLA model, no MoE layer), JAX weights and the
    port's through the bridge."""
    import dataclasses

    jcfg, cfg = (c.get_smoke("deepseek-v2-lite-16b", act_impl="exact")
                 for c in (jconfigs, configs))
    jcfg, cfg = (dataclasses.replace(c, block_pattern=("mla_dense",) * c.num_layers)
                 for c in (jcfg, cfg))
    jparams = JT.init(jcfg, jax.random.PRNGKey(3))
    return jcfg, cfg, jparams, T.load_jax_params(cfg, T.flatten_params(jparams),
                                                 device="cpu")


@pytest.mark.parametrize("arch", ["yi-9b", "deepseek-v2-lite-16b"])
@pytest.mark.parametrize("chunk", [None, 16])
def test_prefix_cache_bit_identical(arch, chunk):
    """The JAX engine's acceptance bar (tests/test_prefix_cache.py
    ``test_prefix_cache_bit_identical``) on the port: cache-on streams equal
    cache-off ones and the JAX engine's, GQA and MLA (dense FFN), chunked
    (``prefill_batch`` at its default, several rows a dispatch) and not,
    greedy and sampled rows, while hitting."""
    from repro.serve.sampling import SamplingParams as JSP
    from repro_torch.serve.sampling import SamplingParams

    jcfg, cfg, jparams, model = _yi() if arch == "yi-9b" else _mla_dense()
    kw = dict(KW, slots=3, prefill_chunk=chunk)
    jeng = JE.ServeEngine(jcfg, jparams, prefix_cache=True, **kw)
    want = _mixed(cfg.vocab_size, JE.Request, JSP)
    for r in want:
        jeng.submit(r)
    jeng.run()
    streams = {}
    for on in (False, True):
        eng = E.ServeEngine(cfg, model, device="cpu", prefix_cache=on, **kw)
        reqs = _mixed(cfg.vocab_size, E.Request, SamplingParams)
        for r in reqs:
            eng.submit(r)
        eng.run()
        streams[on] = [r.out for r in reqs]
    assert streams[True] == streams[False] == [r.out for r in want]
    assert eng.prefix.hits == jeng.prefix.hits >= 1
    assert eng.prefix.hit_blocks == jeng.prefix.hit_blocks >= 1
    assert eng.prefill_batch == (3 if chunk else 1)


def test_resumed_prefill_writes_the_bytes_of_a_whole_one():
    """A 48-token prompt's third block (int8 codes and scales) and first
    token are the same whether its prefill ran from position 0 or resumed
    at 32 behind a shared two-block prefix."""
    _, cfg, _, model = _yi()
    prompt = np.random.default_rng(4).integers(
        0, cfg.vocab_size, 48).astype(np.int32)
    out = []
    for prime in (False, True):
        eng = E.ServeEngine(cfg, model, device="cpu", slots=1,
                            prefix_cache=True, kv_quant="int8", **KW)
        if prime:
            eng.submit(E.Request(rid=0, prompt=prompt[:32].copy(),
                                 max_new_tokens=1))
            eng.run()
        req = E.Request(rid=1, prompt=prompt, max_new_tokens=3)
        eng.submit(req)
        eng.step()                      # the prefill and one decode (block 3)
        blk = int(eng._slot_rows[0][2])
        out.append((req.out[0], [t[blk].clone() for layer in eng._caches.layers
                                 for k, t in layer.items() if k.endswith("_pool")]))
        assert eng.prefix_hit_tokens == (32 if prime else 0)
    assert out[0][0] == out[1][0]
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)
