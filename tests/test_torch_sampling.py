"""The port's Threefry random numbers, XLA:CPU's float32 log and the
sampler against ``jax.random`` and ``repro.serve.sampling``, bit for bit.

Keys come from seeds {0, 1, 2^31-1} folded with request ids {0, 7,
2^32-1} and steps {0, 1, 15}; draws at shapes (1,), (7,), (512,) and
(64000,). The log and the Gumbel transform are held to jitted ``jnp.log``
on every float32 value the uniform can take.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.serve import sampling as jsp  # noqa: E402
from repro_torch.core import numerics as nx  # noqa: E402
from repro_torch.serve import prng  # noqa: E402
from repro_torch.serve import sampling as sp  # noqa: E402

SEEDS = (0, 1, 2 ** 31 - 1)
RIDS = (0, 7, 2 ** 32 - 1)
STEPS = (0, 1, 15)
SHAPES = ((1,), (7,), (512,), (64000,))


def _bits(a) -> np.ndarray:
    """A float32 or uint32 array's words as int64, for exact comparison."""
    a = np.asarray(a)
    if a.dtype == np.float32:
        a = a.view(np.uint32)
    return a.astype(np.int64)


def _all_uniform_draws() -> np.ndarray:
    """Every float32 the uniform on [tiny, 1) can return: k 2^-23 for
    k = 1 .. 2^23 - 1, and tiny (the draw k = 0 floored)."""
    k = np.arange(1, 2 ** 23, dtype=np.float64)
    return np.concatenate([(k * 2.0 ** -23).astype(np.float32),
                           np.array([np.finfo(np.float32).tiny], np.float32)])


def _keys():
    """The 27 keys (seed, rid, step), JAX's stacked and the port's (27, 2)."""
    jk, tk = [], []
    for seed in SEEDS:
        base, tbase = jax.random.PRNGKey(seed), prng.threefry_seed(seed)
        assert np.array_equal(_bits(base), tbase.numpy())
        for rid in RIDS:
            jr, tr = jax.random.fold_in(base, rid), prng.fold_in(tbase, rid)
            assert np.array_equal(_bits(jr), tr.numpy())
            for step in STEPS:
                jk.append(jsp.request_key(base, rid, step))
                tk.append(sp.request_key(tbase, rid, step))
                assert np.array_equal(_bits(jax.random.fold_in(jr, step)),
                                      prng.fold_in(tr, step).numpy())
    return jnp.stack(jk), torch.stack(tk)


def test_seed_and_fold_in_keys_equal_jax_random():
    jk, tk = _keys()
    assert tk.shape == (27, 2)
    assert np.array_equal(_bits(jk), tk.numpy())


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_bits_uniform_gumbel_equal_jax_random(shape):
    """Each key's draws (the port's from the (27, 2) keys at once, JAX's
    per key through vmap; the first key also without it)."""
    jk, tk = _keys()
    for name, jfn, tfn in (("bits", jax.random.bits, prng.random_bits),
                           ("uniform", jax.random.uniform, prng.uniform),
                           ("gumbel", jax.random.gumbel, prng.gumbel)):
        want = jax.vmap(lambda k: jfn(k, shape))(jk)
        got = tfn(tk, shape).numpy()
        assert got.shape == (27,) + shape
        assert np.array_equal(_bits(want), _bits(got)), name
        assert np.array_equal(_bits(jfn(jk[0], shape)), _bits(got[0])), name


def test_batched_keys_draw_each_rows_stream():
    """(B, 2) keys draw (B, *shape), row b equal to key b's own draw, as
    jax.vmap over the keys; request_key takes (B,) rids and steps."""
    tbase = prng.threefry_seed(0)
    rids = torch.tensor([0, 7, 2 ** 32 - 1, 3])
    steps = torch.tensor([15, 0, 1, 2])
    keys = sp.request_key(tbase, rids, steps)
    noise = prng.gumbel(keys, (512,))
    for b in range(4):
        jk = jsp.request_key(jax.random.PRNGKey(0), int(rids[b]), int(steps[b]))
        assert np.array_equal(_bits(jk), keys[b].numpy())
        assert np.array_equal(_bits(jax.random.gumbel(jk, (512,))),
                              _bits(noise[b].numpy()))


def test_xla_log_equals_jitted_jnp_log_on_every_uniform_draw():
    u = _all_uniform_draws()
    want = np.asarray(jax.jit(jnp.log)(u))
    got = nx.xla_log_f32(torch.from_numpy(u)).numpy()
    assert np.array_equal(_bits(want), _bits(got))
    # torch's own log is not that function: the reason for the polynomial
    assert not np.array_equal(_bits(torch.log(torch.from_numpy(u)).numpy()),
                              _bits(want))


def test_xla_log_special_values_and_wide_range():
    x = np.array([0.0, -0.0, 1e-40, -2.0, np.inf, 1.0, 2.0, 3e38,
                  np.finfo(np.float32).tiny], np.float32)
    want = np.asarray(jax.jit(jnp.log)(x))
    got = nx.xla_log_f32(torch.from_numpy(x)).numpy()
    nan = np.isnan(want)
    assert np.array_equal(nan, np.isnan(got))
    assert np.array_equal(_bits(want[~nan]), _bits(got[~nan]))
    r = np.random.default_rng(0).uniform(-80, 80, 1 << 18).astype(np.float32)
    r = np.exp(r).astype(np.float32)
    assert np.array_equal(_bits(jax.jit(jnp.log)(r)),
                          _bits(nx.xla_log_f32(torch.from_numpy(r)).numpy()))


def test_gumbel_transform_equals_jitted_jax_on_every_uniform_draw():
    u = _all_uniform_draws()
    want = np.asarray(jax.jit(lambda v: -jnp.log(-jnp.log(v)))(u))
    t = torch.from_numpy(u)
    got = (-nx.xla_log_f32(-nx.xla_log_f32(t))).numpy()
    assert np.array_equal(_bits(want), _bits(got))


def _batch(vocab: int, seed: int = 0):
    """Six rows mixing greedy, temperatures {0.5, 2.5} and top_k {0, 8},
    each with its own (rid, step) key."""
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((6, vocab)) * 3).astype(np.float32)
    logits[2, :40] = logits[2, 0]                  # ties at the top-k edge
    temps = np.array([1.0, 0.5, 2.5, 0.5, 2.5, 2.5], np.float32)
    top_ks = np.array([0, 0, 8, 8, 0, 8], np.int32)
    greedy = np.array([True, False, False, False, False, True])
    rids = np.array([0, 7, 3, 2 ** 31 - 1, 5, 1], np.int64)
    steps = np.array([0, 1, 15, 3, 2, 9], np.int64)
    return logits, temps, top_ks, greedy, rids, steps


@pytest.mark.parametrize("vocab", [512, 64000])
def test_sample_batched_tokens_equal_jax(vocab):
    logits, temps, top_ks, greedy, rids, steps = _batch(vocab)
    base = jax.random.PRNGKey(0)
    jkeys = jax.vmap(lambda r, t: jsp.request_key(base, r, t))(
        jnp.asarray(rids.astype(np.uint32)), jnp.asarray(steps, jnp.int32))
    want = np.asarray(jax.jit(jsp.sample_batched)(logits, jkeys, temps, top_ks,
                                                  greedy))
    keys = sp.request_key(prng.threefry_seed(0), torch.from_numpy(rids),
                          torch.from_numpy(steps))
    got = sp.sample_batched(torch.from_numpy(logits), keys,
                            torch.from_numpy(temps), torch.from_numpy(top_ks),
                            torch.from_numpy(greedy)).numpy()
    assert got.dtype == np.int32
    assert np.array_equal(want, got)
    # greedy rows take the raw logits' argmax
    assert np.array_equal(got[greedy], logits[greedy].argmax(-1))
    # each row alone draws what it draws in the batch
    for b in range(6):
        one = sp.sample_one(torch.from_numpy(logits[b]), keys[b], float(temps[b]),
                            int(top_ks[b]), bool(greedy[b]))
        assert one == got[b]


def test_temperature_and_top_k_pieces_equal_jax():
    logits, temps, top_ks, *_ = _batch(512, seed=1)
    want = np.asarray(jax.jit(jax.vmap(jsp.scale_by_temperature))(logits, temps))
    got = sp.scale_by_temperature(torch.from_numpy(logits),
                                  torch.from_numpy(temps)).numpy()
    assert np.array_equal(_bits(want), _bits(got))
    jm = np.asarray(jax.jit(jax.vmap(jsp.top_k_mask))(want, top_ks))
    tm = sp.top_k_mask(torch.from_numpy(got), torch.from_numpy(top_ks)).numpy()
    assert np.array_equal(_bits(jm), _bits(tm))
    assert (tm[2] > sp.NEG_INF).sum() >= 8
    ex = np.asarray(jax.vmap(lambda l, t: jsp.scale_by_temperature(
        l, t, "exact"))(logits, temps))
    assert np.array_equal(_bits(ex), _bits(sp.scale_by_temperature(
        torch.from_numpy(logits), torch.from_numpy(temps), "exact").numpy()))


def test_sampling_params_resolve_as_jax():
    for kw in (dict(), dict(temperature=0.0), dict(temperature=-1.0, top_k=3),
               dict(temperature=0.8, top_k=40), dict(greedy=True, temperature=2.0)):
        assert sp.SamplingParams(**kw).resolved() == jsp.SamplingParams(**kw).resolved()
