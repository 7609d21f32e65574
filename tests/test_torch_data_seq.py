"""The data axes' position cut of the dense caches (ROADMAP A.17b).

A batch the data axes do not divide (long_500k's one row) is whole on every
data rank, and under the heads cut its dense caches' positions are cut over
the data axes, the JAX default ``cache_spec`` (``kv_shard`` resolved to
"seq_data", models/attention.py): data rank d holds the positions [d T/dp,
(d+1) T/dp) of its model rank's KV heads, and the split softmax and the P.V
partial are reduced over the data group.

Greedy decoding (launch/dryrun.py ``rank_decode``: the dry run's
``prefill_step`` and ``decode_step``) of the smoke Yi-9B (one KV head, on
the CORDIC softmax's plain versions: the split window sums), DeepSeek-V2-Lite
(MLA, the absorbed decode) and Zamba2 (the shared block) with batch 1, on host
meshes (2, 1) and (2, 2), one rank group each, spawned once for the module
with every arch's job, against one rank's tokens and the JAX model's
(a prefill into its dense cache, then single-token steps). Each rank's attention buffers hold 1/dp of the positions of its
model rank's share of the heads, and its step books the data group's
collectives. The knob's resolution rules close the file.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

#: arch -> softmax_impl: Yi takes the CORDIC split (its window sums gathered)
ARCHS = {"yi-9b": "cordic_pallas", "deepseek-v2-lite-16b": "exact",
         "zamba2-1.2b": "exact"}
#: (world, model ranks) of the host meshes
MESHES = {"2x1": (2, 1), "2x2": (4, 2)}
MAX_LEN, PROMPT, STEPS = 64, 9, 4


def _cfg(arch, mod=configs):
    cfg = mod.get_smoke(arch, act_impl="exact")
    return dataclasses.replace(cfg, softmax_impl=ARCHS[arch], input_mode="tokens")


def _jobs(tp):
    return [dict(cfg=_cfg(arch), prompt=np.random.default_rng(i).integers(
                     0, _cfg(arch).vocab_size, (1, PROMPT)),
                 steps=STEPS, max_len=MAX_LEN, tp=tp)
            for i, arch in enumerate(ARCHS)]


def _jax_greedy(arch, job):
    """JAX's greedy decoding of the job with the port's seeded weights: a
    prefill of the prompt into a float32 dense cache of MAX_LEN positions,
    then STEPS single-token applies."""
    model = T.init(job["cfg"], seed=0, device="cpu")
    params = jax.tree.map(jnp.asarray, T.jax_tree(job["cfg"], dict(model.named_parameters())))
    jcfg = _cfg(arch, jconfigs)
    step = jax.jit(lambda p, t, c: JT.apply(p, {"tokens": t}, jcfg, cache=c))
    cache = JT.init_cache(jcfg, 1, MAX_LEN, jnp.float32)
    logits, _, cache = step(params, jnp.asarray(job["prompt"], jnp.int32), cache)
    toks = [int(np.asarray(logits)[0, -1].argmax())]
    for _ in range(STEPS):
        logits, _, cache = step(params, jnp.asarray([[toks[-1]]], jnp.int32), cache)
        toks.append(int(np.asarray(logits)[0, -1].argmax()))
    return toks


@pytest.fixture(scope="module")
def runs():
    """{mesh: per rank, per arch, ``rank_decode``'s result}, one rank's
    results and JAX's greedy tokens, the groups running while the rest
    computes."""
    groups = {name: M.RankGroup(dryrun.rank_decode, world, _jobs(tp))
              for name, (world, tp) in MESHES.items()}
    one = dryrun.rank_decode(_jobs(1))
    jax_toks = {arch: _jax_greedy(arch, job) for arch, job in zip(ARCHS, _jobs(1))}
    return {name: g.join() for name, g in groups.items()}, one, jax_toks


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_data_cut_serves_one_ranks_and_jaxs_tokens(runs, arch, mesh):
    ranks, one, jax_toks = runs
    i = list(ARCHS).index(arch)
    assert one[i]["kv_shard"] == "auto" and len(one[i]["tokens"][0]) == STEPS + 1
    assert one[i]["tokens"][0] == jax_toks[arch]
    for rank in ranks[mesh]:
        assert rank[i]["kv_shard"] == "seq_data"
        assert rank[i]["tokens"] == one[i]["tokens"]


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_rank_cache_holds_its_data_span_and_books_the_data_group(runs, arch, mesh):
    """The rank's attention buffers are one rank's over dp (and over tp
    where the heads cut divides them: Zamba2's 4 KV heads at tp 2; Yi's
    one KV head and MLA's head-less latent stay whole); the reductions of
    the split attention run over the data group."""
    ranks, one, _ = runs
    i = list(ARCHS).index(arch)
    world, tp = MESHES[mesh]
    cfg = _cfg(arch)
    heads = (1 if cfg.mla is not None else
             A.padded_heads(cfg)[1] // shd.local_kv_heads(cfg, M.dry_mesh(tp)))
    for rank in ranks[mesh]:
        assert rank[i]["cache_bytes"] * (world // tp) * heads == one[i]["cache_bytes"]
        assert rank[i]["stats"]["data_all_reduce"] > 0
        assert rank[i]["stats"]["data_all_reduce"] <= rank[i]["stats"]["all_reduce"]
    # Yi's CORDIC split gathers the spans' window sums over the data group
    if ARCHS[arch] == "cordic_pallas":
        assert all(r[i]["stats"]["data_all_gather"] > 0 for r in ranks[mesh])


def test_resolve_kv_shard_takes_the_data_cut_for_an_undivided_batch():
    """"auto" becomes "seq_data" for a dense batch the data axes do not
    divide (or fewer rows than data ranks) where they divide the length;
    a divided batch, the paged plane, one data rank, a length they do not
    divide and ``seq_model`` keep their cut; a CORDIC span of partial
    32-lane windows is refused."""
    cfg = _cfg("zamba2-1.2b")
    mesh = M.dry_mesh(2, data=4)
    r = lambda c=cfg, **kw: shd.resolve_kv_shard(c, mesh, **{"max_len": 256, **kw}).kv_shard
    assert r(batch=1) == r(batch=6) == "seq_data"
    assert r(batch=8) == r(batch=4) == r() == "auto"
    assert r(batch=1, dense=False) == "auto" and r(batch=1, max_len=250) == "auto"
    assert shd.resolve_kv_shard(cfg, M.dry_mesh(2), 256, batch=1).kv_shard == "auto"
    seq = dataclasses.replace(cfg, kv_shard="seq_model")
    assert r(seq, batch=1) == "seq_model"
    assert shd.seq_axis(dataclasses.replace(cfg, kv_shard="seq_data"), mesh) == "data"
    assert shd.seq_axis(seq, mesh) == "model"
    fixed = dataclasses.replace(cfg, softmax_impl="cordic_fixed")
    assert r(fixed, batch=1) == "seq_data"
    with pytest.raises(ValueError, match="32"):
        r(fixed, batch=1, max_len=192)
    with pytest.raises(ValueError, match="unknown kv_shard"):
        r(dataclasses.replace(cfg, kv_shard="seq_pod"), batch=1)
