"""The port's sharding rules, serving cut, meshes and ``psum_compressed``
(distributed/sharding.py, launch/mesh.py, distributed/compression.py)
against the JAX package's.

The rules are pure Python on both sides: the port's ``spec_for_axes`` over
its own leaves' logical axes equals the JAX function over the JAX spec's, at
model widths 1, 2, 4 and 16, for every leaf of all ten archs' smoke configs.
``psum_compressed`` runs on 2 and 4 spawned gloo ranks and equals the JAX
function under ``jax.jit(jax.vmap(..., axis_name="i"))`` bit for bit.
"""
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.distributed import compression as jcomp  # noqa: E402
from repro.distributed import sharding as jshd  # noqa: E402
from repro.models import common as jcm  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

WIDTHS = (1, 2, 4, 16)


def fake_mesh(tp, rank=0):
    """A rank's view of a 1 x tp mesh without a process group: enough for
    the cut, which runs no collective."""
    return M.Mesh(shape={"data": 1, "model": tp}, rank=rank, group=None,
                  backend="none")


def _jax_leaves(cfg):
    """{JAX flat path: (axes, shape)} of the JAX spec tree."""
    out = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, jcm.P):
                out[prefix + k] = (tuple(v.axes), tuple(v.shape))
            else:
                walk(v, prefix + k + "/")
    walk(JT.model_spec(cfg), "")
    return out


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_spec_for_axes_matches_jax_on_every_leaf(arch):
    cfg = configs.get_smoke(arch)
    jcfg = jconfigs.get_smoke(arch)
    model = T.Transformer(cfg, device="meta")
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    axes = shd.param_axes(model)
    jleaves = _jax_leaves(jcfg)
    layout = T.jax_layout(cfg)
    assert len(layout) == len(shapes)
    for n in WIDTHS:
        jmesh = AbstractMesh((1, n), ("data", "model"))
        for name, path, idx in layout:
            jaxes, jshape = jleaves[path]
            want = tuple(jshd.spec_for_axes(jaxes, jshape, jmesh))
            got = shd.spec_for_axes(axes[name], shapes[name], {"data": 1, "model": n})
            if idx is not None and got:          # the stacked "layers" dim
                got = (None,) + got
            assert got == want, (arch, n, name, got, want)


def test_spec_rules_fallback_order_and_one_axis():
    mesh = {"data": 1, "model": 16}
    assert shd.spec_for_axes(("kv_heads", "embed"), (4, 64), mesh) == ()
    assert shd.spec_for_axes(("kv_heads", "embed"), (16, 64), mesh) == ("model",)
    mesh = {"data": 1, "model": 4}
    # experts first takes the axis; mlp of the same tensor stays whole
    assert shd.spec_for_axes(("experts", "embed", "mlp"), (8, 64, 128),
                             mesh) == ("model",)
    # experts that do not divide leave the axis to mlp
    assert shd.spec_for_axes(("experts", "embed", "mlp"), (6, 64, 128),
                             mesh) == (None, None, "model")


def _params(model):
    return {n: p.detach() for n, p in model.named_parameters()}


@pytest.mark.parametrize("arch,tp", [("deepseek-v2-lite-16b", 2), ("yi-9b", 2),
                                     ("phi3.5-moe-42b-a6.6b", 4),
                                     ("musicgen-large", 4)])
def test_rank_shards_are_the_tp1_weights(arch, tp):
    """Each rank's leaves, built leaf by leaf from the seed (``tf.init``
    with a mesh) and cut from a whole model (``shard_model``), are the
    tp = 1 weights' slices along the rules' dim; the embedding and the MoE
    router stay whole."""
    cfg = configs.get_smoke(arch)
    full = _params(T.init(cfg, seed=5, device="cpu"))
    whole = T.init(cfg, seed=5, device="cpu")
    seen_cut = set()
    for rank in range(tp):
        mesh = fake_mesh(tp, rank)
        built = T.init(cfg, seed=5, device="cpu", mesh=mesh)
        cut = shd.shard_model(whole, mesh)
        cuts = shd.leaf_cuts(built)
        assert cuts == shd.leaf_cuts(cut)
        for name, t in _params(built).items():
            want = full[name]
            if name in cuts:
                d = cuts[name]
                n = want.shape[d] // tp
                want = want.narrow(d, rank * n, n)
                seen_cut.add(name.rsplit(".", 1)[-1])
            assert torch.equal(t, want), name
            assert torch.equal(_params(cut)[name], want), name
        assert "embed" not in cuts
        assert not any(n.endswith("router") for n in cuts)
        # a cut leaf owns its storage: the whole leaf it came from is gone
        assert all(p.untyped_storage().nbytes() == p.numel() * p.element_size()
                   for p in built.parameters())
    assert "wo" in seen_cut and "lm_head" in seen_cut


def test_load_jax_params_with_mesh_slices_the_bridge():
    cfg = configs.get_smoke("deepseek-v2-lite-16b")
    full = T.init(cfg, seed=2, device="cpu")
    flat = T.flatten_params(T.jax_tree(cfg, _params(full)))
    for rank in range(2):
        mesh = fake_mesh(2, rank)
        got = T.load_jax_params(cfg, flat, device="cpu", mesh=mesh)
        want = shd.shard_model(full, mesh)
        for (n, a), (_, b) in zip(_params(got).items(), _params(want).items()):
            assert torch.equal(a, b), n
        assert got.mesh is mesh


#: the packed leaves' parts (sharding.mixer_layout) of the smoke configs
PACKED = ("mixer.in_proj", "mixer.conv_w", "mixer.conv_b", "mixer.up_proj",
          "mixer.w", "mixer.b")


@pytest.mark.parametrize("arch,tp", [("xlstm-1.3b", 2), ("zamba2-1.2b", 2),
                                     ("zamba2-1.2b", 4)])
def test_recurrent_archs_refuse_the_cut(arch, tp):
    """The recurrent archs take the cut now (ROADMAP A.12b closed): each
    rank's packed leaves, built from the seed and cut from a whole model,
    are the per-part slices of the whole tp 1 leaf (each part's rank piece,
    Mamba2's one-group B / C whole), and the row-cut leaves the contiguous
    slices that line up with the rank's heads."""
    cfg = configs.get_smoke(arch)
    full = _params(T.init(cfg, seed=5, device="cpu"))
    whole = T.init(cfg, seed=5, device="cpu")
    for rank in range(tp):
        mesh = fake_mesh(tp, rank)
        built = T.init(cfg, seed=5, device="cpu", mesh=mesh)
        cut = shd.shard_model(whole, mesh)
        parts = shd.leaf_parts(built)
        assert parts == shd.leaf_parts(cut)
        assert {n.split(".", 2)[2] for n in parts} <= set(PACKED) and parts
        for name, t in _params(built).items():
            assert torch.equal(t, _params(cut)[name]), name
            if name not in parts:
                continue
            d = shd.leaf_cuts(built)[name]
            lo, pieces = 0, []
            for w, units in parts[name]:
                seg = full[name].narrow(d, lo, w)
                lo += w
                if units % tp:
                    pieces.append(seg)                     # whole part
                else:
                    pieces += [seg.chunk(tp, dim=d)[rank]]
            assert torch.equal(t, torch.cat(pieces, dim=d)), name
        # the rows follow the heads: out_proj / down_proj are row slices
        for name, d in shd.leaf_cuts(built).items():
            if name.endswith(("out_proj", "down_proj")):
                assert d == 0 and torch.equal(
                    _params(built)[name], full[name].chunk(tp, dim=0)[rank])


def test_make_host_mesh_and_mesh_or_none():
    # no process group: one rank
    with pytest.raises(ValueError, match="world size 1"):
        M.make_host_mesh(2)
    with pytest.raises(ValueError):
        M.make_host_mesh(0)
    assert M.mesh_or_none(1) is None
    assert M.mesh_or_none(None) is None
    assert M.mesh_or_none(0) is None
    mesh = M.make_host_mesh(1)
    assert mesh.shape == {"data": 1, "model": 1} and mesh.axis_names == ("data", "model")


def test_run_ranks_reports_a_failing_rank():
    """A rank that raises fails the call with its traceback; no child is
    left behind (``psum_compressed``'s test holds a call that succeeds)."""
    with pytest.raises(RuntimeError, match="rank 1 failed(.|\n)*math domain"):
        M.run_ranks(M.rank_call, 2, ("math:sqrt", [(4.0,), (-1.0,)]), timeout=120)


def test_run_ranks_reports_every_failing_rank():
    """Whichever failure arrives first, the message names every failing
    rank in rank order: a peer's failure that follows from another's (a
    collective whose peer is gone) must not hide the cause."""
    with pytest.raises(RuntimeError) as err:
        M.run_ranks(M.rank_call, 2, ("math:log", [(0.0,), (-1.0,)]), timeout=120)
    msg = str(err.value)
    assert re.search("rank 0 failed(.|\n)*math domain(.|\n)*rank 1 failed(.|\n)*"
                     "math domain", msg), msg


#: a max |x| whose scale, max/127 + 1e-30, rounds otherwise unless the
#: multiply by float32(1/127) and the add are fused (ROADMAP F9)
F9_AMAX = np.float32(2.8773528e-28)


@pytest.mark.parametrize("n,amax", [(2, None), (4, None), (2, F9_AMAX)])
def test_psum_compressed_bit_equal_to_jax(n, amax):
    rng = np.random.default_rng(n)
    xs = (rng.standard_normal((n, 3, 37)) * rng.uniform(0.1, 5, (n, 1, 1))
          ).astype(np.float32)
    if amax is not None:
        xs = (xs / np.abs(xs).max() * amax).astype(np.float32)
        xs.flat[np.abs(xs).argmax()] = amax
    want = np.asarray(jax.jit(jax.vmap(lambda x: jcomp.psum_compressed(x, "i"),
                                       axis_name="i"))(xs))
    got = M.run_ranks(M.rank_call, n, (
        "repro_torch.distributed.compression:psum_compressed",
        [(torch.from_numpy(xs[r]),) for r in range(n)]), timeout=120)
    for r in range(n):
        assert got[r].dtype == torch.float32
        np.testing.assert_array_equal(got[r].numpy(), want[r])
    # and the mean it compresses
    np.testing.assert_allclose(got[0].numpy(), xs.mean(0), atol=np.abs(xs).max() / 127)


@pytest.mark.parametrize("H,KH,tp", [(8, 4, 2), (4, 1, 2), (4, 1, 4), (12, 4, 3)],
                         ids=["kv-cut", "kv-whole-2", "kv-whole-4", "kv-whole-uneven"])
def test_rank_attention_partials_sum_to_tp1(H, KH, tp, monkeypatch):
    """Each rank's GQA layer on its heads (its own KV heads, or the whole
    KV heads' ones its query heads read: a slice of groups, one group's
    share, or per query head) gives a partial ``wo`` sum; the ranks'
    partials add up to the tp = 1 layer's output."""
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models import attention as A

    cfg = ModelConfig(name="t", family="dense", num_layers=1, d_model=32,
                      num_heads=H, num_kv_heads=KH, d_ff=64, vocab_size=64,
                      dtype="float32", act_impl="exact")
    model = T.init(cfg, seed=1, device="cpu")
    x = torch.from_numpy(np.random.default_rng(0).normal(0, 1, (2, 7, 32))
                         .astype(np.float32))
    with torch.no_grad():
        want = A.gqa_apply(model.blocks[0].attn, x, cfg)
        monkeypatch.setattr(shd, "all_reduce_", lambda t, mesh=None: t)
        got = 0
        for r in range(tp):
            mesh = fake_mesh(tp, r)
            with shd.serving_mesh(mesh):
                got = got + A.gqa_apply(shd.shard_model(model, mesh).blocks[0].attn,
                                        x, cfg)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
