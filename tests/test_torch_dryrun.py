"""The port's cost tooling (launch/{mesh,specs,op_cost,dryrun,roofline,
perf}.py, kernels/cost.py) against the JAX package's: the production mesh,
the data-axis specs, every arch's per-rank leaf shapes at (16, 16) against
the shard shapes of JAX's ``spec_for_axes``, the op counter's product FLOPs
against a count from the step's shapes, the kernels' bookings, and one
``lower_cell`` per serving shape on a smoke config. The dry mesh's
collectives are held against a real gloo run in tests/test_torch_tp.py
(its spawned rank group runs the same steps).
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jax.sharding import AbstractMesh  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.distributed import sharding as jshd  # noqa: E402
from repro.launch import mesh as jmesh  # noqa: E402
from repro.launch import perf as jperf  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs.base import SHAPES, ShapeConfig  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.kernels import cordic_act as K  # noqa: E402
from repro_torch.kernels import cost as kcost  # noqa: E402
from repro_torch.kernels import softmax_cordic as SM  # noqa: E402
from repro_torch.launch import dryrun, op_cost, perf, roofline  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402
from repro_torch.launch import specs as sp  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from test_torch_sharding import _jax_leaves  # noqa: E402


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_equals_jax(monkeypatch, multi_pod):
    monkeypatch.setattr(jmesh.jax, "make_mesh", lambda shape, axes: (shape, axes))
    shape, axes = jmesh.make_production_mesh(multi_pod=multi_pod)
    mesh = M.make_production_mesh(multi_pod=multi_pod)
    assert tuple(mesh.shape.values()) == tuple(shape)
    assert mesh.axis_names == tuple(axes)
    assert mesh.dry and mesh.tp == 16 and mesh.size == int(np.prod(shape))
    assert shd.dp_size(mesh) == mesh.size // 16


@pytest.mark.parametrize("multi_pod", [False, True])
def test_batch_and_cache_spec_equal_jax(multi_pod):
    mesh = M.make_production_mesh(multi_pod=multi_pod)
    names = mesh.axis_names
    jm = AbstractMesh(tuple(mesh.shape.values()), names)
    for b, s in ((32, 32768), (128, 1), (1, 524288), (1, 1), (256, 4096), (3, 5)):
        want = tuple(jshd.batch_spec(jm, b, s))
        assert shd.batch_spec(mesh, b, s) == want, (b, s)
        for kh in (4, 16, 32):
            assert shd.cache_spec(mesh, b, s, kh) == jshd.cache_spec(jm, b, s, kh)


def _jax_shard_shape(axes, shape, jm):
    spec = tuple(jshd.spec_for_axes(axes, shape, jm))
    return tuple(d // 16 if i < len(spec) and spec[i] == "model" else d
                 for i, d in enumerate(shape))


def _packed_width(cfg, mod, leaf, tp):
    """The stated per-rank width of a packed leaf's cut dim: each per-head
    part over tp, Mamba2's B / C over tp only where the groups divide."""
    if mod == "Mamba2":
        s = cfg.ssm
        d_inner = s.expand * cfg.d_model
        H = d_inner // s.head_dim
        bc = s.n_groups * s.d_state // (tp if s.n_groups % tp == 0 else 1)
        x = d_inner // tp
        return {"in_proj": 2 * x + 2 * bc + H // tp, "conv_w": x + 2 * bc,
                "conv_b": x + 2 * bc}[leaf]
    if mod == "MLSTM":
        return 2 * int(cfg.d_model * cfg.xlstm.proj_factor) // tp
    return 4 * cfg.d_model // tp                            # SLSTM w / b


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_rank_leaf_shapes_at_16x16_equal_jax_shards(arch):
    """Every leaf of the rank's cut (specs.abstract_params on the (16, 16)
    production mesh, meta) has the shard shape of JAX's spec_for_axes,
    except: the serving carve-outs (embedding and MoE router whole); a
    recurrent mixer whose heads do not divide 16 (xLSTM's 4), whole; and
    the packed leaves of a cut mixer, by their stated formula."""
    cfg = configs.get_config(arch)
    mesh = M.make_production_mesh()
    model = sp.abstract_params(cfg, mesh)
    assert all(p.device.type == "meta" for p in model.parameters())
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    jleaves = _jax_leaves(jconfigs.get_config(arch))
    jm = AbstractMesh((16, 16), ("data", "model"))
    mods = {n: type(m).__name__ for n, m in model.named_modules()}
    n_packed = 0
    for name, path, idx in T.jax_layout(cfg):
        jaxes, jshape = jleaves[path]
        want = _jax_shard_shape(jaxes, jshape, jm)
        if idx is not None:
            want = want[1:]                        # the stacked layers dim
        mname, leaf = name.rsplit(".", 1) if "." in name else ("", name)
        mod = mods[mname]
        layout = shd.mixer_layout(mod, cfg)
        if (mod, leaf) in shd.SERVE_REPLICATED:
            want = tuple(jshape[1:] if idx is not None else jshape)
        elif layout is not None and not shd.mixer_is_cut(layout[0], mesh):
            want = tuple(jshape[1:] if idx is not None else jshape)
        elif layout is not None and leaf in layout[1]:
            dim = layout[1][leaf][0]
            want = list(want)
            want[dim] = _packed_width(cfg, mod, leaf, 16)
            want = tuple(want)
            n_packed += 1
        assert shapes[name] == want, (arch, name, shapes[name], want)
    if arch == "zamba2-1.2b":
        assert n_packed == 3 * cfg.num_layers


def test_op_cost_counts_a_dense_decode_steps_products():
    """The product FLOPs the counter sees in Yi's smoke decode step equal
    the count from the step's shapes: per layer the q, k, v, o and SwiGLU
    projections and the dense plane's score and P.V products over the
    whole max_len buffer, then the head; one all-reduce per row-parallel
    product and the logits gather on a dry tp 2 mesh."""
    cfg = configs.get_smoke("yi-9b", act_impl="exact")
    B, Tl = 3, 24
    rec = dryrun.lower_cell("yi-9b", "decode", smoke=True, act_impl="exact",
                            mesh=M.dry_mesh(1), shape=ShapeConfig("d", Tl, B, "decode"))
    d, H, KH, hd, F, V = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                          cfg.d_ff, cfg.vocab_size)
    per_layer = (2 * B * d * hd * (H + 2 * KH) + 2 * B * H * hd * d + 3 * 2 * B * d * F
                 + 2 * 2 * B * H * Tl * hd)
    want = cfg.num_layers * per_layer + 2 * B * d * V
    assert rec["op_cost"]["product_flops"] == want
    assert rec["collective"]["op_counts"] == {}
    rec2 = dryrun.lower_cell("yi-9b", "decode", smoke=True, act_impl="exact",
                             mesh=M.dry_mesh(2), shape=ShapeConfig("d", Tl, B, "decode"))
    # at tp 2: half the query heads, o rows, SwiGLU columns and vocabulary;
    # the one KV head whole on each rank
    per_rank = (2 * B * d * hd * (H // 2 + 2 * KH) + 2 * B * (H // 2) * hd * d
                + 3 * 2 * B * d * (F // 2) + 2 * 2 * B * (H // 2) * Tl * hd)
    assert rec2["op_cost"]["product_flops"] == cfg.num_layers * per_rank + 2 * B * d * V // 2
    assert rec2["collective"]["op_counts"] == {"all-reduce": 2 * cfg.num_layers + 1}


def test_kernel_wrappers_book_their_work_on_every_route():
    """A wrapper books one op with its function's work on a CPU tensor
    (its plain version's ops muted) and on a meta one (no value read)."""
    x = torch.randn(8, 33)
    ops = kcost.pipeline_ops(K.PAPER_SCHEDULE)
    for t in (x, x.to("meta")):
        with op_cost.OpCost() as oc:
            y = K.act_2d(t, "sigmoid")
        r = oc.result()
        assert y.shape == t.shape and y.device == t.device
        assert r["kernel_calls"] == {"act_2d": 1} and r["aten_ops"] == 0
        assert r["kernel_int_ops"] == ops["sigmoid_tab"] * x.numel()
        assert r["kernel_bytes"] == 2 * 4 * x.numel()
    s = torch.randn(4, 16)
    s[:, 10:] = -1e30
    with op_cost.OpCost() as oc:
        SM.softmax_2d(s)
    assert oc.result()["kernel_int_ops"] == ops["softmax_lane_tab"] * 40
    with op_cost.OpCost() as oc:
        SM.softmax_2d(s.to("meta"))
    assert oc.result()["kernel_int_ops"] == ops["softmax_lane_tab"] * 64
    # no counter: nothing booked, nothing muted
    assert not kcost.COUNTERS and kcost.MUTED == [0] and kcost.REPEAT == [1]


@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k", "long_500k"])
def test_lower_cell_per_serving_shape_on_a_smoke_config(shape):
    """Zamba2's smoke config (the sub-quadratic hybrid: Mamba2, the shared
    attention block, long_500k applies) on the production mesh, each
    serving shape's batch at 64 positions: ``ok``, with the JAX record's
    keys and the rank's memory. long_500k's one row is whole on every data
    rank, so its shared block's cache holds 1/16 of the positions (the JAX
    default cache spec's cut over the data axes, ROADMAP A.17b) and the
    step books the split attention's reductions over the data group; the
    shapes whose batch the data axes divide book none there."""
    full = SHAPES[shape]
    rec = dryrun.lower_cell("zamba2-1.2b", shape, smoke=True, act_impl="cordic_pallas",
                            shape=ShapeConfig(shape, 64, full.global_batch, full.kind))
    assert rec["status"] == "ok" and rec["devices"] == 256 and rec["mesh"] == [16, 16]
    for k in ("flops_per_chip", "hbm_bytes_per_chip", "collective", "roofline",
              "params_total", "params_active", "tokens_per_step",
              "model_flops_global", "model_flops_per_chip", "useful_flops_ratio",
              "memory"):
        assert k in rec, k
    assert rec["rank_rows"] == (full.global_batch // 16 if full.global_batch >= 16 else 1)
    assert rec["roofline"]["peaks"] == "H100 SXM data sheet"
    assert rec["memory"]["params_bytes"] > 0 and rec["memory"]["state_bytes"] > 0
    # the kernels booked their work: the Mamba2 SiLUs (act_2d) and the
    # shared block's SwiGLU epilogue (silu_mul_2d)
    calls = rec["op_cost"]["kernel_calls"]
    assert calls.get("act_2d", 0) > 0 and calls.get("silu_mul_2d", 0) > 0
    assert rec["collective"]["op_counts"]["all-reduce"] > 0
    mesh = M.make_production_mesh()
    cfg = dryrun.cell_config("zamba2-1.2b", smoke=True, act_impl="cordic_pallas")
    sh = ShapeConfig(shape, 64, full.global_batch, full.kind)
    whole = sp.memory(sp.abstract_params(cfg, mesh), sp.abstract_cache(cfg, mesh, sh))
    kv = whole["cache_bytes"] - whole["state_bytes"]
    got = rec["memory"]["cache_bytes"] - rec["memory"]["state_bytes"]
    data = rec["collective"]["data_op_counts"]
    if shape == "long_500k":
        assert kv > 0 and got * 16 == kv, (got, kv)
        assert data.get("all-reduce", 0) > 0
    else:
        assert got == kv and not data


def test_skips_refusals_perf_and_roofline(tmp_path, capsys):
    """long_500k stays skipped where it does not apply; kv_shard="seq_model"
    lowers (a serving cell cuts its dense caches by position: Yi's one KV
    head, whole on every rank under the heads cut, becomes half the
    positions at tp 2; a train cell has no cache); the train-side variants
    and the kv_shard one run (a train cell on a small dry mesh); the
    roofline table reads the records."""
    assert dryrun.lower_cell("yi-9b", "long_500k")["status"] == "skipped"
    shape = ShapeConfig("decode", 64, 2, "decode")
    cut, heads = (dryrun.lower_cell("yi-9b", "decode", smoke=True, act_impl="exact",
                                    mesh=M.dry_mesh(2), shape=shape, kv_shard=kv)
                  for kv in ("seq_model", "auto"))
    assert cut["status"] == heads["status"] == "ok"
    assert 2 * cut["memory"]["cache_bytes"] == heads["memory"]["cache_bytes"]
    assert (cut["collective"]["op_counts"]["all-reduce"]
            > heads["collective"]["op_counts"]["all-reduce"])
    assert list(perf.VARIANTS) == list(jperf.VARIANTS)
    names = ["baseline", "no_remat", "remat_dots", "accum4", "accum4_dots", "zero1",
             "zero1_dots", "accum4_fixed", "slstm_rep_dots", "kv_seq_shard"]
    recs = perf.run_variants("xlstm-1.3b", "train", names, smoke=True,
                             act_impl="exact", mesh=M.dry_mesh(2, data=2),
                             shape=ShapeConfig("train", 16, 8, "train"))
    assert [r["status"] for r in recs] == ["ok"] * 10
    by = {r["variant"]: r for r in recs}
    # remat "full" recomputes each block's forward: more FLOPs than none
    assert by["baseline"]["flops_per_chip"] > by["no_remat"]["flops_per_chip"]
    assert by["zero1"]["collective"]["op_counts"]["all-gather"] > 0
    assert "all-gather" not in by["baseline"]["collective"]["op_counts"]
    path = tmp_path / "dryrun_torch_x.json"
    path.write_text(json.dumps(recs[:2]))
    assert roofline.main(["--glob", str(path)]) == 0
    out = capsys.readouterr().out
    assert "H100 SXM data sheet" in out and "| xlstm-1.3b | train |" in out


@pytest.mark.parametrize("arch", ["yi-9b", "deepseek-v2-lite-16b", "zamba2-1.2b"])
def test_train_cell_lowers_ok_on_a_small_mesh(arch):
    """A train cell (the rank's train step on meta: forward, backward
    through the collectives, the reductions, AdamW) on a dry (2, 2) mesh:
    "ok", 6 N D model FLOPs, the rank's optimizer bytes (2x its params,
    halved under ZeRO-1, which adds the parameters' all-gathers), and the
    loss's gather of the vocabulary-parallel logits among its all-reduces."""
    shape = ShapeConfig("train", 16, 8, "train")
    mesh = lambda: M.dry_mesh(2, data=2)
    rec = dryrun.lower_cell(arch, "train", smoke=True, mesh=mesh(), shape=shape,
                            act_impl="exact")
    assert rec["status"] == "ok" and rec["kind"] == "train" and rec["rank_rows"] == 4
    cfg = configs.get_smoke(arch)
    assert rec["model_flops_global"] == 6 * cfg.param_counts()["active"] * 8 * 16
    mem = rec["memory"]
    assert mem["opt_bytes"] == 2 * mem["params_bytes"] and mem["cache_bytes"] == 0
    assert mem["total_bytes"] == 3 * mem["params_bytes"]
    counts = rec["collective"]["op_counts"]
    assert counts["all-reduce"] > 2 * cfg.num_layers and "all-gather" not in counts
    # the logits gather: rows x seq x vocab float32 among the bytes
    assert rec["collective"]["per_kind_bytes"]["all-reduce"] > 4 * 16 * cfg.vocab_size * 4
    z = dryrun.lower_cell(arch, "train", smoke=True, mesh=mesh(), shape=shape, zero1=True,
                          accum=2, remat="dots", act_impl="exact")
    assert z["status"] == "ok"
    assert z["memory"]["opt_bytes"] < mem["opt_bytes"]
    assert z["collective"]["op_counts"]["all-gather"] > 0


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_zero1_specs_equal_jax_zero1_extend(arch, multi_pod):
    """Every leaf's param and ZeRO-1 moment spec on the production mesh
    (specs.state_specs) equals JAX's spec_for_axes and _zero1_extend on
    the same whole leaf."""
    from jax.sharding import NamedSharding, PartitionSpec as PS

    from repro.launch import specs as jsp

    cfg = configs.get_config(arch)
    mesh = M.make_production_mesh(multi_pod=multi_pod)
    jm = AbstractMesh(tuple(mesh.shape.values()), mesh.axis_names)
    specs = sp.state_specs(cfg, mesh, zero1=True)
    jleaves = _jax_leaves(jconfigs.get_config(arch))
    strip = lambda spec: tuple(spec)[:max([i + 1 for i, a in enumerate(spec)
                                            if a is not None] or [0])]
    n_ext = 0
    for name, path, idx in T.jax_layout(cfg):
        jaxes, jshape = jleaves[path]
        if idx is not None:                      # the stacked layers dim
            jaxes, jshape = jaxes[1:], jshape[1:]
        jspec = tuple(jshd.spec_for_axes(jaxes, jshape, jm))
        jz = jsp._zero1_extend(NamedSharding(jm, PS(*jspec)), jshape, jm).spec
        got_p, got_z = specs[name]
        assert got_p == strip(jspec), (name, got_p, jspec)
        assert got_z == strip(jz), (name, got_z, jz)
        n_ext += got_z != got_p
    assert n_ext > 0
