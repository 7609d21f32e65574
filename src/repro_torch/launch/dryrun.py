"""Dry run of the train and serving steps on the production meshes (port
of ``repro/launch/dryrun.py``), on the host, without a card.

For every (architecture x shape) cell it runs the port's real step on meta
tensors, for one rank of the cut, under ``op_cost.OpCost``: the train step
on a mesh (``train_4k``: train/step.py's ``make_train_step`` with
``mesh=``, forward, backward through the collectives, the gradient
reductions and AdamW, with ``remat`` "full" by default as the JAX
``lower_cell``, and ``accum`` and ``zero1``), or the prefill or decode
step (``prefill_step`` / ``decode_step``: the engine's dense-plane apply,
the vocabulary gather and the greedy token):

    * the single-pod production mesh  (16, 16)   ("data", "model")
    * the two-pod mesh               (2, 16, 16) ("pod", "data", "model")

and records the rank's FLOPs, HBM bytes and collective bytes, the
roofline terms against the H100's peaks (``kernels/cost.PEAKS``), and the
rank's param, cache, optimizer and error-feedback bytes (``memory``,
which replaces XLA's ``memory_analysis``). The records keep the JAX
record's keys where they mean the same thing. The seconds are a model
against the named peaks, not a measurement. A train cell's collectives
include the loss's gather of the vocabulary-parallel logits: the
log-softmax runs on whole rows, as GSPMD runs the unpartitionable Pallas
call.

Every JAX knob is taken (``act_impl``, ``attn_chunk``, ``score_dtype``,
``pad_heads_to``, ``slstm_state``, ``mixer_chunk``, ``remat``, ``accum``,
``zero1``, ``kv_shard``). ``kv_shard="seq_model"`` cuts a serving cell's
dense caches by position over the model axis where it divides the length
(``shd.resolve_kv_shard``, as the JAX spec's ``S % model == 0``): the
rank's cache bytes fall by tp where the KV heads did not divide, and its
step books the split attention's collectives (models/attention.py). A
train cell has no cache, so the knob changes nothing there. A serving
cell whose batch the data axes do not divide (``long_500k``) cuts its
dense caches' positions over them, the JAX default spec
(``resolve_kv_shard(..., batch=)``, "seq_data"): the rank holds 1/dp of
the cache, and the record's ``collective.data_op_counts`` counts the
split attention's reductions over the data group.

A meta tensor has no values, so the step's data-dependent answers take
their shape-only form on it (models/ssm.py, models/xlstm.py: a time loop's
step is counted once per step with its values unread; kernels/cost.py:
every lane counts as live).

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-9b --shape decode_32k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out results/dryrun_torch.json
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import traceback

import torch

from repro_torch import configs
from repro_torch.configs.base import SHAPES, shape_applicable
from repro_torch.distributed import sharding as shd
from repro_torch.launch import op_cost
from repro_torch.launch import specs as sp
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.optim import adamw
from repro_torch.serve import engine as serve_engine
from repro_torch.serve import sampling
from repro_torch.train import step as step_lib

def prefill_step(params, cache, tokens, cfg):
    """The engine's dense prefill of whole rows (``make_prefill_step``):
    fresh state, positions 0, the last position's logits, gathered over the
    model axis. Returns the (rows, V) logits."""
    return serve_engine.make_prefill_step(cfg)(params, cache, tokens)


def decode_step(params, cache, tokens, cfg):
    """One batched decode (``make_decode_logits``), the vocabulary gather
    and the greedy token. Returns the (rows,) tokens."""
    logits = serve_engine.make_decode_logits(cfg)(params, cache, tokens)
    return sampling.greedy_tokens(serve_engine.gathered_logits(params, cfg, logits))


def rank_steps(job):
    """A ``run_ranks`` target (tests): ``prefill_step`` and ``decode_step``
    of each smoke config of ``job["archs"]`` on real CPU tensors on this
    rank's mesh (``job["tp"]``), each on a fresh cache of ``job["rows"]``
    rows and ``job["seq"]`` positions, as ``lower_cell`` builds them.
    Returns {arch: {"prefill" | "decode": the mesh stats it added}}."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import transformer as tf

    mesh = mesh_lib.make_host_mesh(job["tp"])
    B, S = job["rows"], job["seq"]
    out = {}
    for arch in job["archs"]:
        cfg = cell_config(arch, smoke=True, act_impl=job.get("act_impl", "exact"))
        model = tf.init(cfg, seed=0, device="cpu", mesh=mesh)
        g = torch.Generator().manual_seed(0)
        out[arch] = {}
        for kind, step, width in (("prefill", prefill_step, S), ("decode", decode_step, 1)):
            cache = tf.init_cache(cfg, B, S, torch.float32, device="cpu",
                                  kv_heads=shd.local_kv_heads(cfg, mesh), mesh=mesh)
            toks = torch.randint(0, cfg.vocab_size, (B, width), generator=g)
            s0 = dict(mesh.stats)
            with torch.no_grad():
                step(model, cache, toks, cfg)
            out[arch][kind] = {k: v - s0.get(k, 0) for k, v in mesh.stats.items()}
    return out


def rank_decode(job):
    """A ``run_ranks`` target (tests, chip_smoke), or a call on one process:
    greedy decoding on this rank's mesh (``job["tp"]`` model ranks, the rest
    of the world the data axis; no mesh on one process), served as
    ``lower_cell`` serves a cell: ``kv_shard`` resolved for the batch (a
    batch the data axes do not divide cuts its caches' positions over
    them, ``shd.resolve_kv_shard(..., batch=)``), a fresh float32 cache of
    ``job["max_len"]`` positions at the rank's cut, ``prefill_step`` on
    ``job["prompt"]`` (B, S) ids, then ``job["steps"]`` ``decode_step``s.
    job: {"cfg", "prompt", "steps", "max_len", "tp", "seed", "device"}; a
    list of jobs gives one result each. Returns {"tokens": (B, steps + 1)
    nested list, "kv_shard", "cache_bytes": the rank's attention buffers,
    "stats": its mesh's collectives}."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import transformer as tf

    if isinstance(job, list):
        return [rank_decode(j) for j in job]
    mesh = mesh_lib.make_host_mesh(job.get("tp", 1)) if mesh_lib._world() > 1 else None
    dev = torch.device(job.get("device", "cpu"))
    prompt = torch.as_tensor(job["prompt"], dtype=torch.int64, device=dev)
    B = prompt.shape[0]
    cfg = shd.resolve_kv_shard(job["cfg"], mesh, job["max_len"], batch=B)
    model = tf.init(cfg, seed=job.get("seed", 0), device=dev, mesh=mesh)
    cache = tf.init_cache(cfg, B, job["max_len"], torch.float32, device=dev,
                          kv_heads=shd.local_kv_heads(cfg, mesh), mesh=mesh)
    s0 = dict(mesh.stats) if mesh is not None else {}
    with torch.no_grad():
        tok = sampling.greedy_tokens(prefill_step(model, cache, prompt, cfg))
        toks = [tok]
        for _ in range(job["steps"]):
            tok = decode_step(model, cache, tok.reshape(B, 1), cfg)
            toks.append(tok)
    stats = ({k: v - s0.get(k, 0) for k, v in mesh.stats.items()}
             if mesh is not None else {})
    return {"tokens": torch.stack(toks, 1).tolist(), "kv_shard": cfg.kv_shard,
            "cache_bytes": sp.nbytes(v for layer in cache.layers if "idx" in layer
                                     for key, v in layer.items() if key != "idx"),
            "stats": stats}


def train_step(state, batch, cfg, mesh, accum: int = 1, zero1: bool = False):
    """One train step of a rank of ``mesh`` (train/step.py). Returns the
    metrics."""
    step = step_lib.make_train_step(cfg, adamw.AdamWConfig(), accum=accum,
                                    mesh=mesh, zero1=zero1)
    return step(state, batch)[1]


def rank_train_steps(job):
    """A ``run_ranks`` target (tests): ``train_step`` of each smoke config
    of ``job["archs"]`` on real CPU tensors on this rank's mesh
    (``job["tp"]``), on ``job["rows"]`` rows of ``job["seq"]`` positions
    per data rank, as ``lower_cell`` builds them. Returns {arch: the mesh
    stats it added}."""
    from repro_torch.launch import mesh as mesh_lib

    mesh = mesh_lib.make_host_mesh(job["tp"])
    out = {}
    for arch in job["archs"]:
        cfg = cell_config(arch, smoke=True, act_impl=job.get("act_impl", "exact"),
                          remat=job.get("remat", "full"))
        state = step_lib.init_state(cfg, 0, adamw.AdamWConfig(), device="cpu",
                                    mesh=mesh, zero1=job.get("zero1", False))
        g = torch.Generator().manual_seed(0)
        batch = {k: torch.randint(0, cfg.vocab_size, (job["rows"], job["seq"]),
                                  generator=g) for k in ("tokens", "labels")}
        s0 = dict(mesh.stats)
        train_step(state, batch, cfg, mesh, job.get("accum", 1), job.get("zero1", False))
        out[arch] = {k: v - s0.get(k, 0) for k, v in mesh.stats.items()}
    return out


def cell_config(arch: str, *, act_impl: str = "cordic_fixed", attn_chunk: int = 2048,
                score_dtype: str = "f32", pad_heads_to: int = 0,
                slstm_state: str = "auto", mixer_chunk: int = 0, smoke: bool = False,
                remat: str = "full", kv_shard: str = "auto"):
    """The arch's config with the cell's knobs, as the JAX ``lower_cell``
    sets them."""
    get = configs.get_smoke if smoke else configs.get_config
    cfg = get(arch, act_impl=act_impl)
    # the embeds archs are served and trained on token ids, as the port's
    # launchers take them (the engine serves token LMs)
    cfg = dataclasses.replace(cfg, input_mode="tokens", attn_chunk=attn_chunk, score_dtype=score_dtype,
                              pad_heads_to=pad_heads_to, slstm_state=slstm_state,
                              remat=remat, kv_shard=kv_shard)
    if mixer_chunk:
        if cfg.xlstm is not None:
            cfg = dataclasses.replace(cfg, xlstm=dataclasses.replace(cfg.xlstm,
                                                                     chunk=mixer_chunk))
        if cfg.ssm is not None:
            cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm,
                                                                   chunk=mixer_chunk))
    return cfg


def lower_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
               act_impl: str = "cordic_fixed", attn_chunk: int = 2048,
               score_dtype: str = "f32", pad_heads_to: int = 0,
               slstm_state: str = "auto", mixer_chunk: int = 0,
               smoke: bool = False, mesh=None, shape=None, remat: str = "full",
               accum: int = 1, zero1: bool = False, kv_shard: str = "auto") -> dict:
    """Run one (arch x shape x mesh) cell's step on meta tensors; return the
    record. ``smoke``/``mesh``/``shape``: a smoke config, another mesh, a
    ShapeConfig of other sizes (tests). ``remat``, ``accum`` and ``zero1``
    shape the train step (``remat`` also the config of a serving cell, where
    it changes nothing); ``kv_shard`` the serving cell's cache cut."""
    cfg = cell_config(arch, act_impl=act_impl, attn_chunk=attn_chunk,
                      score_dtype=score_dtype, pad_heads_to=pad_heads_to,
                      slstm_state=slstm_state, mixer_chunk=mixer_chunk, smoke=smoke,
                      remat=remat, kv_shard=kv_shard)
    shape = SHAPES[shape_name] if shape is None else shape
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "multi_pod": multi_pod,
                "status": "skipped", "reason": why}
    mesh = make_production_mesh(multi_pod=multi_pod) if mesh is None else mesh
    t0 = time.time()
    if shape.kind == "train":
        state = sp.abstract_train_state(cfg, mesh, zero1=zero1)
        batch = sp.train_input_specs(cfg, mesh, shape)
        mem = sp.memory(state.params, opt=state.opt, err=state.err)
        t_build = time.time() - t0
        _, counts = op_cost.count(train_step, state, batch, cfg, mesh, accum, zero1,
                                  mesh=mesh)
        rows = batch["tokens"].shape[0]
    else:
        cfg = shd.resolve_kv_shard(cfg, mesh, shape.seq_len, batch=shape.global_batch)
        params = sp.abstract_params(cfg, mesh)
        cache = sp.abstract_cache(cfg, mesh, shape)
        if shape.kind == "prefill":
            tokens = sp.prefill_input_specs(cfg, mesh, shape)
            step = prefill_step
        else:
            tokens = sp.decode_input_specs(cfg, mesh, shape)
            step = decode_step
        mem = sp.memory(params, cache)
        t_build = time.time() - t0
        with torch.no_grad():
            _, counts = op_cost.count(step, params, cache, tokens, cfg, mesh=mesh)
        rows = tokens.shape[0]
    t_run = time.time() - t0 - t_build
    terms = op_cost.roofline_terms(counts)
    flops = counts["flops"]
    pc = cfg.param_counts()
    tokens_step = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    # 6 N D for a train step (forward and backward), 2 N D forward only
    model_flops = (6 if shape.kind == "train" else 2) * pc["active"] * tokens_step
    return {
        "arch": arch, "shape": shape_name, "multi_pod": multi_pod,
        "mesh": list(mesh.shape.values()), "devices": int(mesh.size),
        "status": "ok", "kind": shape.kind,
        "build_s": round(t_build, 2), "run_s": round(t_run, 2),
        "rank_rows": rows,
        "flops_per_chip": flops, "hbm_bytes_per_chip": counts["hbm_bytes"],
        "collective": {
            "per_kind_bytes": counts["collective_bytes_by_kind"],
            "op_counts": counts["collective_op_counts"],
            "weighted_bytes": counts["collective_weighted_bytes"],
            "data_op_counts": counts["collective_data_op_counts"],
        },
        "op_cost": {k: counts[k] for k in ("product_flops", "other_flops",
                                            "kernel_int_ops", "kernel_bytes",
                                            "kernel_calls", "aten_ops")},
        "memory": mem,
        "roofline": terms,
        "params_total": pc["total"], "params_active": pc["active"],
        "tokens_per_step": tokens_step,
        "model_flops_global": model_flops,
        "model_flops_per_chip": model_flops / mesh.size,
        "useful_flops_ratio": (model_flops / mesh.size) / flops if flops else None,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--remat", default="full", choices=["none", "full", "dots"])
    ap.add_argument("--act-impl", default="cordic_fixed")
    ap.add_argument("--out", default=None, help="JSON output path")
    args = ap.parse_args(argv)

    cells = []
    if args.all:
        for arch in configs.ARCH_IDS:
            for shape in SHAPES:
                cells.append((arch, shape))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        cells.append((args.arch, args.shape))

    meshes = [False, True] if (args.both_meshes or args.all) else [args.multi_pod]
    results = []
    for arch, shape in cells:
        for mp in meshes:
            tag = f"{arch} x {shape} x {'2x16x16' if mp else '16x16'}"
            try:
                rec = lower_cell(arch, shape, multi_pod=mp, remat=args.remat,
                                 act_impl=args.act_impl)
                if rec["status"] == "ok":
                    r = rec["roofline"]
                    print(f"[dryrun] OK   {tag}: run {rec['run_s']}s "
                          f"compute {r['compute_s']:.3e}s memory {r['memory_s']:.3e}s "
                          f"coll {r['collective_s']:.3e}s dom={r['dominant']}")
                    print(f"         mem: {rec['memory']}")
                else:
                    print(f"[dryrun] SKIP {tag}: {rec['reason']}")
            except Exception as e:                           # noqa: BLE001
                rec = {"arch": arch, "shape": shape, "multi_pod": mp,
                       "status": "error", "error": repr(e),
                       "trace": traceback.format_exc()[-2000:]}
                print(f"[dryrun] FAIL {tag}: {e!r}")
            results.append(rec)
            sys.stdout.flush()

    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
        print(f"[dryrun] wrote {args.out}")
    n_ok = sum(r["status"] == "ok" for r in results)
    n_skip = sum(r["status"] == "skipped" for r in results)
    n_err = sum(r["status"] == "error" for r in results)
    print(f"[dryrun] done: {n_ok} ok, {n_skip} skipped, {n_err} errors")
    return 0 if n_err == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
