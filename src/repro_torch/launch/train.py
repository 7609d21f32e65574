"""Training launcher CLI (port of ``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch yi-9b --smoke \
        --steps 5 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch deepseek-v2-lite-16b --smoke --steps 5 --device cpu --compress

Runs the fault-tolerant training loop (train/loop.py) for any registered
arch, on the card (``--device cuda``, the default) or on the CPU through the
plain versions of the kernels (``--device cpu``, with ``--smoke`` for a
config the CPU can run). Takes the JAX launcher's flags: ``--compress``
runs the int8 error-feedback gradient compression
(distributed/compression.py), and ``--act-impl`` the activation registry's
four datapaths (``core/activations.ACT_IMPLS``; ``cordic_pallas``, the CUDA
kernels, by default; the JAX launcher's default is ``cordic_fixed``). The
attention softmax and the loss log-softmax run on the CORDIC kernels
(``softmax_impl`` and ``loss_impl`` ``"cordic_pallas"``); the config's
``remat`` applies. The embeds archs (musicgen-large, internvl2-1b), whose
frontends are stubs, train on token ids, as the JAX launcher trains them.

``rank_train`` is the train step on a ("data", "model") mesh of spawned
ranks (``launch/mesh.run_ranks(rank_train, world, job)``); the launcher
itself keeps the JAX launcher's flags, which have no mesh.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile

from repro_torch import configs
from repro_torch.core.activations import ACT_IMPLS
from repro_torch.optim import adamw
from repro_torch.train import loop as loop_lib


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list(configs.ARCH_IDS))
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    ap.add_argument("--act-impl", default="cordic_pallas", choices=ACT_IMPLS,
                    help="activation datapath (default: the CORDIC kernels)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(), "repro_torch_train"))
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--compress", action="store_true",
                    help="int8 error-feedback gradient compression")
    ap.add_argument("--lr", type=float, default=3e-4)
    return ap


def rank_device(dev: str, rank: int, backend: str) -> str:
    """The device of one rank of a group: under NCCL the rank's own card
    (``launch/mesh._rank_entry`` made it current; NCCL refuses two ranks on
    one card), under gloo on a card the one card every rank shares
    (``cuda:0``), and the CPU as given."""
    import torch

    if not dev.startswith("cuda"):
        return dev
    card = rank if backend == "nccl" else 0
    torch.cuda.set_device(card)
    return f"cuda:{card}"


def rank_train(job):
    """A ``launch/mesh.run_ranks`` target: ``job["steps"]`` train steps of
    one rank of a (world / tp, tp) ("data", "model") mesh (train/step.py).

    job: ``cfg`` (a ModelConfig), ``tp``, ``batch`` {name: (B, S) numpy
    array of the global batch; the rank takes its data rank's share of
    each microbatch, ``step.rank_rows``},
    ``steps``, and optionally ``seed`` (0), ``device`` ("cpu"), ``accum``
    (1), ``compress`` / ``zero1`` (False), ``lr`` (3e-4), ``warmup_steps``
    (0), ``total_steps`` (100), ``grads`` (also return step 0's reduced
    gradients as whole leaves, before the update, and with ``compress``
    their int8 round trip from zero buffers: "compressed", "residual"),
    ``tree`` (also return the state after the steps,
    ``step.gathered_tree``), ``before`` / ``after`` ((fn, payload): a
    caller's probe run on every rank as ``fn(payload, state, batch, cfg,
    mesh)`` before the first step and after the last, its result returned
    under the same key).

    Returns {"losses", "grad_norms", "step_ms", "stats": the mesh's
    collective counts of the last step, "grads", "tree"}, the arrays on
    data rank 0's model ranks only (None elsewhere)."""
    import time

    import numpy as np
    import torch

    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.train import step as step_lib

    mesh = mesh_lib.make_host_mesh(job["tp"])
    cfg = job["cfg"]
    dev = rank_device(job.get("device", "cpu"), mesh.rank, mesh.backend)
    state = step_lib.init_state(cfg, job.get("seed", 0), adamw.AdamWConfig(),
                                compress=job.get("compress", False), device=dev,
                                mesh=mesh, zero1=job.get("zero1", False))
    accum = job.get("accum", 1)
    rows = step_lib.rank_rows(next(iter(job["batch"].values())).shape[0], mesh, accum)
    batch = {k: torch.as_tensor(np.ascontiguousarray(v[rows]), device=dev)
             for k, v in job["batch"].items()}
    step = step_lib.make_train_step(
        cfg, adamw.AdamWConfig(lr=job.get("lr", 3e-4)), accum=accum,
        compress=job.get("compress", False), mesh=mesh,
        zero1=job.get("zero1", False), warmup_steps=job.get("warmup_steps", 0),
        total_steps=job.get("total_steps", 100))
    keep = mesh.data_rank == 0
    out = {"losses": [], "grad_norms": [], "step_ms": [], "stats": None,
           "grads": None, "tree": None, "before": None, "after": None}
    host = lambda named: ({k: v.detach().to("cpu", copy=True).numpy()
                           for k, v in shd.full_tensors(state.params, named).items()}
                          if keep else None)
    if job.get("grads"):
        _, _, g = step_lib.grads_of(state.params, batch, cfg)
        step_lib.reduce_grads(state.params, g, cfg, mesh)
        out["grads"] = host(g)
        if job.get("compress"):
            # the round trip of these gradients from zero buffers
            err = {k: torch.zeros_like(v) for k, v in g.items()}
            step_lib.compress_(g, err, mesh)
            out["compressed"], out["residual"] = host(g), host(err)
    if job.get("before"):
        fn, payload = job["before"]
        out["before"] = fn(payload, state, batch, cfg, mesh)
    for _ in range(job["steps"]):
        s0 = dict(mesh.stats)
        if dev.startswith("cuda"):
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        out["losses"].append(float(m["loss"]))
        out["grad_norms"].append(float(m["grad_norm"]))
        out["step_ms"].append((time.perf_counter() - t0) * 1e3)
        out["stats"] = {k: v - s0.get(k, 0) for k, v in mesh.stats.items()}
    if dev.startswith("cuda"):
        torch.cuda.synchronize()
    if job.get("after"):
        fn, payload = job["after"]
        out["after"] = fn(payload, state, batch, cfg, mesh)
    if job.get("tree"):
        tree = step_lib.gathered_tree(state, mesh, job.get("zero1", False))
        out["tree"] = tree if keep else None
    return out


def main(argv=None):
    args = build_parser().parse_args(argv)
    cfg = (configs.get_smoke(args.arch, act_impl=args.act_impl) if args.smoke
           else configs.get_config(args.arch, act_impl=args.act_impl))
    cfg = dataclasses.replace(cfg, softmax_impl="cordic_pallas",
                              loss_impl="cordic_pallas", input_mode="tokens")
    print(f"[train] arch={cfg.name} params={cfg.param_counts()['total'] / 1e6:.1f}M "
          f"act={cfg.act_impl} compress={args.compress} remat={cfg.remat} "
          f"device={args.device}")

    lc = loop_lib.LoopConfig(total_steps=args.steps, ckpt_every=args.ckpt_every,
                             ckpt_dir=args.ckpt_dir, accum=args.accum,
                             compress=args.compress)
    out = loop_lib.run(cfg, lc, opt_cfg=adamw.AdamWConfig(lr=args.lr),
                       device=args.device)
    print(f"[train] final loss {out['final_loss']:.4f} after "
          f"{len(out['history'])} steps; restarts={out['restarts']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
