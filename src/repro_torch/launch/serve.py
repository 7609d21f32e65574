"""Serving launcher CLI (port of ``repro/launch/serve.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-9b \
        --requests 8 --slots 4
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch deepseek-v2-lite-16b --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-9b \
        --smoke --device cpu --kv-quant int8 --prefix-cache
    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-9b \
        --smoke --device cpu --prefill-chunk 16 --prefill-batch 2
    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-9b \
        --smoke --device cpu --kv-impl dense --temperature 0.8 --top-k 40 \
        --metrics-json metrics.json --trace-out trace.json
    PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-1.3b \
        --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch musicgen-large \
        --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-9b \
        --smoke --device cpu --tp 2

Boots the continuous-batching engine for a registered arch with random
weights from a seed, on the card (``--device cuda``, the default) or on the
CPU through the plain versions of the kernels (``--device cpu``, with
``--smoke`` for a config the CPU can run). Takes every flag of the JAX
launcher. ``--tp N`` serves tensor-parallel over N ranks, one process each
(launch/mesh.py ``run_ranks``; NCCL when each rank has a card of its own,
gloo when they share one or on the CPU; the kernels are built before the
ranks start): every rank builds its shard of the same seeded weights and
serves the same traffic, rank 0 prints, with one ``[serve] mesh:`` line.
The recurrent archs serve so too, on the dense plane (each rank runs its
heads of every mixer whose heads divide N). ``--act-impl`` takes the
activation registry's four datapaths (``core/activations.ACT_IMPLS``;
``cordic_pallas``, the CUDA kernels, by default). The attention softmax is
the CORDIC kernel (``softmax_impl="cordic_pallas"``); other softmax impls
are set through ``ServeEngine(softmax_impl=...)``.

``--kv-impl`` stays ``paged`` by default here (the JAX launcher's is
``dense``) for attention-only archs; ``--kv-impl dense`` serves from one
max_len buffer per slot, the default for the recurrent archs (xlstm-1.3b,
zamba2-1.2b), which prefill at exact length and have no other plane: an
explicit ``--kv-impl paged`` raises there, as in JAX.
``--paged-attend-impl`` defaults to the decode kernel (``pallas``) on the
paged plane and to ``gather`` on the dense one, which has no block tables:
an explicit ``pallas`` with ``--kv-impl dense`` raises, as in JAX.
``--temperature`` / ``--top-k`` sample every request (0 = greedy) with the
JAX sampler's keys. ``--kv-quant`` stores the GQA pools as int8 or Q2.14
codes with per-block scales; ``--prefix-cache`` turns on the radix prefix
cache and, as the JAX launcher does, prepends one shared system prompt of
two blocks to every request so that later admissions hit it.
musicgen-large and internvl2-1b, whose frontends are stubs
(``input_mode="embeds"``), are served on token ids, as the JAX launcher
serves them. ``--prefill-chunk`` streams long prompts in block-aligned chunks
interleaved with decode steps, ``--prefill-batch`` packs that many prefill
rows into one dispatch (default: ``--slots`` when chunking the paged
plane, else 1; with ``--prefix-cache`` on a model without MoE layers only
1) and ``--max-prefill-tokens`` caps the prefill tokens of an iteration.
``--metrics-json`` / ``--trace-out`` serve with observability on, inside
``observe_saturation``, print TTFT p50/p99 and TPOT p50, and write the
metrics snapshot / the Chrome trace.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch import obs as obs_lib
from repro_torch.core.activations import ACT_IMPLS
from repro_torch.models import transformer as tf
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.sampling import SamplingParams


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list(configs.ARCH_IDS))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    ap.add_argument("--act-impl", default="cordic_pallas", choices=ACT_IMPLS,
                    help="activation datapath: the CORDIC kernels "
                         "(cordic_pallas), the plain Q2.14 library "
                         "(cordic_fixed), its float twin or torch's own")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature (CORDIC datapath); 0 = greedy")
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--kv-impl", default=None, choices=["dense", "paged"],
                    help="decode KV layout: the global block pool or one "
                         "max_len buffer per slot (default: paged, and dense "
                         "for an arch with recurrent blocks, which has no "
                         "other)")
    ap.add_argument("--block-len", type=int, default=16)
    ap.add_argument("--num-blocks", type=int, default=0,
                    help="paged pool size incl. scratch (0 = worst case)")
    ap.add_argument("--paged-attend-impl", default=None,
                    choices=["gather", "pallas"],
                    help="paged decode attend: table gather or the decode "
                         "kernel (default: pallas on the paged plane, gather "
                         "on the dense one)")
    ap.add_argument("--kv-quant", default="none",
                    choices=["none", "int8", "q2_14"],
                    help="paged-pool storage: float32, or int8 / Q2.14 "
                         "codes with per-block per-head scales")
    ap.add_argument("--prefill-chunk", type=int, default=0)
    ap.add_argument("--prefill-batch", type=int, default=0)
    ap.add_argument("--max-prefill-tokens", type=int, default=0)
    ap.add_argument("--prefix-cache", action="store_true",
                    help="radix prefix cache over the paged pool; the "
                         "requests share a system prompt of two blocks")
    ap.add_argument("--prefix-eviction", default="lru", choices=["lru", "fifo"])
    ap.add_argument("--tp", type=int, default=0,
                    help="tensor-parallel ranks (one process each; 0/1: none)")
    ap.add_argument("--metrics-json", default=None,
                    help="write the metrics registry's snapshot here")
    ap.add_argument("--trace-out", default=None,
                    help="write a Chrome trace (Perfetto) of the requests "
                         "and the engine's phases here")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.tp > 1:
        from repro_torch.launch import mesh as mesh_lib

        backend = mesh_lib.pick_backend(args.tp, args.device)
        if args.device.startswith("cuda"):
            from repro_torch.kernels import build

            build.build_all()          # once, before the ranks load it
        mesh_lib.run_ranks(_rank_main, args.tp, argv, backend=backend,
                           timeout=3600)
        return 0
    return serve(args)


def _rank_main(argv):
    """One rank of ``--tp``: the launcher over this rank's mesh."""
    from repro_torch.launch import mesh as mesh_lib

    args = build_parser().parse_args(argv)
    return serve(args, mesh_lib.make_host_mesh(args.tp))


def serve(args, mesh=None):
    """The launcher's serve of ``args`` (on one rank's ``mesh`` when
    given)."""
    cfg = (configs.get_smoke(args.arch, act_impl=args.act_impl) if args.smoke
           else configs.get_config(args.arch, act_impl=args.act_impl))
    if cfg.input_mode != "tokens":
        # the embeds archs' frontends are stubs: serve their backbone on
        # token ids, as the JAX launcher does (the engine serves token LMs)
        cfg = dataclasses.replace(cfg, input_mode="tokens")
    # the recurrent archs have the dense plane only
    args.kv_impl = args.kv_impl or ("paged" if tf.attention_only(cfg) else "dense")
    attend = args.paged_attend_impl or (
        "pallas" if args.kv_impl == "paged" else "gather")
    obs = (obs_lib.Observability(trace=args.trace_out is not None)
           if (args.metrics_json or args.trace_out) else None)
    print(f"[serve] arch={cfg.name} slots={args.slots} kv={args.kv_impl} "
          f"kv_quant={args.kv_quant} attend={attend} "
          f"temperature={args.temperature} top_k={args.top_k} "
          f"device={args.device} tp={args.tp or 1}")
    params = tf.init(cfg, seed=0, device=args.device, mesh=mesh)
    eng = ServeEngine(cfg, params, slots=args.slots, max_len=args.max_len,
                      sampling=SamplingParams(temperature=args.temperature,
                                              top_k=args.top_k),
                      softmax_impl="cordic_pallas", kv_impl=args.kv_impl,
                      block_len=args.block_len,
                      num_blocks=args.num_blocks or None,
                      paged_attend_impl=attend,
                      kv_quant=args.kv_quant,
                      prefill_chunk=args.prefill_chunk or None,
                      prefill_batch=args.prefill_batch or None,
                      max_prefill_tokens=args.max_prefill_tokens or None,
                      prefix_cache=args.prefix_cache,
                      prefix_eviction=args.prefix_eviction,
                      mesh=mesh, obs=obs, device=args.device)
    if eng.mesh is not None:
        print(f"[serve] mesh: {dict(eng.mesh.shape)} over {eng.mesh.size} "
              f"ranks, backend {eng.mesh.backend}, CUDA tensors staged "
              f"through host memory: "
              f"{'yes' if eng.mesh.staged and eng.device.type == 'cuda' else 'no'}")
    prefix_len = 2 * args.block_len if args.prefix_cache else 0
    for r in make_requests(cfg, args.requests, args.max_new,
                           prefix_len=prefix_len):
        eng.submit(r)
    t0 = time.perf_counter()
    if obs is not None:
        # count the plain quantizes' clips into the same registry
        with obs_lib.observe_saturation(obs.metrics):
            done = eng.run()
    else:
        done = eng.run()
    if eng.device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    total = sum(len(r.out) for r in done)
    print(f"[serve] {len(done)} requests, {total} tokens, {dt:.3f}s")
    if eng.pager is not None:
        st = eng.pager.stats()
        print(f"[serve] pool: peak {st.peak_in_use}/{st.num_blocks - 1} blocks x "
              f"{eng.block_len} positions, {st.allocs} allocs, "
              f"{st.alloc_failures} backpressure waits; "
              f"{eng.kv_pool_bytes()} pool bytes, "
              f"{eng.decode_workspace_bytes()} decode workspace bytes per call")
    else:
        print(f"[serve] dense caches: {eng.kv_cache_bytes()} bytes "
              f"({args.slots} slots x {args.max_len} positions)")
    if eng.prefix is not None:
        print(f"[serve] prefix cache ({eng.prefix.policy}): "
              f"{eng.prefix.hits} hits / {eng.prefix.hit_blocks} blocks "
              f"reused, {eng.prefix.evicted_blocks} evicted")
    if obs is not None:
        m = obs.metrics
        ttft, tpot = m.get("engine.ttft_ms"), m.get("engine.tpot_ms")
        print(f"[serve] ttft p50/p99 {ttft.quantile(0.5):.1f}/"
              f"{ttft.quantile(0.99):.1f} ms, tpot p50 "
              f"{tpot.quantile(0.5):.2f} ms "
              f"({int(m.get('engine.tokens.emitted').value)} tok)")
        if args.metrics_json:
            m.to_json(args.metrics_json)
            print(f"[serve] wrote metrics -> {args.metrics_json}")
        if args.trace_out:
            obs.trace.export(args.trace_out)
            print(f"[serve] wrote Chrome trace -> {args.trace_out} "
                  "(load at ui.perfetto.dev)")
    if eng.mesh is not None:
        st = eng.mesh.stats
        print(f"[serve] collectives on the model axis: {st['all_reduce']} "
              f"all-reduces, {st['bytes']} bytes")
    assert len(done) == args.requests
    return 0


def make_requests(cfg, n: int, max_new: int, seed: int = 0, prefix_len: int = 0):
    """The JAX launcher's traffic: prompts of 4-11 random tokens, after a
    shared system prompt of ``prefix_len`` tokens (drawn first)."""
    rng = np.random.default_rng(seed)
    sys_prompt = rng.integers(0, cfg.vocab_size, prefix_len).astype(np.int32)
    reqs = []
    for i in range(n):
        tail = rng.integers(0, cfg.vocab_size,
                            int(rng.integers(4, 12))).astype(np.int32)
        reqs.append(Request(rid=i, prompt=np.concatenate([sys_prompt, tail]),
                            max_new_tokens=max_new))
    return reqs


def rank_serve(job):
    """A ``run_ranks`` target (tests, tools): serve request traces on this
    rank; ``job`` a dict or a list of them (one result each). A dict:
    {"cfg", "flat" (JAX-layout weights, ``load_jax_params``) or "seed",
    "device", "tp", "cases": [{"engine": ServeEngine kwargs,
    "requests": [(rid, prompt, max_new_tokens, SamplingParams or None)],
    "scores": [prompts], "obs": bool}]}. Returns {"cases": [{"tokens": {rid:
    out}, "tp", "pool_shapes", "kv_pool_bytes", "gauges", "collectives",
    "scores", "prefix_hits"}]}, from this rank."""
    from repro_torch.launch import mesh as mesh_lib

    if isinstance(job, list):
        return [rank_serve(j) for j in job]
    cfg, dev, tp = job["cfg"], job.get("device", "cpu"), job["tp"]
    mesh = mesh_lib.mesh_or_none(tp)
    if "flat" in job:
        model = tf.load_jax_params(cfg, job["flat"], device=dev, mesh=mesh)
    else:
        model = tf.init(cfg, seed=job.get("seed", 0), device=dev, mesh=mesh)
    out = []
    for case in job["cases"]:
        obs = obs_lib.Observability() if case.get("obs") else None
        eng = ServeEngine(cfg, model, mesh=mesh, obs=obs, device=dev,
                          **case["engine"])
        n0 = dict(mesh.stats) if mesh is not None else {}
        reqs = [Request(rid=rid, prompt=np.asarray(p, np.int32),
                        max_new_tokens=n, sampling=samp)
                for rid, p, n, samp in case["requests"]]
        for r in reqs:
            eng.submit(r)
        eng.run()
        assert all(r.done and r.error is None for r in reqs), \
            [r.error for r in reqs]
        layer = eng._caches.layers[0]
        res = {"tokens": {r.rid: list(r.out) for r in reqs}, "tp": eng.tp,
               "kv_shard": eng.cfg.kv_shard,
               "pool_shapes": {k: tuple(v.shape) for k, v in layer.items()
                               if k.endswith("_pool")
                               or k in ("k", "v", "c_kv", "k_rope")},
               "state_shapes": [{k: tuple(v.shape) for k, v in c.items() if k != "idx"}
                                for c in getattr(eng._caches, "layers", [])],
               "state_bytes": eng.state_bytes(),
               "kv_pool_bytes": eng.kv_pool_bytes(),
               "scores": [eng.score(np.asarray(p, np.int32))
                          for p in case.get("scores", ())],
               "prefix_hits": (eng.prefix.hits, eng.prefix.hit_blocks)
               if eng.prefix is not None else None,
               "collectives": {k: v - n0.get(k, 0) for k, v in
                               (mesh.stats.items() if mesh is not None else ())}}
        if obs is not None:
            m = obs.metrics
            res["gauges"] = {"tp": m.get("engine.mesh.tp").last,
                             "devices": m.get("engine.mesh.devices").last,
                             "collective_count": (
                                 m.get("engine.phase.collective_ms").count
                                 if "engine.phase.collective_ms" in m.names()
                                 else 0)}
        out.append(res)
    return {"cases": out}


def rank_attend(job):
    """A ``run_ranks`` target (tests, tools): each attention sublayer of a
    seeded model on this rank's shard, through a fresh dense cache of
    ``job["max_len"]`` positions (the rank's span of them under
    ``kv_shard="seq_model"``): a prefill of ``job["x"]`` (B, S, d) at
    positions 0, then one decode position ``job["x1"]`` (B, 1, d). job:
    {"cfg", "seed", "tp", "x", "x1", "max_len"}. Returns [(name, prefill
    output, decode output, the cache's K / latent shape)] as float32 numpy,
    the blocks' attention in order, then the shared block's; for a list of
    jobs, one such list each."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import attention as attn

    if isinstance(job, list):
        return [rank_attend(j) for j in job]
    mesh = mesh_lib.mesh_or_none(job["tp"])
    cfg = shd.resolve_kv_shard(job["cfg"], mesh, job["max_len"])
    model = tf.init(cfg, seed=job.get("seed", 0), device="cpu", mesh=mesh)
    apply = attn.mla_apply if cfg.mla is not None else attn.gqa_apply
    x, x1 = (torch.as_tensor(job[k]).to(model.embed.dtype) for k in ("x", "x1"))
    sites = [(f"block {i}", blk.attn, i) for i, blk in enumerate(model.blocks)
             if hasattr(blk, "attn")]
    if model.shared is not None:
        sites.append(("shared", model.shared.attn, len(cfg.block_pattern)))
    out = []
    with torch.no_grad(), shd.serving_mesh(mesh):
        for name, mod, layer in sites:
            cache = tf.init_cache(cfg, x.shape[0], job["max_len"], device="cpu",
                                  kv_heads=shd.local_kv_heads(cfg, mesh), mesh=mesh)
            c = cache.layers[layer]
            y = apply(mod, x, cfg, cache=c)
            cache.idx += x.shape[1]
            y1 = apply(mod, x1, cfg, cache=c)
            kv = c["k"] if "k" in c else c["c_kv"]
            out.append((name, y.float().numpy(), y1.float().numpy(), tuple(kv.shape)))
    return out


if __name__ == "__main__":
    raise SystemExit(main())
