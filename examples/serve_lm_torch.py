"""Batched serving demo on the PyTorch / CUDA port: continuous batching with
CORDIC activations.

    PYTHONPATH=src python examples/serve_lm_torch.py [--requests 8] [--slots 4] \
        [--temperature 0.8] [--top-k 40]                     # on the card
    PYTHONPATH=src python examples/serve_lm_torch.py --device cpu --requests 4 \
        --slots 2 --max-new 8

The torch lane of ``examples/serve_lm.py``: the same small GQA LM (random
weights from a seed), the same request queue and flags, served by
``repro_torch.serve.engine.ServeEngine``. Every step runs the prefill
phase, then one batched decode for all slots, the slots refilled from the
queue as requests finish. ``--kv-impl paged`` swaps the per-slot dense
caches for a global block pool with per-slot block tables; ``--paged-attend-impl
pallas`` walks each slot's live blocks with the CUDA decode kernel (on the
card; the CPU runs its plain version); ``--prefill-chunk`` streams long
prompts in block-aligned chunks; ``--kv-quant`` stores the pools as int8 or
Q2.14 codes; ``--prefix-cache`` shares a system prompt's KV blocks across
requests. Sampling is the CORDIC sampler with per-request keys.
``--tp N`` serves tensor-parallel over N ranks, one process each
(``launch/mesh.run_ranks``: NCCL with a card a rank, gloo when they share
one or on the CPU); every rank serves the same requests and rank 0 prints.
``--metrics-json`` / ``--trace-out`` attach the observability layer.
The dense plane's KV cut over tp follows the config's ``kv_shard`` field
(``"seq_model"`` cuts the positions, as in the JAX package; set it on the
config).
"""
import argparse
import sys
import time

sys.path.insert(0, "src")

import numpy as np

from repro_torch import obs as obs_lib
from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tf
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.sampling import SamplingParams


def build_parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels, the default) or cpu (their plain versions)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--act", default="cordic_pallas",
                    choices=["exact", "cordic_float", "cordic_fixed", "cordic_pallas"])
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature; 0 = greedy (default)")
    ap.add_argument("--top-k", type=int, default=0, help="top-k filtering; 0 = full vocab")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kv-impl", default="dense", choices=["dense", "paged"])
    ap.add_argument("--block-len", type=int, default=16)
    ap.add_argument("--paged-attend-impl", default="gather", choices=["gather", "pallas"])
    ap.add_argument("--kv-quant", default="none", choices=["none", "int8", "q2_14"])
    ap.add_argument("--prefill-chunk", type=int, default=0)
    ap.add_argument("--prefill-batch", type=int, default=0)
    ap.add_argument("--max-prefill-tokens", type=int, default=0)
    ap.add_argument("--prefix-cache", action="store_true")
    ap.add_argument("--prefix-eviction", default="lru", choices=["lru", "fifo"])
    ap.add_argument("--tp", type=int, default=0,
                    help="tensor-parallel ranks, one process each (0/1: none)")
    ap.add_argument("--metrics-json", default=None)
    ap.add_argument("--trace-out", default=None)
    return ap


def demo_cfg(act: str) -> ModelConfig:
    return ModelConfig(name="serve-demo", family="dense", num_layers=4, d_model=256,
                       num_heads=8, num_kv_heads=4, d_ff=768, vocab_size=4096,
                       act_impl=act, rope_theta=1e4, dtype="float32")


def serve(args, mesh=None):
    """Serve the demo queue on this process (one rank of ``mesh``)."""
    cfg = demo_cfg(args.act)
    rank0 = mesh is None or mesh.rank == 0
    say = print if rank0 else (lambda *a, **k: None)
    say(f"[serve_lm_torch] model {cfg.param_counts()['total'] / 1e6:.1f}M params, "
        f"act_impl={cfg.act_impl}, slots={args.slots}, kv_impl={args.kv_impl}, "
        f"kv_quant={args.kv_quant}, T={args.temperature}, top_k={args.top_k}, "
        f"device={args.device}")
    params = tf.init(cfg, seed=0, device=args.device, mesh=mesh)
    obs = (obs_lib.Observability(trace=args.trace_out is not None)
           if (args.metrics_json or args.trace_out) else None)
    eng = ServeEngine(cfg, params, slots=args.slots, max_len=128,
                      sampling=SamplingParams(temperature=args.temperature,
                                              top_k=args.top_k),
                      seed=args.seed, kv_impl=args.kv_impl, block_len=args.block_len,
                      paged_attend_impl=args.paged_attend_impl, kv_quant=args.kv_quant,
                      prefill_chunk=args.prefill_chunk or None,
                      prefill_batch=args.prefill_batch or None,
                      max_prefill_tokens=args.max_prefill_tokens or None,
                      prefix_cache=args.prefix_cache,
                      prefix_eviction=args.prefix_eviction,
                      mesh=mesh, obs=obs, device=args.device)
    if eng.mesh is not None:
        say(f"[serve_lm_torch] mesh: {dict(eng.mesh.shape)} over {eng.mesh.size} ranks, "
            f"backend {eng.mesh.backend}")
    rng = np.random.default_rng(0)
    # a shared system prompt (two full KV blocks) so --prefix-cache hits
    sys_prompt = (rng.integers(0, cfg.vocab_size, 2 * args.block_len).astype(np.int32)
                  if args.prefix_cache else np.zeros(0, np.int32))
    reqs = []
    for i in range(args.requests):
        tail = rng.integers(0, cfg.vocab_size, int(rng.integers(4, 12))).astype(np.int32)
        r = Request(rid=i, prompt=np.concatenate([sys_prompt, tail]),
                    max_new_tokens=args.max_new)
        reqs.append(r)
        eng.submit(r)
    t0 = time.time()
    steps = 0
    while eng.step():
        steps += 1
    wall = time.time() - t0
    done = eng.run()
    total_new = sum(len(r.out) for r in reqs)
    say(f"[serve_lm_torch] served {len(done)} requests / {total_new} tokens in "
        f"{steps} engine steps, {wall:.1f}s ({total_new / wall:.1f} tok/s, host clock)")
    if eng.pager is not None:
        st = eng.pager.stats()
        say(f"[serve_lm_torch] pool: peak {st.peak_in_use}/{st.num_blocks - 1} blocks x "
            f"{eng.block_len} positions (dense would pin {args.slots * 128 // eng.block_len})")
    if eng.prefix is not None:
        say(f"[serve_lm_torch] prefix cache ({eng.prefix.policy}): {eng.prefix.hits} hits "
            f"/ {eng.prefix.hit_blocks} blocks reused, {eng.prefix.evicted_blocks} evicted")
    if obs is not None and rank0:
        ttft = obs.metrics.get("engine.ttft_ms")
        say(f"[serve_lm_torch] ttft p50/p99 {ttft.quantile(0.5):.1f}/"
            f"{ttft.quantile(0.99):.1f} ms over {ttft.count} requests")
        if args.metrics_json:
            obs.metrics.to_json(args.metrics_json)
            say(f"[serve_lm_torch] wrote metrics -> {args.metrics_json}")
        if args.trace_out:
            obs.trace.export(args.trace_out)
            say(f"[serve_lm_torch] wrote Chrome trace -> {args.trace_out}")
    for r in reqs[:3]:
        say(f"  req {r.rid}: prompt={r.prompt.tolist()} -> out={r.out}")
    assert all(r.done for r in reqs)
    assert sorted(r.rid for r in done) == sorted(r.rid for r in reqs)
    say("[serve_lm_torch] OK — all requests completed.")
    return {r.rid: list(r.out) for r in reqs}


def _rank(argv):
    """One rank of ``--tp``: the demo on this rank's mesh."""
    from repro_torch.launch import mesh as mesh_lib

    args = build_parser().parse_args(argv)
    return serve(args, mesh_lib.make_host_mesh(args.tp))


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    args = build_parser().parse_args(argv)
    if args.tp > 1:
        from repro_torch.launch import mesh as mesh_lib

        if args.device.startswith("cuda"):
            from repro_torch.kernels import build

            build.build_all()          # once, before the ranks load it
        outs = mesh_lib.run_ranks(_rank, args.tp, argv, quiet=True, timeout=3600,
                                  backend=mesh_lib.pick_backend(args.tp, args.device))
        assert all(o == outs[0] for o in outs), "the ranks emitted other tokens"
        return 0
    serve(args)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
