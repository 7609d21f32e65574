"""Serving launcher CLI (port of ``repro/launch/serve.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-9b \
        --requests 8 --slots 4
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch deepseek-v2-lite-16b --smoke --device cpu

Boots the paged continuous-batching engine for a registered arch with
random weights from a seed, on the card (``--device cuda``, the default) or
on the CPU through the plain versions of the kernels (``--device cpu``,
with ``--smoke`` for a config the CPU can run). Takes the JAX launcher's
flags; the ones this port does not serve yet raise. ``--act-impl`` takes the
activation registry's four datapaths (``core/activations.ACT_IMPLS``;
``cordic_pallas``, the CUDA kernels, by default). The attention softmax is
the CORDIC kernel (``softmax_impl="cordic_pallas"``); other softmax impls
are set through ``ServeEngine(softmax_impl=...)``.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import configs
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
                    help="0 = greedy (sampling is ROADMAP A.7)")
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--kv-impl", default="paged", choices=["dense", "paged"])
    ap.add_argument("--block-len", type=int, default=16)
    ap.add_argument("--num-blocks", type=int, default=0,
                    help="paged pool size incl. scratch (0 = worst case)")
    ap.add_argument("--paged-attend-impl", default="pallas",
                    choices=["gather", "pallas"],
                    help="paged decode attend: table gather or the decode "
                         "kernel")
    ap.add_argument("--kv-quant", default="none",
                    choices=["none", "int8", "q2_14"])
    ap.add_argument("--prefill-chunk", type=int, default=0)
    ap.add_argument("--prefill-batch", type=int, default=0)
    ap.add_argument("--max-prefill-tokens", type=int, default=0)
    ap.add_argument("--prefix-cache", action="store_true")
    ap.add_argument("--prefix-eviction", default="lru", choices=["lru", "fifo"])
    ap.add_argument("--tp", type=int, default=0)
    ap.add_argument("--metrics-json", default=None)
    ap.add_argument("--trace-out", default=None)
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.metrics_json or args.trace_out:
        raise NotImplementedError("observability is not ported yet "
                                  "(ROADMAP A.8)")
    cfg = (configs.get_smoke(args.arch, act_impl=args.act_impl) if args.smoke
           else configs.get_config(args.arch, act_impl=args.act_impl))
    print(f"[serve] arch={cfg.name} slots={args.slots} kv={args.kv_impl} "
          f"attend={args.paged_attend_impl} device={args.device}")
    params = tf.init(cfg, seed=0, device=args.device)
    eng = ServeEngine(cfg, params, slots=args.slots, max_len=args.max_len,
                      sampling=SamplingParams(temperature=args.temperature,
                                              top_k=args.top_k),
                      softmax_impl="cordic_pallas", kv_impl=args.kv_impl,
                      block_len=args.block_len,
                      num_blocks=args.num_blocks or None,
                      paged_attend_impl=args.paged_attend_impl,
                      kv_quant=args.kv_quant,
                      prefill_chunk=args.prefill_chunk or None,
                      prefill_batch=args.prefill_batch or None,
                      max_prefill_tokens=args.max_prefill_tokens or None,
                      prefix_cache=args.prefix_cache,
                      prefix_eviction=args.prefix_eviction,
                      tp=args.tp or None, device=args.device)
    for r in make_requests(cfg, args.requests, args.max_new):
        eng.submit(r)
    t0 = time.perf_counter()
    done = eng.run()
    if eng.device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    total = sum(len(r.out) for r in done)
    print(f"[serve] {len(done)} requests, {total} tokens, {dt:.3f}s")
    st = eng.pager.stats()
    print(f"[serve] pool: peak {st.peak_in_use}/{st.num_blocks - 1} blocks x "
          f"{eng.block_len} positions, {st.allocs} allocs, "
          f"{st.alloc_failures} backpressure waits")
    assert len(done) == args.requests
    return 0


def make_requests(cfg, n: int, max_new: int, seed: int = 0):
    """The JAX launcher's traffic: prompts of 4-11 random tokens."""
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        prompt = rng.integers(0, cfg.vocab_size,
                              int(rng.integers(4, 12))).astype(np.int32)
        reqs.append(Request(rid=i, prompt=prompt, max_new_tokens=max_new))
    return reqs


if __name__ == "__main__":
    raise SystemExit(main())
