"""Serving times of whichever ``repro_torch`` is on PYTHONPATH, so that two
trees of the port can be timed against each other on one card:

    PYTHONPATH=<tree>/src python src/repro_torch/launch/serve_timing.py \
        --label parent --out chiprun_out/serve_timing.jsonl

Run by path (not with ``-m``), so that an older tree's package is the one
timed. Builds ``--arch`` (Yi-9B or DeepSeek-V2-Lite) at full width (random
weights, seed 0, the CORDIC kernels on) and measures, on the card:

1. the launcher's traffic (8 greedy requests of 4-11 tokens, 16 new tokens,
   4 slots, max_len 128, float32 pools, the decode kernel): tok/s, step p50
   and TTFT p50, host clock, after one warm-up request, ``--repeats``
   times on one engine, and the greedy tokens; then ``--profile-steps``
   decode steps of 4 fresh requests under torch.profiler: the device's
   busy and idle share and the decode kernels' device ms per step;
2. one prefill of a ``--prompt-len``-token prompt at max_len 4096 (its
   TTFT, one request alone, after a 256-token warm-up) followed by 7
   decode steps against the long context (their step p50): with the
   prefix cache off, and where the tree has the cache, on with no hit
   (trees before ROADMAP B.10 prefill it in block-wide pieces, later ones
   in whole rows through the invariant product, serve/engine.py).
   ``--prompt-len 0`` skips it;
3. with ``--train-steps N``, after the serving model is freed: N train
   steps of Yi-9B at full width cut to 4 layers (the CORDIC act, softmax
   and loss kernels, AdamW, one batch of 8 x 32 tokens) after 2 warm-up
   steps: their p50, host clock ending in ``loss.item()``.

Prints one JSON object per run, appended to ``--out`` as well.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.launch.serve import make_requests
from repro_torch.models import transformer as tf
from repro_torch.serve.engine import Request, ServeEngine

SLOTS, BLOCK_LEN = 4, 16


def _engine(cfg, model, max_len, **kw):
    return ServeEngine(cfg, model, slots=SLOTS, max_len=max_len,
                       softmax_impl="cordic_pallas", kv_impl="paged",
                       block_len=BLOCK_LEN, paged_attend_impl="pallas",
                       device="cuda", **kw)


def launcher_traffic(cfg, model, repeats=1, requests=8, max_new=16, max_len=128,
                     profile_steps=0):
    eng = _engine(cfg, model, max_len)
    for r in make_requests(cfg, 1, 2, seed=99):       # warm-up
        eng.submit(r)
    eng.run()
    torch.cuda.synchronize()
    runs = [_traffic(eng, make_requests(cfg, requests, max_new, seed=0))
            for _ in range(repeats)]
    prof = _profile(eng, cfg, profile_steps) if profile_steps else None
    return runs, prof


def _profile(eng, cfg, n_steps):
    """Device busy share and the decode kernels' device ms per step over
    ``n_steps`` decode steps of 4 fresh requests (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    for r in make_requests(cfg, SLOTS, n_steps + 2, seed=7):
        eng.submit(r)
    eng.step()                                 # prefills + a first decode
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            eng.step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy = decode = 0.0
    for ev in prof.key_averages():
        if "CUDA" not in str(getattr(ev, "device_type", "")):
            continue
        ms = getattr(ev, "self_device_time_total", 0.0) / 1e3
        busy += ms
        if "_decode_kernel" in ev.key:
            decode += ms
    eng.run()
    if busy == 0:
        return None
    return dict(wall_ms=wall, idle=1 - busy / wall, busy_ms_per_step=busy / n_steps,
                decode_kernel_ms_per_step=decode / n_steps)


def _traffic(eng, reqs):
    t0 = time.perf_counter()
    for r in reqs:
        eng.submit(r)
    steps = []
    while eng.has_work:
        ts = time.perf_counter()
        eng.step()
        steps.append(time.perf_counter() - ts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_tok = sum(len(r.out) for r in reqs)
    return dict(tok_s=n_tok / wall, step_ms_p50=statistics.median(steps) * 1e3,
                ttft_ms_p50=statistics.median(
                    (r.t_first - r.t_enqueue) * 1e3 for r in reqs),
                steps=len(steps), tokens={r.rid: r.out for r in reqs})


def long_prefill(cfg, model, prompt_len, prefix_cache, max_len=4096, max_new=8):
    """TTFT of one ``prompt_len``-token prompt served alone, after a
    256-token warm-up request on the same engine, and the step p50 of its
    ``max_new - 1`` decode steps against the long context."""
    try:
        eng = _engine(cfg, model, max_len,
                      **({"prefix_cache": True} if prefix_cache else {}))
    except NotImplementedError:                 # a tree without the cache
        return None
    rng = np.random.default_rng(7)
    for n in (256, prompt_len):
        r = Request(rid=n, prompt=rng.integers(0, cfg.vocab_size, n).astype(np.int32),
                    max_new_tokens=max_new)
        eng.submit(r)
        steps = []
        while eng.has_work:
            ts = time.perf_counter()
            eng.step()
            torch.cuda.synchronize()
            steps.append(time.perf_counter() - ts)
    hits = getattr(eng, "prefix_hit_tokens", 0)
    out = dict(ttft_ms=(r.t_first - r.t_enqueue) * 1e3, tokens=r.out,
               decode_step_ms_p50=statistics.median(steps[1:]) * 1e3,
               hit_tokens=hits,
               peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    del eng
    torch.cuda.empty_cache()
    return out


def train_steps(n_steps, layers=4, batch=8, seq=32):
    """Step p50 of ``n_steps`` train steps on one batch (see the module
    docstring), after 2 warm-up steps."""
    import dataclasses

    from repro_torch.data.pipeline import DataConfig, SyntheticLMDataset
    from repro_torch.optim import adamw
    from repro_torch.train import loop as loop_lib
    from repro_torch.train import step as step_lib

    cfg = dataclasses.replace(
        configs.get_config("yi-9b", act_impl="cordic_pallas"), num_layers=layers,
        block_pattern=(), softmax_impl="cordic_pallas", loss_impl="cordic_pallas")
    state = step_lib.init_state(cfg, 1, adamw.AdamWConfig(), device="cuda")
    ds = SyntheticLMDataset(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                       global_batch=batch, seed=0))
    b = loop_lib.to_device(ds.batch_at(0), "cuda")
    step = step_lib.make_train_step(cfg, adamw.AdamWConfig(lr=1e-4), warmup_steps=0)
    dts, losses = [], []
    for _ in range(n_steps + 2):
        t0 = time.perf_counter()
        state, m = step(state, b)
        losses.append(m["loss"].item())
        dts.append(time.perf_counter() - t0)
    p50 = statistics.median(dts[2:])
    return dict(step_ms_p50=p50 * 1e3, tok_s=batch * seq / p50, steps=n_steps,
                losses=losses)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--label", required=True)
    ap.add_argument("--arch", default="yi-9b")
    ap.add_argument("--prompt-len", type=int, default=4000)
    ap.add_argument("--repeats", type=int, default=1)
    ap.add_argument("--profile-steps", type=int, default=0)
    ap.add_argument("--train-steps", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    t0 = time.perf_counter()
    cfg = configs.get_config(args.arch, act_impl="cordic_pallas")
    model = tf.init(cfg, seed=0, device="cuda")
    res = dict(label=args.label, arch=args.arch, card=card, prompt_len=args.prompt_len,
               init_s=time.perf_counter() - t0)
    res["launcher"], res["profile"] = launcher_traffic(
        cfg, model, args.repeats, profile_steps=args.profile_steps)
    if args.prompt_len:
        res["long_off"] = [long_prefill(cfg, model, args.prompt_len, False)
                           for _ in range(2)]
        res["long_on"] = long_prefill(cfg, model, args.prompt_len, True)
    if args.train_steps:
        del model
        torch.cuda.empty_cache()
        res["train"] = train_steps(args.train_steps)
    line = json.dumps(res)
    print(line)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
