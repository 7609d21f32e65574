#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --decode-kernels --src <tree>/src --label <name> \
        [--out chiprun_out/decode.jsonl] [--save chiprun_out/<name>.pt]
    python3 chip_smoke.py --row-kernels --src <tree>/src --label <name> \
        [--out chiprun_out/rows.jsonl] [--save chiprun_out/<name>.pt]
    python3 chip_smoke.py --archs
    python3 chip_smoke.py --c7
    python3 chip_smoke.py --prefill-probe

The second form runs only the decode kernels' part of phase 3 (every
gqa_decode and mla_decode branch at the launcher and the long-context
shape, against the plain versions, timed) on the ``repro_torch`` under
``--src``, so two trees are timed by one harness in one call: run parent,
change, change, parent; each run appends one JSON line to ``--out``, and
``--save`` writes the kernels' outputs for a bit-for-bit comparison. The
third form does the same for the row kernels: act_2d (each op at its
shapes), silu_mul_2d, softmax_2d, log_softmax_2d and act_q_2d. The fourth
runs the build, phases 4 (j)-(l) and the train identities of (l)'s block
kinds alone; the last the build and phase (3d) alone.

Phases of the first form, each of which must pass (the script exits non-zero otherwise):

1. device   the card's name and power limit (nvidia-smi), torch / CUDA
            versions; TF32 off for float32 matrix products.
2. build    every CUDA kernel of the port from src/repro_torch/kernels/csrc,
            one nvcc per source, in parallel.
3. kernels  each kernel against its plain PyTorch version on the card, on
            the same inputs, at the shapes of the main paths, and the
            decode kernels also at the long-context shape (max_len 4096:
            M 256, N 1025, k_len [4096, 4000, 2501, 1]): device time
            (torch.profiler) of the kernel, of the plain version, of one
            PyTorch library call that computes the same function where
            there is one, each beside its host-to-host time per call, and
            the least time the card could take (bound). The Q2.14 golden
            codes of sigmoid (float and integer paths), exp and log on the
            card; act_q_2d's sigmoid-code table (its build time) and its
            table route in both dtypes; softmax_2d also at the dense
            decode attend (4 slots x 32 heads of 128 and of 4096 lanes);
            (9c) every score-dot order of the decode kernels (a chain, 2,
            4 and 8 strided partials, tree or halves; float32, int8 and
            Q2.14 pools) and every P.V order (a chain in one piece or in
            Eigen's pieces, 4 partials) bit-equal to its plain version.
            (3d) the paged prefill's row-count-invariant product
            (kernels/gemm.py, ROADMAP B.10, B.12) at Yi-9B's prefill shapes
            (QKV, O, the MLP, the logits on a 4096-row slice of the
            vocabulary, ``_scores`` and ``_pv`` at MAX_LEN's table width)
            and DeepSeek-V2-Lite's MLA widths, at M 1, 16, 17, 100, 128 and
            4000: the bf16 products on the tensor-core route every row the
            same bits at every M, place in a tile and batch count, a K tail
            equal to its zero padding, within the stated bound of float64;
            the float32 products bit-equal to their plain version; both
            routes timed at M 128 and 4000 beside torch.matmul; then the
            probe: each operation
            of one Yi-9B prefill layer on a 16-token segment alone, inside
            rows of 128 and 4000 and as a row of a 4-row dispatch, under
            torch's products (the operations that move are logged) and the
            paged prefill's (none may move).
4. paths    the port's main paths through the entry points a user calls,
            with every launch count set to 0 just before and read just
            after: (a) the paper's unit, ``ops.sigmoid`` and its integer
            datapath ``ops.sigmoid_q``, and the registry's gelu_erf
            (act_2d's gelu_erf op); (b) serving Yi-9B at full width
            (random weights from a seed): 8 greedy requests, 4 slots, paged
            KV, the CORDIC kernels on; (c) serving DeepSeek-V2-Lite at full
            width and depth (27 layers, MLA + GShard MoE, 15.7B parameters)
            on the same traffic; each arch a second time on the
            paper-faithful datapath (act_impl and softmax_impl
            "cordic_fixed": the decode kernels' cordic_fixed branch, the
            activations and the prefill softmax in plain torch, none of the
            activation or softmax kernels); (d) Yi-9B's KV memory plane on
            the same model: the launcher traffic twice more from int8 and
            Q2.14 pools (gqa_decode's kv_quant branch on every decode
            step), the radix prefix cache on a shared-prompt trace over
            int8 pools (cache off, on, and on with chunks packed 4 rows a
            dispatch: every cache-on token equals cache off's); (d') each arch on
            each datapath (Yi's kernel datapath also on int8 and Q2.14
            pools, those on its first SIDE_LAYERS blocks) in an engine at
            max_len 4096: its pool bytes and the
            decode kernel's workspace per call, and one 4000-token request
            served (1024 tokens on cordic_fixed, whose prefill is plain
            torch), so the decode kernel's branch runs at the long shape
            (M 256) on every step: the long-shape entries' launches; Yi's
            kernel datapath serves it once more with the prefix cache on:
            the TTFT on and off, tokens equal; (e)
            training Yi-9B at full width cut to 4 layers (float32 master weights, AdamW, the loop's 8 x 32-token
            batches): 8 loop steps with checkpoints, a bit-equal restore, 6
            steps on one batch (the loss must fall), an eval step; (f)
            chunked and multi-row prefill: trace 1 (8 prompts of 17-100
            tokens, chunks of 32, 4 rows a dispatch) on Yi-9B with the chunk
            and without, cache off and on (every run's tokens must equal the
            single-row unchunked run's), once on DeepSeek-V2-Lite; trace 2 on
            Yi-9B (a 4000-token prompt beside three 8-token ones at max_len
            4096, chunks of 512, and unchunked: the short requests' TTFT);
            ``ServeEngine.score`` of a 128-token prompt through
            log_softmax_2d; (g) the dense KV plane: Yi-9B and
            DeepSeek-V2-Lite on the launcher traffic (softmax_2d once a
            layer on every decode step and prefill, tokens set beside the
            paged run's), and Yi with one 4000-token request at max_len
            4096 (softmax_2d at 128 x 4096 a layer a step; its step p50
            beside the paged engine's); (h) seeded sampling: the sampler
            on fixed 4 x 64,000 logits, its Gumbel noise and tokens equal
            to the CPU's, timed beside the argmax; Yi on the paged plane
            with even rids sampled (T 0.8, top-k 40), served twice with
            seed 0 (equal tokens), its greedy rows equal to the all-greedy
            run's; (i) observability: Yi's launcher traffic with
            Observability(trace=True) inside observe_saturation (tokens
            equal to the run with it off), chiprun_out/metrics.json and
            trace.json (validate_chrome_trace), TTFT, TPOT, the step and
            each engine phase's p50; (j) the recurrent pair at full width
            and depth on the dense plane (xlstm-1.3b: 42 mLSTM and 6
            sLSTM layers; zamba2-1.2b: 38 Mamba2 layers and 6 applications
            of the shared attention block), the kernels on: the kernel
            route's logits against the plain versions' on the same model,
            the launcher traffic (act_2d everywhere, softmax_2d and
            silu_mul_2d from the shared block, exact-length prefill), its
            tokens equal to each request's manual exact-length prefill and
            decode loop, a profile, the sLSTM loop's host operations a
            token, then the traffic cut to 4 x 8 tokens on cordic_fixed,
            and an mLSTM / Mamba2 block's decode after an 8-token prefill
            against the 9-token prefill (float32, the reference's atol);
            (k) qwen2.5-32b (gqa_decode's group of 5 against plain first)
            and deepseek-coder-33b at full depth, phi3.5-moe cut to 16
            layers and command-r-plus to 8 (the weights one card holds),
            each on the paged plane with the decode kernel (gqa_decode a
            layer every decode step), with the gather and on the dense
            plane, match counts reported; also musicgen-large
            (48 layers, GELU MLP, MHA: gqa_decode's G 1 at hd 64) and
            internvl2-1b (24 layers, G 7, hd 64, vocab 151,655) at full
            depth on token ids, each group width held against plain first;
            (l) log_softmax_2d at each trained arch's vocabulary (2,048 to
            151,655 lanes) against plain, then training every block kind at
            full width, depth cut (TRAIN_ARCHS: deepseek-v2-lite 3 layers,
            phi3.5-moe 2, xlstm 8, zamba2 12, musicgen-large 4, internvl2-1b
            4), float32 master weights, 8 x 32 tokens: remat "full" and
            "dots" gradients bit-equal to "none" (each forward kernel
            launched twice), 4 steps with the loss falling, an eval step, a
            step with int8 error-feedback compression, 3 profiled steps.
            Every kernel of a path must have launched, and under grad the
            fused SwiGLU kernel must not (the JAX rule's primal).
            (m) tensor-parallel serving, every rank a spawned process on
            the one card (gloo): Yi-9B at tp 2 and 4 (full width,
            SIDE_LAYERS depth, its tp 1 reference at that depth),
            DeepSeek-V2-Lite at tp 2 (full width and depth), the launcher
            traffic; each rank's attention and MLP/MoE of blocks 0 and 1
            within TP_PROBE_TOL of tp 1's on one input, and outside it with
            its reductions skipped; equal tokens on every rank, each rank's
            first decode kernel call bit-equal to plain on its head slice,
            Yi's pools 1/tp; token matches against tp 1, steps and memory
            reported. In the tp 2 group, Yi-9B and DeepSeek-V2-Lite at
            SIDE_LAYERS depth with kv_shard="seq_model" on the dense plane
            (each rank T/tp positions of every KV head, the split CORDIC
            softmax): the same probe and token gates, each rank's first
            call of each split launch bit-equal to plain, the split result
            bit-equal to whole-row softmax_2d on the rank's gathered
            scores.
            (n) the train step on a ("data", "model") mesh, every rank a
            spawned process on the one card (gloo), 4 steps (2 with data
            ranks) of launch/train.rank_train on 8 x 32 tokens, the CORDIC
            kernels on: Yi-9B at full width cut to 1 layer on (1, 2), on
            (2, 1) with ZeRO-1, on (2, 2) with ZeRO-1 and once more with
            int8 compression; DeepSeek-V2-Lite (3 layers), Zamba2-1.2B (12
            layers, two shared-block applications) and xLSTM-1.3B (8
            layers) on (1, 2) in float32 compute; every rank's losses
            equal, step 0 within 2^-7 of the one-rank step's, each
            gradient leaf gathered whole within TP_PROBE_TOL of it, the
            loss falling, each rank's first call of each kernel bit-equal
            to plain, ZeRO-1's parameters bit-equal at every step to AdamW
            with whole moments on the same gradients; step p50,
            collectives, moment bytes and peak memory per rank reported.
            (--mesh-train-witness: the recurrent pair's runs in bfloat16,
            gates logged, against one rank's bfloat16-vs-float32 spread.)
            (o) the data axes' position cut of the dense caches: Zamba2-1.2B
            at SIDE_LAYERS depth, batch 1, on a (2, 1) mesh of two spawned
            processes (gloo): each rank half of one rank's attention
            buffers, the same tokens on both ranks, the data group's
            collectives run; tokens against one rank's reported.
            (--c7: only xLSTM's and Zamba2's tp 2 runs in bfloat16 and in
            float32 compute, each against its own tp 1; ROADMAP C.7.)
5. identity the Yi and DeepSeek-V2-Lite smoke configs in float32, on both
            datapaths, and Yi's on int8 and Q2.14 pools and with the prefix
            cache: tokens served on the card with the kernels equal the
            CPU's tokens with the plain versions (and, on int8, the card's
            gather attend's); both archs with chunked, multi-row prefill
            (and their ``score``) too; both archs on the dense plane, all
            greedy and with the sampling mix; 5 train steps' losses on the
            card agree with the CPU's, for Yi, DeepSeek-V2-Lite,
            Phi-3.5-MoE, xLSTM and Zamba2, each beside the CPU's own spread
            from weights one ulp up.

The line before the last holds {"kernels": [...]} (one entry per kernel:
launches on its path, max error against plain, times, bound); the last line
is {"ok": true, "device": {...}}. The whole log is also written to
chiprun_out/chip_smoke.log. Without a CUDA device, or run from a
directory without the repository's src/, the script exits with an error and
prints no result.
"""
from __future__ import annotations

import contextlib
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
OUT = ROOT / "chiprun_out"

#: the device every phase runs on
DEV = "cuda"

#: serving shapes of the main paths (launch/serve.py traffic), both archs
SLOTS, MAX_NEW, MAX_LEN, BLOCK_LEN, REQUESTS = 4, 16, 128, 16, 8
#: the MLA/MoE arch served at full width
DEEPSEEK = "deepseek-v2-lite-16b"
#: the train path: Yi-9B widths, depth cut to one block: its two
#: checkpoints of float32 master weights and AdamW moments (8.4 GB each at
#: one block, 14.6 GB at four) are written to and read from $TMPDIR, whose
#: disk the run does not choose; the loop's batches
TRAIN_LAYERS, TRAIN_BATCH, TRAIN_SEQ = 1, 8, 32
#: the fixed-batch descent check: steps and learning rate
DESCENT_STEPS, DESCENT_LR = 6, 1e-4
#: the quantized pool formats served, and the prefix trace: a shared
#: prompt of 4 blocks, then 7 requests of it plus a 3-8-token tail
KV_FORMATS = ("int8", "q2_14")
PREFIX_LEN, PREFIX_WAVE = 64, 7
#: the long-context geometry: pools of engines at this max_len, the decode
#: kernels' long shape (ragged lengths, one vacant slot), and the prompt of
#: the long-context serve
LONG_MAX_LEN = 4096
LONG_KLENS = [4096, 4000, 2501, 1]
LONG_PROMPT = 4000
#: the long-context serve's prompt on the cordic_fixed datapath, whose
#: plain prefill softmax took 78 s over 4000 tokens on Yi-9B; the decode
#: kernel's grid (M 256) and launch count do not depend on it
LONG_PROMPT_FIXED = 1024
#: chunked and multi-row prefill: trace 1, REQUESTS prompts of 17-100
#: tokens at MAX_LEN, chunks of CHUNK tokens, CHUNK_BATCH rows a dispatch;
#: trace 2, one LONG_PROMPT-token prompt beside LONG_SHORTS 8-token ones at
#: LONG_MAX_LEN, chunks of LONG_CHUNK; the scored prompt's length
CHUNK, CHUNK_BATCH = 32, 4
LONG_CHUNK, LONG_SHORTS = 512, 3
SCORE_LEN = 128
#: the sampling mix: even rids at this (temperature, top_k), odd rids greedy
MIX = (0.8, 40)
#: the depth of the serves beside each arch's main one (the cordic_fixed
#: datapath, Yi's prefix and chunked traces, the recurrent pair's
#: cordic_fixed serve): a view of the served model's first blocks
#: (``depth_view``), cut for the time limit. The kernels' datapath serve,
#: every run compared with it and the tp runs keep full depth
SIDE_LAYERS = {"yi-9b": 6, DEEPSEEK: 3, "xlstm-1.3b": 8, "zamba2-1.2b": 12}
#: decode steps under the profiler in each serve profile: its bookkeeping
#: of a full-depth step's host operations takes seconds
PROFILE_STEPS = 3


#: the long-context serves' decode step p50 (ms) and tokens, by (arch,
#: softmax_impl, pool format)
LONG_STEPS = {}

#: each decode branch's kernel output by record name (--decode-kernels
#: --save writes them, so two trees' outputs can be compared bit for bit)
DECODE_OUTPUTS = {}

#: the whole log, also written to OUT (a chip run returns only the end of
#: standard output); opened by main once the card is found
LOG_FILE = []


def log(msg: str) -> None:
    print(msg, flush=True)
    for f in LOG_FILE:
        f.write(msg + "\n")
        f.flush()


_T_PHASE = [time.perf_counter()]


def phase_done(name: str) -> None:
    """Log the wall time since the previous phase ended."""
    now = time.perf_counter()
    log(f"[time] {name}: {now - _T_PHASE[0]:.1f} s")
    _T_PHASE[0] = now


def check(ok, what) -> None:
    """A phase's check: raises (and so fails the run) when ``ok`` is false."""
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def smi(query: str) -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# The count of each kernel's work and the card's peak rates live in the
# package (src/repro_torch/kernels/cost.py: ``pipeline_ops``,
# ``dequant_flops``, ``HBM_BYTES_S``, ``FP32_FLOP_S``,
# ``INT32_LANES_PER_SM``), which the dry run's cost reads too
# ---------------------------------------------------------------------------
def kcost():
    """The package's kernels/cost.py: imported from the package on the
    path, or, for a tree under ``--src`` that predates it, loaded from this
    checkout's file (its counts import only what every tree has)."""
    try:
        from repro_torch.kernels import cost
    except ImportError:
        import importlib.util

        spec = importlib.util.spec_from_file_location(
            "chip_smoke_kernel_cost", SRC / "repro_torch" / "kernels" / "cost.py")
        cost = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(cost)
    return cost


def pipeline_ops(sched):
    return kcost().pipeline_ops(sched)


def dequant_flops() -> int:
    return kcost().dequant_flops()


# ---------------------------------------------------------------------------
# Timing. A kernel's ``ms`` is device time (the profiler's kernel durations);
# at the main path's small shapes the host's dispatch of one call (ctypes,
# allocation, checks) takes longer than the kernel, so the host-to-host time
# per call is kept apart as the dispatch figure.
# ---------------------------------------------------------------------------
def host_ms(torch, fn, iters: int = 20, warmup: int = 2) -> float:
    """Host-to-host time of one call, dispatch included: wall clock over
    ``iters`` back-to-back calls, ended by a synchronize."""
    for _ in range(warmup):
        fn()
    if DEV == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    if DEV == "cuda":
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


#: seconds of back-to-back calls before a kernel's timing window: without
#: them, two windows of the same small kernel were seen to read up to 2.7x
#: apart (the card's clocks and caches settling)
WARM_S = 0.2


def device_ms(torch, fn, iters: int = 20, warmup: int = 2,
              kernel: str | None = None, parts: dict | None = None) -> float:
    """Device time of one call: the summed durations of the device kernels
    that ``iters`` calls launch (torch.profiler's CUDA activity) over
    ``iters``, after ``warmup`` calls (and, for a kernel, WARM_S seconds of
    them). ``kernel`` keeps only the kernels whose name holds it (a
    wrapper's own kernel); None keeps all (a plain version, a library call).
    Host dispatch and the gaps between launches are outside it, unless the
    profiler records no device time, or a count of some kernel's launches
    that is not a multiple of ``iters`` (it dropped launches), three times
    running (once, for a window of every kernel): then CUDA events time the
    calls, gaps included, and a log line says so. ``parts``, when
    given, gets the device ms per call of each kernel name (a template's
    instantiations summed: a decode kernel's phases)."""
    if DEV != "cuda":                       # rehearsal on the CPU
        return host_ms(torch, fn, iters, warmup)
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while kernel is not None and time.perf_counter() - t0 < WARM_S:
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
    # the profiler now and then records no device activity for a window, or
    # drops some of a kernel's launches (a kernel then read faster than HBM
    # allows); profile again, then fall back to CUDA events around calls
    # queued behind a 50 ms device sleep, so they run back to back. A window
    # of every kernel (a plain version's thousands of launches) drops on
    # every try: it gets one
    attempts = 3 if kernel is not None else 1
    for attempt in range(attempts):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total_us, split, dropped = 0.0, {}, []
        for ev in prof.key_averages():
            if "CUDA" not in str(getattr(ev, "device_type", "")):
                continue
            if kernel is None or kernel in ev.key:
                us = getattr(ev, "self_device_time_total", 0.0)
                total_us += us
                if ev.count % iters:
                    dropped.append(f"{ev.count} of {ev.key[:60]}")
                if parts is not None and kernel is not None:
                    name = re.search(kernel + r"\w*", ev.key).group(0)
                    split[name] = split.get(name, 0.0) + us / 1e3 / iters
        if total_us > 0 and not dropped:
            if parts is not None:
                for name, ms in split.items():
                    parts[name] = parts.get(name, 0.0) + ms
            return total_us / 1e3 / iters
        if dropped:
            log(f"[timing] the profiler recorded {', '.join(dropped)} for {iters} calls "
                f"(attempt {attempt + 1} of {attempts})")
            continue
        log(f"[timing] the profiler saw no device time for {kernel or 'fn'} "
            f"(attempt {attempt + 1} of {attempts})")
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(100_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / iters
    check(ms > 0, f"no device time for {kernel or 'fn'}")
    log(f"[timing] {kernel or 'fn'}: {ms:.4f} ms per call from CUDA events (calls "
        "queued behind a device sleep: back to back, gaps between kernels included)")
    return ms


def times(torch, fn, kernel=None, iters: int = 20, warmup: int = 2, parts=None):
    """(device ms, host-to-host ms) of one call; ``parts`` as in device_ms."""
    return (device_ms(torch, fn, iters, warmup, kernel, parts),
            host_ms(torch, fn, iters, warmup))


def plain_call(torch, plain):
    """The plain version's output for a check, and that one call's time:
    CUDA events around it, queued behind a device sleep (host gaps
    included), as ``device_ms`` falls back to for a window of thousands of
    launches. Returns (output, (ms, None)): no call beyond the check's, and
    no host-to-host figure."""
    if DEV != "cuda":                       # rehearsal on the CPU
        t0 = time.perf_counter()
        out = plain()
        return out, ((time.perf_counter() - t0) * 1e3, None)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(100_000_000)
    start.record()
    out = plain()
    end.record()
    torch.cuda.synchronize()
    return out, (start.elapsed_time(end), None)


def sub_phase(name: str, t0: list) -> None:
    """Log the wall time of a part of a phase since ``t0[0]``; resets it."""
    now = time.perf_counter()
    log(f"[time]   {name}: {now - t0[0]:.1f} s")
    t0[0] = now


class Card:
    def __init__(self, torch):
        props = torch.cuda.get_device_properties(0)
        self.sms = props.multi_processor_count
        self.clock_hz = float(smi("clocks.max.sm").split()[0]) * 1e6
        self.int32_ops_s = self.sms * kcost().INT32_LANES_PER_SM * self.clock_hz

    def bound(self, nbytes: float, int_ops: float = 0.0, flops: float = 0.0):
        c = kcost()
        times = {"bytes": nbytes / c.HBM_BYTES_S,
                 "operations": max(int_ops / self.int32_ops_s,
                                   flops / c.FP32_FLOP_S)}
        by = max(times, key=times.get)
        return times[by] * 1e3, by


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------
def kernel_phase(torch, card, records, ycfg, dcfg):
    import numpy as np

    from repro_torch.cordic_engine.core import PAPER_FIXED, FixedConfig
    from repro_torch.cordic_engine.schedule import PAPER_SCHEDULE, mr_schedule_for
    from repro_torch.core import fixed_point as fp
    from repro_torch.kernels import code_tables as CT
    from repro_torch.kernels import cordic_act as K
    from repro_torch.kernels import softmax_cordic as SM

    ops = pipeline_ops(PAPER_SCHEDULE)
    dev = torch.device(DEV)
    gen = torch.Generator(device=dev).manual_seed(0)
    # the pipeline route: a format wider than 16 bits takes no table
    q20 = dict(sched=mr_schedule_for(20), cfg=FixedConfig(fmt=fp.Q2_20))

    # (0) the code tables of the table route, built on the card at first
    # use by the pipeline's own stages: equal to the plain builders over
    # every code
    CT._CACHE.clear()
    t0 = time.perf_counter()
    tabs = CT.code_tables(PAPER_SCHEDULE, PAPER_FIXED, dev)
    build_ms = (time.perf_counter() - t0) * 1e3
    h = tabs.half
    same = (torch.equal(tabs.codes[0].cpu(),
                        CT.tanh_code_table_plain(PAPER_SCHEDULE, PAPER_FIXED))
            and torch.equal(tabs.codes[1].cpu(),
                            CT.exp_code_table_plain(PAPER_SCHEDULE, PAPER_FIXED)))
    log(f"[code tables] tanh and e^r codes of [-{h}, {h}] built on the card in "
        f"{build_ms:.2f} ms (first use, host clock, synchronized): equal to "
        f"the plain builders {same}")
    check(same, "the card's code tables differ from the plain builders")
    t_sub = [time.perf_counter()]
    sub_phase("kernels (0) code tables", t_sub)

    # (1) act_2d: every Q2.14 code in [-1, 1] against the golden file, then
    # a (d_model, d_ff) = (4096, 11008) map bit-exact against plain
    codes = torch.arange(-(1 << 14), (1 << 14) + 1, device=dev)
    x = codes.to(torch.float32) / (1 << 14)
    y = K.act_2d(x, "sigmoid")
    with np.load(ROOT / "tests" / "golden" / "sigmoid_q2_14.npz") as z:
        golden = torch.from_numpy(z["y"].astype(np.int64)).to(dev)
    got = torch.round(y * (1 << 14)).to(torch.int64)
    n_bad = int((got != golden[codes + (1 << 15)]).sum())
    xd = x.double()
    mae = float((y.double() - 1.0 / (1.0 + torch.exp(-xd))).abs().mean())
    log(f"[act_2d] sigmoid over {codes.numel()} Q2.14 codes in [-1, 1]: "
        f"{n_bad} differ from tests/golden/sigmoid_q2_14.npz; "
        f"MAE {mae:.3e} (paper 4.23e-4)")
    check(n_bad == 0, "sigmoid codes differ from the golden vectors")
    big = torch.randn(ycfg.d_model, ycfg.d_ff, generator=gen, device=dev) * 3
    a, b = K.act_2d(big, "sigmoid"), K.act_2d_plain(big, "sigmoid")
    for op in ("tanh", "sigmoid_wide", "silu"):
        check(torch.equal(K.act_2d(big[:64], op), K.act_2d_plain(big[:64], op)),
              f"act_2d {op} differs from its plain version")
    # the pipeline route: Q2.20
    for op in ("sigmoid", "sigmoid_wide", "exp", "gelu_erf"):
        check(torch.equal(K.act_2d(big[:64], op, **q20), K.act_2d_plain(big[:64], op, **q20)),
              f"act_2d {op} in Q2.20 (pipeline route) differs from its plain version")
    log(f"[act_2d] tanh, sigmoid_wide, silu at {[64, big.shape[1]]}, and sigmoid, "
        "sigmoid_wide, exp, gelu_erf in Q2.20 (pipeline route): bit-exact against plain")
    err = float((a - b).abs().max())
    check(torch.equal(a, b), "act_2d differs from its plain version")
    n = big.numel()
    bound, by = card.bound(8 * n, ops["sigmoid_tab"] * n)
    records["act_2d"] = timed(
        dict(shape=list(big.shape), dtype="float32", max_abs_err=err,
             bound_ms=bound, bound_by=by),
        kernel=times(torch, lambda: K.act_2d(big, "sigmoid"), "act_kernel"),
        plain=times(torch, lambda: K.act_2d_plain(big, "sigmoid"), None, 3, 1),
        library=times(torch, lambda: torch.sigmoid(big)))
    sub_phase("kernels (1) act_2d sigmoid", t_sub)

    # (2) silu_mul_2d at the decode (4 x d_ff), prefill (16 x d_ff) and
    # eval-step (B*S x d_ff = 256 x d_ff) shapes, bfloat16 (timed) and
    # float32, 16-byte aligned and not (the table route's vector and
    # element paths), and in Q2.20 (the pipeline route): bit-exact
    F = ycfg.d_ff
    for name, rows in (("decode", SLOTS), ("prefill", BLOCK_LEN),
                       ("eval step", TRAIN_BATCH * TRAIN_SEQ)):
        g = (torch.randn(rows * F + 1, generator=gen, device=dev) * 3).bfloat16()
        u = torch.randn(rows * F + 1, generator=gen, device=dev).bfloat16()
        for dt in (torch.bfloat16, torch.float32):
            for off in (0, 1):
                gd, ud = g.to(dt)[off:off + rows * F], u.to(dt)[off:off + rows * F]
                check(torch.equal(K.silu_mul_2d(gd, ud), K.silu_mul_2d_plain(gd, ud)),
                      f"silu_mul_2d ({name}, {dt}, offset {off}) differs from plain")
        gd, ud = g[:rows * F].float(), u[:rows * F].float()
        check(torch.equal(K.silu_mul_2d(gd, ud, **q20), K.silu_mul_2d_plain(gd, ud, **q20)),
              f"silu_mul_2d ({name}) in Q2.20 (pipeline route) differs from plain")
        g, u = g[:rows * F], u[:rows * F]
        a, b = K.silu_mul_2d(g, u), K.silu_mul_2d_plain(g, u)
        n = g.numel()
        bound, by = card.bound(6 * n, ops["wide_tab"] * n)
        rec = timed(
            dict(shape=[rows, F], dtype="bfloat16",
                 max_abs_err=float((a.float() - b.float()).abs().max()),
                 bound_ms=bound, bound_by=by),
            kernel=times(torch, lambda: K.silu_mul_2d(g, u), "silu_mul_kernel"),
            plain=times(torch, lambda: K.silu_mul_2d_plain(g, u), None, 5, 1))
        log(f"[silu_mul_2d] {name} {rec['shape']} bf16: bit-exact (bf16 and f32, "
            f"aligned and not, and in Q2.20); {fmt_times(rec)}")
        if name == "decode":
            records["silu_mul_2d"] = rec
    sub_phase("kernels (2) silu_mul_2d", t_sub)

    # (3) softmax_2d at the prefill attend shape: rows H*S = 32*16, cols
    # M*L = 128, causal mask of an 11-token prompt in a 16-wide bucket
    S, T = BLOCK_LEN, MAX_LEN
    s = torch.randn(ycfg.num_heads, S, T, generator=gen, device=dev) * 4
    qpos = torch.arange(S, device=dev)[:, None]
    kpos = torch.arange(T, device=dev)[None, :]
    s = torch.where((kpos <= qpos) & (kpos < 11), s, torch.full_like(s, -1e30))
    s = s.reshape(-1, T).contiguous()
    a, b = SM.softmax_2d(s), SM.softmax_2d_plain(s)
    err = float((a - b).abs().max())
    check(torch.equal(a, b), "softmax_2d differs from its plain version")
    check(torch.equal(SM.softmax_2d(s, **q20), SM.softmax_2d_plain(s, **q20)),
          "softmax_2d in Q2.20 (pipeline route) differs from its plain version")
    live = int((s > -1e29).sum())
    bound, by = card.bound(8 * s.numel(), ops["softmax_lane_tab"] * live)
    records["softmax_2d"] = timed(
        dict(shape=list(s.shape), dtype="float32", max_abs_err=err,
             bit_equal=bool(torch.equal(a, b)), bound_ms=bound, bound_by=by),
        kernel=times(torch, lambda: SM.softmax_2d(s), "softmax_kernel"),
        plain=times(torch, lambda: SM.softmax_2d_plain(s), None, 3, 1),
        library=times(torch, lambda: torch.softmax(s, dim=-1)))
    # and at the train step's attend shape (_attend_block): rows B*KH*G*S =
    # 8*4*8*32, cols S = 32, causal, at the same tolerance
    st = torch.randn(TRAIN_BATCH, ycfg.num_kv_heads,
                     ycfg.num_heads // ycfg.num_kv_heads, TRAIN_SEQ, TRAIN_SEQ,
                     generator=gen, device=dev) * 4
    causal = torch.ones(TRAIN_SEQ, TRAIN_SEQ, dtype=torch.bool, device=dev).tril()
    st = torch.where(causal, st, torch.full_like(st, -1e30))
    st = st.reshape(-1, TRAIN_SEQ).contiguous()
    a, b = SM.softmax_2d(st), SM.softmax_2d_plain(st)
    check(torch.equal(a, b), "softmax_2d (train) differs from its plain version")
    live = int((st > -1e29).sum())
    bound, by = card.bound(8 * st.numel(), ops["softmax_lane_tab"] * live)
    rec = timed(
        dict(shape=list(st.shape), max_abs_err=float((a - b).abs().max()),
             bit_equal=bool(torch.equal(a, b)), bound_ms=bound, bound_by=by),
        kernel=times(torch, lambda: SM.softmax_2d(st), "softmax_kernel"),
        plain=times(torch, lambda: SM.softmax_2d_plain(st), None, 3, 1),
        library=times(torch, lambda: torch.softmax(st, dim=-1)))
    log(f"[softmax_2d] train attend {rec['shape']} causal: max |kernel - plain| "
        f"{rec['max_abs_err']:.3e} (bit-equal {rec['bit_equal']}); {fmt_times(rec)}")
    # and rows of the long prefill's attend (a 4096-lane bucket: one CTA a
    # row), the last 256 query rows of a 4000-token prompt, causal
    sl = long_softmax_rows(torch, gen)
    a, b = SM.softmax_2d(sl), SM.softmax_2d_plain(sl)
    check(torch.equal(a, b), "softmax_2d (4096 lanes) differs from its plain version")
    check(torch.equal(SM.softmax_2d(sl, **q20), SM.softmax_2d_plain(sl, **q20)),
          "softmax_2d (4096 lanes) in Q2.20 (pipeline route) differs from plain")
    live = int((sl > -1e29).sum())
    bound, by = card.bound(8 * sl.numel(), ops["softmax_lane_tab"] * live)
    rec = timed(
        dict(shape=list(sl.shape), max_abs_err=float((a - b).abs().max()),
             bound_ms=bound, bound_by=by),
        kernel=times(torch, lambda: SM.softmax_2d(sl), "softmax_kernel"),
        plain=times(torch, lambda: SM.softmax_2d_plain(sl), None, 3, 1),
        library=times(torch, lambda: torch.softmax(sl, dim=-1)))
    log(f"[softmax_2d] long prefill attend {rec['shape']} causal: bit-exact, and in "
        f"Q2.20; {fmt_times(rec)}")
    del sl, a, b
    sub_phase("kernels (3) softmax_2d", t_sub)
    dense_decode_softmax(torch, card, SM, ycfg, gen, ops)
    sub_phase("kernels (3b) softmax_2d dense decode", t_sub)
    split_softmax_records(torch, card, records, SM, ycfg, gen)
    sub_phase("kernels (3c) softmax_2d split form", t_sub)

    decode_kernels(torch, card, records, ycfg, dcfg, ops)
    t_sub[0] = time.perf_counter()
    # (5) log_softmax_2d at the loss shape: (B*S, V) = (256, 64000) float32
    # logits with a masked tail (-1e30) on some rows, bit-exact
    rows, V = TRAIN_BATCH * TRAIN_SEQ, ycfg.vocab_size
    z = torch.randn(rows, V, generator=gen, device=dev) * 3
    z[:8, V - 1000:] = -1e30
    z[8] = -1e30
    a, b = SM.log_softmax_2d(z), SM.log_softmax_2d_plain(z)
    check(torch.equal(a, b), "log_softmax_2d differs from its plain version")
    err = float((a - b).abs().max())            # every lane is finite
    check(math.isfinite(err), "log_softmax_2d: a lane is not finite")
    # the pipeline route (Q2.20); rows of V - 1 lanes one element off
    # 16-byte alignment (the element path)
    check(torch.equal(SM.log_softmax_2d(z, **q20), SM.log_softmax_2d_plain(z, **q20)),
          "log_softmax_2d in Q2.20 (pipeline route) differs from its plain version")
    zo = z.view(-1)[1:1 + rows * (V - 1)].view(rows, V - 1)
    check(torch.equal(SM.log_softmax_2d(zo), SM.log_softmax_2d_plain(zo)),
          f"log_softmax_2d ({V - 1} lanes, misaligned) differs from its plain version")
    wide = log_softmax_wide_rows(torch, SM, gen, q20)
    log(f"[log_softmax_2d] {list(z.shape)}: bit-exact, and in Q2.20, and at "
        f"{V - 1} lanes misaligned; plan {SM.log_softmax_plan(V)}; {wide}")
    live = int((z - z.amax(-1, keepdim=True) >= -20.0).sum())
    bound, by = card.bound(8 * z.numel(), ops["log_softmax_lane_tab"] * live
                           + ops["log_row"] * rows, 3 * z.numel())
    records["log_softmax_2d"] = timed(
        dict(shape=list(z.shape), dtype="float32", max_abs_err=err,
             bound_ms=bound, bound_by=by),
        kernel=times(torch, lambda: SM.log_softmax_2d(z), "log_softmax_cluster_kernel"),
        plain=times(torch, lambda: SM.log_softmax_2d_plain(z), None, 3, 1),
        library=times(torch, lambda: torch.log_softmax(z, dim=-1)))
    del z, zo, a, b
    sub_phase("kernels (5) log_softmax_2d", t_sub)

    # (6) act_2d exp, log, softplus, elu at the train path's MLP shape
    # (B*S, d_ff) = (256, 11008), float32 and bfloat16, bit-exact
    xa = torch.randn(rows, ycfg.d_ff, generator=gen, device=dev) * 30
    xa.view(-1)[:12] = torch.tensor([0.0, -0.0, 80, -80, 85, -85, 1e-30, 1e30,
                                     3e38, 88, -103, 0.693], device=dev)
    for op in ("exp", "log", "softplus", "elu", "gelu_erf"):
        xin = xa.abs() if op == "log" else xa
        if op == "gelu_erf":
            # past |x| ~ 1.8e19 erf's u^2 overflows to NaN, whose casts
            # differ between torch and CUDA (tests/test_torch_cordic_act.py)
            xin = xa.clamp(-1e18, 1e18)
        for dt in (torch.float32, torch.bfloat16):
            check(torch.equal(K.act_2d(xin.to(dt), op), K.act_2d_plain(xin.to(dt), op)),
                  f"act_2d {op} {dt} differs from its plain version")
    log(f"[act_2d] exp, log, softplus, elu, gelu_erf at {list(xa.shape)} float32 "
        "and bfloat16: bit-exact against plain")
    # the train step's launch: sigmoid_wide of the SwiGLU gate, bfloat16
    xg = (xa / 10).bfloat16()
    check(torch.equal(K.act_2d(xg, "sigmoid_wide"), K.act_2d_plain(xg, "sigmoid_wide")),
          "act_2d sigmoid_wide differs from its plain version")
    bound, by = card.bound(4 * xg.numel(), ops["wide_tab"] * xg.numel())
    rec = timed(dict(shape=list(xg.shape), bound_ms=bound, bound_by=by),
                kernel=times(torch, lambda: K.act_2d(xg, "sigmoid_wide"), "act_kernel"),
                plain=times(torch, lambda: K.act_2d_plain(xg, "sigmoid_wide"), None, 3, 1),
                library=times(torch, lambda: torch.sigmoid(xg)))
    log(f"[act_2d] sigmoid_wide {rec['shape']} bf16 (a train step's launch): "
        f"{fmt_times(rec)}")
    sub_phase("kernels (6) act_2d exp, log, softplus, elu, gelu_erf, sigmoid_wide", t_sub)

    # (7) the exp and log cores against their Q2.14 golden codes, as
    # tests/test_golden_vectors.py reads them
    with np.load(ROOT / "tests" / "golden" / "exp_q2_14.npz") as zf:
        gexp = torch.from_numpy(zf["y"].astype(np.int64)).to(dev)
    lim = int(0.34 * (1 << 14))
    codes = torch.arange(-lim, lim + 1, device=dev)
    got = torch.round(K.act_2d(codes.float() / (1 << 14), "exp") * (1 << 14)).long()
    n_exp = int((got != gexp[codes + (1 << 15)]).sum())
    with np.load(ROOT / "tests" / "golden" / "log_q2_14.npz") as zf:
        glog = torch.from_numpy(zf["y"].astype(np.int64)).to(dev)
    mq = torch.arange(1 << 13, 1 << 14, device=dev)
    got = torch.round(K.act_2d(mq.float() / (1 << 14), "log") * (1 << 13)).long()
    n_log = int((got != glog).sum())
    log(f"[golden] exp over {codes.numel()} codes |r| <= 0.34: {n_exp} differ "
        f"from tests/golden/exp_q2_14.npz; log over {mq.numel()} mantissa codes: "
        f"{n_log} differ from tests/golden/log_q2_14.npz")
    check(n_exp == 0 and n_log == 0, "exp/log codes differ from the golden vectors")
    sub_phase("kernels (7) golden exp, log", t_sub)

    # (8) act_q_2d: the table route and the pipeline (act_q_phase)
    act_q_phase(torch, card, records, ycfg, ops, q20)
    sub_phase("kernels (8) act_q_2d", t_sub)

    # (10) the reused kernels at DeepSeek-V2-Lite's serve shapes, bit-exact:
    # act_2d sigmoid_wide of the MoE experts' gate at decode, (G, E, C, f)
    # = (4, 64, 4, 1408) bf16; silu_mul_2d of layer 0's dense FFN at decode
    # (4, 10944) bf16; softmax_2d of the MLA prefill attend (H*S, T) =
    # (16*16, 128) causal
    E, f = dcfg.moe.num_experts, dcfg.moe.d_ff_expert
    xg = (torch.randn(SLOTS, E, 4, f, generator=gen, device=dev) * 3).bfloat16()
    check(torch.equal(K.act_2d(xg, "sigmoid_wide"), K.act_2d_plain(xg, "sigmoid_wide")),
          "act_2d sigmoid_wide (MoE decode) differs from plain")
    n = xg.numel()
    bound, by = card.bound(4 * n, ops["wide_tab"] * n)
    rec = timed(dict(shape=list(xg.shape), bound_ms=bound, bound_by=by),
                kernel=times(torch, lambda: K.act_2d(xg, "sigmoid_wide"), "act_kernel"),
                plain=times(torch, lambda: K.act_2d_plain(xg, "sigmoid_wide"), None, 3, 1),
                library=times(torch, lambda: torch.sigmoid(xg)))
    log(f"[act_2d] sigmoid_wide {rec['shape']} bf16 (a MoE decode launch): "
        f"bit-exact; {fmt_times(rec)}")
    g = (torch.randn(SLOTS, dcfg.d_ff_dense, generator=gen, device=dev) * 3).bfloat16()
    u = torch.randn(SLOTS, dcfg.d_ff_dense, generator=gen, device=dev).bfloat16()
    check(torch.equal(K.silu_mul_2d(g.view(-1), u.view(-1)),
                      K.silu_mul_2d_plain(g.view(-1), u.view(-1))),
          "silu_mul_2d (DeepSeek dense FFN) differs from plain")
    S, T = BLOCK_LEN, MAX_LEN
    sd = torch.randn(dcfg.num_heads, S, T, generator=gen, device=dev) * 4
    qpos = torch.arange(S, device=dev)[:, None]
    kpos = torch.arange(T, device=dev)[None, :]
    sd = torch.where((kpos <= qpos) & (kpos < 9), sd, torch.full_like(sd, -1e30))
    sd = sd.reshape(-1, T).contiguous()
    a, b = SM.softmax_2d(sd), SM.softmax_2d_plain(sd)
    check(torch.equal(a, b), "softmax_2d (MLA prefill) differs from its plain version")
    log(f"[deepseek shapes] silu_mul_2d {list(g.shape)} bf16 bit-exact; "
        f"softmax_2d {list(sd.shape)} max |kernel - plain| "
        f"{float((a - b).abs().max()):.3e} (bit-equal {bool(torch.equal(a, b))})")
    sub_phase("kernels (10) DeepSeek shapes", t_sub)

    # (11) act_2d gelu_erf (the registry's get_activation("gelu_erf",
    # "cordic_pallas")) on the (d_model, d_ff) = (4096, 11008) map of (1),
    # float32 and bfloat16, bit-exact; timed in float32 beside torch's
    # erf-form GELU
    xe = big
    errs = []
    for dt in (torch.float32, torch.bfloat16):
        a = K.act_2d(xe.to(dt), "gelu_erf")
        b = K.act_2d_plain(xe.to(dt), "gelu_erf")
        check(torch.equal(a, b), f"act_2d gelu_erf {dt} differs from its plain version")
        errs.append(float((a.float() - b.float()).abs().max()))
    del a, b
    n = xe.numel()
    bound, by = card.bound(8 * n, ops["gelu_erf_tab"] * n, 16 * n)
    records["act_2d[gelu_erf]"] = timed(
        dict(shape=list(xe.shape), dtype="float32", max_abs_err=max(errs),
             bound_ms=bound, bound_by=by),
        kernel=times(torch, lambda: K.act_2d(xe, "gelu_erf"), "act_kernel"),
        plain=times(torch, lambda: K.act_2d_plain(xe, "gelu_erf"), None, 3, 1),
        library=times(torch, lambda: torch.nn.functional.gelu(xe, approximate="none")))
    log(f"[act_2d] gelu_erf {list(xe.shape)} float32 and bfloat16: bit-exact "
        "against plain")
    sub_phase("kernels (11) act_2d gelu_erf", t_sub)

    for name in ("act_2d", "softmax_2d", "log_softmax_2d", "act_q_2d",
                 "act_2d[gelu_erf]"):
        r = records[name]
        log(f"[{name}] {r['shape']}: max |kernel - plain| {r['max_abs_err']:.3e}; "
            f"{fmt_times(r)}")


def act_q_phase(torch, card, records, ycfg, ops, q20):
    """act_q_2d: the sigmoid-code table built on the card (build ms, equal to
    the plain builder); all 2^16 Q2.14 codes, int16 and int32, against the
    golden file and the plain version; int32 codes over the whole int32
    range (+-2^31 included) and a misaligned view; Q2.20 on the pipeline
    route; timed on the sigmoid path's (d_model, d_ff) = (4096, 11008) code
    map in int16 and int32."""
    import numpy as np

    from repro_torch.cordic_engine.core import PAPER_FIXED
    from repro_torch.cordic_engine.schedule import PAPER_SCHEDULE
    from repro_torch.kernels import code_tables as CT
    from repro_torch.kernels import cordic_act as K

    dev = torch.device(DEV)
    CT._SIGMOID_Q_CACHE.clear()
    t0 = time.perf_counter()
    qtab = CT.sigmoid_q_table(PAPER_SCHEDULE, PAPER_FIXED, dev)
    build_ms = (time.perf_counter() - t0) * 1e3
    same = torch.equal(qtab.cpu(), CT.sigmoid_q_table_plain(PAPER_SCHEDULE, PAPER_FIXED))
    log(f"[act_q_2d] the sigmoid-code table ({qtab.numel()} codes) built on the card in "
        f"{build_ms:.2f} ms (first use, host clock, synchronized): equal to the plain "
        f"builder {same}")
    check(same, "the card's sigmoid-code table differs from the plain builder")
    codes = torch.arange(-(1 << 15), 1 << 15, device=dev)
    gsig = torch.from_numpy(np.load(ROOT / "tests" / "golden" / "sigmoid_q2_14.npz")
                            ["y"].astype(np.int64)).to(dev)
    for dt in (torch.int16, torch.int32):
        a = K.act_q_2d(codes.to(dt))
        n_bad = int((a.long() != gsig).sum())
        log(f"[act_q_2d] {dt} over all {codes.numel()} Q2.14 codes: {n_bad} "
            "differ from tests/golden/sigmoid_q2_14.npz")
        check(n_bad == 0 and a.dtype == dt, f"act_q_2d {dt} codes differ from golden")
        check(torch.equal(a, K.act_q_2d_plain(codes.to(dt))),
              f"act_q_2d {dt} differs from its plain version")
    gen = torch.Generator(device=dev).manual_seed(3)
    wide = torch.randint(-(1 << 31), 1 << 31, (1 << 20,), generator=gen, device=dev,
                         dtype=torch.int64)
    wide[:6] = torch.tensor([-(1 << 31), (1 << 31) - 1, -(1 << 31) + 1, (1 << 31) - 2,
                             1 << 16, -(1 << 16) - 1])
    wide = wide.to(torch.int32)
    a = K.act_q_2d(wide)
    check(torch.equal(a, K.act_q_2d_plain(wide)),
          "act_q_2d int32 codes beyond 16 bits differ from the plain version")
    check(torch.equal(K.act_q_2d(wide[1:]), a[1:]), "act_q_2d misaligned (element path)")
    check(torch.equal(K.act_q_2d(codes.to(torch.int16)[1:]),
                      K.act_q_2d_plain(codes.to(torch.int16)[1:])),
          "act_q_2d int16 misaligned (element path)")
    w20 = wide[:1 << 16]
    check(torch.equal(K.act_q_2d(w20, **q20), K.act_q_2d_plain(w20, **q20)),
          "act_q_2d in Q2.20 (pipeline route) differs from its plain version")
    log(f"[act_q_2d] {wide.numel()} int32 codes over the whole int32 range (+-2^31 "
        "included), misaligned int16 and int32 views, and Q2.20 (pipeline route): "
        "bit-exact against plain")
    xq = sigmoid_q_map(torch, ycfg)
    for dt in (torch.int16, torch.int32):
        x = xq.to(dt)
        a, b = K.act_q_2d(x), K.act_q_2d_plain(x)
        check(torch.equal(a, b), f"act_q_2d {dt} differs from its plain version")
        n, size = x.numel(), x.element_size()
        bound, by = card.bound(2 * size * n, ops["sigmoid_q_tab"] * n)
        name = "act_q_2d" if dt == torch.int16 else "act_q_2d[int32]"
        records[name] = timed(
            dict(shape=list(x.shape), dtype=str(dt)[6:],
                 max_abs_err=float((a.long() - b.long()).abs().max()),
                 bound_ms=bound, bound_by=by),
            kernel=times(torch, lambda: K.act_q_2d(x), "act_q_kernel"),
            plain=times(torch, lambda: K.act_q_2d_plain(x), None, 3, 1))
        log(f"[act_q_2d] {name} {list(x.shape)}: {fmt_times(records[name])}")


def dense_decode_softmax(torch, card, SM, ycfg, gen, ops):
    """softmax_2d at the dense decode step's attend: SLOTS x H rows of
    max_len lanes (MAX_LEN and LONG_MAX_LEN), each slot's rows masked past
    its length (ragged, one vacant slot), against its plain version and
    torch.softmax, timed."""
    dev = torch.device(DEV)
    H = ycfg.num_heads
    for T in (MAX_LEN, LONG_MAX_LEN):
        k_len = torch.tensor([T, (3 * T) // 4, T // 3, 1], device=dev)
        s = torch.randn(SLOTS * H, T, generator=gen, device=dev) * 4
        kpos = torch.arange(T, device=dev)[None, :]
        s = torch.where(kpos < k_len.repeat_interleave(H)[:, None], s,
                        torch.full_like(s, -1e30)).contiguous()
        a, b = SM.softmax_2d(s), SM.softmax_2d_plain(s)
        check(torch.equal(a, b), f"softmax_2d (dense decode, {T} lanes) differs "
              "from its plain version")
        live = int((s > -1e29).sum())
        bound, by = card.bound(8 * s.numel(), ops["softmax_lane_tab"] * live)
        rec = timed(
            dict(shape=list(s.shape), max_abs_err=float((a - b).abs().max()),
                 bound_ms=bound, bound_by=by),
            kernel=times(torch, lambda: SM.softmax_2d(s), "softmax_kernel"),
            plain=times(torch, lambda: SM.softmax_2d_plain(s), None, 3, 1),
            library=times(torch, lambda: torch.softmax(s, dim=-1)))
        log(f"[softmax_2d] dense decode attend {rec['shape']} (k_len "
            f"{k_len.tolist()} a slot): bit-exact; {fmt_times(rec)}")


#: the split launches' records (kv_shard="seq_model"), profiler name parts
SPLIT_LAUNCHES = ("softmax_split_max", "softmax_split_windows", "softmax_split_probs")


def split_softmax_records(torch, card, records, SM, ycfg, gen):
    """softmax_2d's split form (kv_shard="seq_model") at Yi's dense decode
    spans: SLOTS x H rows of MAX_LEN lanes cut over tp 2 (the tp path's seq
    run, recorded), then the dry run's decode_32k span, 8 x H rows of 32768
    lanes cut over tp 16 (logged); each row masked past its slot's length
    (ragged, one vacant slot). The three launches span by span, the max
    and the concatenation between them here: the joined result bit-equal
    to whole-row softmax_2d; each launch on rank 0's span bit-equal to its
    plain version and timed beside its plain version and the PyTorch call
    (torch.amax for the max, none for the window sums, torch.softmax on the
    span for the probabilities); bounds from kernels/cost.py's work."""
    from repro_torch.cordic_engine.core import PAPER_FIXED
    from repro_torch.cordic_engine.schedule import PAPER_SCHEDULE

    c = kcost()
    dev = torch.device(DEV)
    H = ycfg.num_heads
    for T, tp, slots, keep in ((MAX_LEN, 2, SLOTS, True), (32768, 16, 8, False)):
        span = T // tp
        k_len = torch.tensor([T, (3 * T) // 4, T // 3, 1] * (slots // 4), device=dev)
        s = torch.randn(slots * H, T, generator=gen, device=dev) * 4
        kpos = torch.arange(T, device=dev)[None, :]
        s = torch.where(kpos < k_len.repeat_interleave(H)[:, None], s,
                        torch.full_like(s, -1e30)).contiguous()
        xs = [s[:, r * span:(r + 1) * span].contiguous() for r in range(tp)]
        m = torch.stack([SM.softmax_split_max(x) for x in xs]).amax(0)
        w = torch.cat([SM.softmax_split_windows(x, m) for x in xs], dim=-1)
        p = torch.cat([SM.softmax_split_probs(x, m, w) for x in xs], dim=-1)
        check(torch.equal(p, SM.softmax_2d(s)), f"the split softmax over {tp} spans of "
              f"{list(s.shape)} differs from whole-row softmax_2d")
        x0 = xs[0]
        work = {"softmax_split_max": c.row_max_work(x0),
                "softmax_split_windows": c.softmax_split_windows_work(
                    x0, PAPER_SCHEDULE, PAPER_FIXED),
                "softmax_split_probs": c.softmax_split_probs_work(
                    x0, w, PAPER_SCHEDULE, PAPER_FIXED)}
        calls = {"softmax_split_max": (lambda: SM.softmax_split_max(x0),
                                       lambda: SM.softmax_split_max_plain(x0),
                                       lambda: torch.amax(x0, dim=-1)),
                 "softmax_split_windows": (lambda: SM.softmax_split_windows(x0, m),
                                           lambda: SM.softmax_split_windows_plain(x0, m),
                                           None),
                 "softmax_split_probs": (lambda: SM.softmax_split_probs(x0, m, w),
                                         lambda: SM.softmax_split_probs_plain(x0, m, w),
                                         lambda: torch.softmax(x0, dim=-1))}
        for name in SPLIT_LAUNCHES:
            kern, plain, lib = calls[name]
            a, b = kern(), plain()
            check(torch.equal(a, b), f"{name} on {list(x0.shape)} differs from its "
                  "plain version")
            bound, by = card.bound(*work[name])
            rec = timed(
                dict(shape=list(x0.shape), max_abs_err=float((a - b).abs().max()),
                     bound_ms=bound, bound_by=by),
                kernel=times(torch, kern, name + "_kernel"),
                plain=times(torch, plain, None, 3, 1),
                library=times(torch, lib) if lib is not None else None)
            if keep:
                records[name] = rec
            log(f"[{name}] span {rec['shape']} of {list(s.shape)} over tp {tp}: "
                f"bit-exact; {fmt_times(rec)}")
        log(f"[softmax_2d split] {list(s.shape)} over {tp} spans: bit-equal to "
            "whole-row softmax_2d")


def long_softmax_rows(torch, gen):
    """The last 256 query rows of a 4000-token prompt's attend in a
    4096-lane bucket: (256, 4096) float32 scores, causal (-1e30 past each
    row's position)."""
    dev = torch.device(DEV)
    T, P = LONG_MAX_LEN, LONG_PROMPT
    s = torch.randn(256, T, generator=gen, device=dev) * 4
    qpos = torch.arange(P - 256, P, device=dev)[:, None]
    kpos = torch.arange(T, device=dev)[None, :]
    return torch.where(kpos <= qpos, s, torch.full_like(s, -1e30)).contiguous()


def log_softmax_wide_rows(torch, SM, gen, q20) -> str:
    """log_softmax_2d on rows too wide for a cluster's shared memory (its
    slices read from global memory in each pass), on both routes, and the
    launch's refusal of a split that is not its layout's."""
    from repro_torch.kernels import build
    from repro_torch.kernels import code_tables as CT

    cols = 400000
    plan = SM.log_softmax_plan(cols)
    check(not plan.staged, f"log_softmax_plan({cols}) keeps its slices in shared memory")
    w = torch.randn(4, cols, generator=gen, device=DEV) * 3
    w[0, cols - 5000:] = -1e30
    for kw, route in ((dict(), "table"), (q20, "Q2.20")):
        check(torch.equal(SM.log_softmax_2d(w, **kw), SM.log_softmax_2d_plain(w, **kw)),
              f"log_softmax_2d at {cols} lanes ({route}, from global memory) "
              "differs from its plain version")
    # the entry takes the split as numbers; one that leaves windows out,
    # leaves a CTA empty, or sizes shared memory off the layout is refused
    # (cudaErrorInvalidValue) and launches nothing
    y = torch.full_like(w, 7.0)
    tab, half = CT.table_args(CT.EXP_ROW, SM.PAPER_SCHEDULE, SM.PAPER_FIXED, w.device)
    n1 = SM.cols_padded(cols) // 32
    bad = {"windows left out": (8, 100, plan.smem),
           "an empty CTA": (8, n1 // 6, SM._ls_smem(n1, n1 // 6, False)),
           "a cluster of 9": (9, -(-n1 // 9), SM._ls_smem(n1, -(-n1 // 9), False)),
           "4 bytes short": (8, plan.windows, plan.smem - 4)}
    for what, (cs, wpc, smem) in bad.items():
        rc = build.library("softmax").cordic_log_softmax_2d(
            w.data_ptr(), y.data_ptr(), 4, cols, cs, wpc, smem, 0,
            build.params_ptr(SM.PAPER_SCHEDULE, SM.PAPER_FIXED), tab, half,
            build.stream_ptr(w))
        check(rc == 1, f"log_softmax_2d's entry took a split with {what} (rc {rc})")
    torch.cuda.synchronize()
    check(bool((y == 7.0).all()), "a refused log_softmax_2d launch wrote its output")
    return f"{list(w.shape)} from global memory ({plan}): bit-exact, and in Q2.20; {len(bad)} bad splits refused"


def sdpa_library(torch, what, q, pools, tables, k_len, scale):
    """The library call computing a decode attend's function: one
    ``scaled_dot_product_attention`` (exact softmax) on the dense K/V the
    table already gathered (the gather is not timed), keys past each row's
    k_len masked. GQA: q (B,KH,G,hd) against (B,KH,T,hd), ``enable_gqa``.
    MLA: one KV head, q = [q_eff | q_rope] (B,H,1,R+P) against k = [c | r],
    v = c. In q's dtype. Returns ((device ms, host ms), the output as the
    kernel lays it out, float32)."""
    import torch.nn.functional as Fn

    B, M = tables.shape
    L = pools[0].shape[1]
    T = M * L
    idx = tables.long()
    mask = (torch.arange(T, device=k_len.device)[None, :] < k_len[:, None])[:, None, None, :]
    if what == "gqa":
        KH, G, hd = q.shape[1:]
        k, v = (p[idx].reshape(B, T, KH, hd).transpose(1, 2).to(q.dtype).contiguous()
                for p in pools)
        qq = q.reshape(B, KH * G, 1, hd)
    else:
        qe, qr = q
        c = pools[0][idx].reshape(B, 1, T, -1).to(qe.dtype)
        r = pools[1][idx].reshape(B, 1, T, -1).to(qe.dtype)
        qq = torch.cat([qe, qr], dim=-1)[:, :, None, :].contiguous()
        k, v = torch.cat([c, r], dim=-1).contiguous(), c.contiguous()

    def call():
        return Fn.scaled_dot_product_attention(qq, k, v, attn_mask=mask, scale=scale,
                                               enable_gqa=True)
    out = call().float()
    out = out.reshape(B, *q.shape[1:]) if what == "gqa" else out[:, :, 0]
    return times(torch, call), out


def decode_kernels(torch, card, records, ycfg, dcfg, ops):
    """(4) and (9): the decode kernels, gqa_decode at Yi-9B's decode shape
    (with its kv_quant branch) and mla_decode at DeepSeek-V2-Lite's, on the
    launcher's tables (ragged, a vacant slot), then both at the
    long-context shape; inputs from their own generator (seed 0), so a
    --decode-kernels run sees the same ones."""
    from repro_torch.kernels import paged_attention as PA

    dev = torch.device(DEV)
    gen = torch.Generator(device=dev).manual_seed(0)
    t_sub = [time.perf_counter()]
    # (4) gqa_decode at Yi's decode shape, ragged and vacant slots
    B, KH, L, M = SLOTS, ycfg.num_kv_heads, BLOCK_LEN, MAX_LEN // BLOCK_LEN
    G, hd = ycfg.num_heads // KH, ycfg.head_dim
    klens = [37, 0, MAX_LEN, 5]                 # 0: vacant (k_len 1, scratch)
    N = 1 + B * M
    q = torch.randn(B, KH, G, hd, generator=gen, device=dev).bfloat16()
    kp = torch.randn(N, L, KH, hd, generator=gen, device=dev)
    vp = torch.randn(N, L, KH, hd, generator=gen, device=dev)
    tables = torch.zeros(B, M, dtype=torch.int32, device=dev)
    nxt = 1
    for r, k in enumerate(klens):
        for c in range(-(-k // L)):
            tables[r, c] = nxt
            nxt += 1
    k_len = torch.tensor([max(k, 1) for k in klens], dtype=torch.int32, device=dev)
    live_blocks = sum(-(-max(k, 1) // L) for k in klens)
    live_keys = sum(max(k, 1) for k in klens)
    kw = dict(scale=1.0 / math.sqrt(hd), kv_dtype=torch.bfloat16)
    lib_t, lib_out = sdpa_library(torch, "gqa", q, (kp, vp), tables, k_len, kw["scale"])
    log(f"[gqa_decode] library: scaled_dot_product_attention on the gathered "
        f"bfloat16 K/V (the gather not timed): {lib_t[0]:.4f} ms device, "
        f"{lib_t[1]:.4f} ms host-to-host; max |sdpa - exact kernel| "
        f"{float((lib_out - PA.gqa_decode(q, kp, vp, tables, k_len, softmax_impl='exact', **kw)).abs().max()):.3e}")
    for impl in ("cordic_pallas", "exact", "cordic_fixed"):
        a = PA.gqa_decode(q, kp, vp, tables, k_len, softmax_impl=impl, **kw)
        DECODE_OUTPUTS[f"gqa_decode[{impl}]"] = a.cpu()
        b, plain_t = plain_call(torch, lambda: PA.gqa_decode_plain(
            q, kp, vp, tables, k_len, softmax_impl=impl, **kw))
        err = float((a - b).abs().max())
        # stated tolerance: the reference's own ATOL 2e-5 and argmax
        # identity; the CORDIC impls (one summation order per output row,
        # the lanes replayed in the kernel) must be bit-equal
        check(bool(torch.isfinite(a).all()) and err < 2e-5,
              f"gqa_decode {impl}: |kernel - plain| {err} (ATOL 2e-5)")
        check(impl == "exact" or err == 0.0,
              f"gqa_decode {impl}: |kernel - plain| {err} (bit-equal)")
        check(torch.equal(a.reshape(B, -1).argmax(-1), b.reshape(B, -1).argmax(-1)),
              f"gqa_decode {impl}: argmax moved against plain")
        nbytes = (q.numel() * 2 + 2 * live_blocks * L * KH * hd * 4
                  + tables.numel() * 4 + k_len.numel() * 4 + a.numel() * 4)
        lanes = live_keys * KH * G
        int_ops = (ops["decode_lane"] if impl != "exact" else 0) * lanes
        bound, by = card.bound(nbytes, int_ops, 4 * hd * lanes)
        phases = {}
        rec = timed(
            dict(shape=[B, KH, G, hd, L, M], impl=impl, klens=klens,
                 max_abs_err=err, bit_equal=bool(torch.equal(a, b)),
                 bound_ms=bound, bound_by=by, phases=phases),
            kernel=times(torch, lambda: PA.gqa_decode(
                q, kp, vp, tables, k_len, softmax_impl=impl, **kw),
                "gqa_decode_kernel", parts=phases),
            plain=plain_t, library=lib_t)
        log(f"[gqa_decode] {impl} B={B} KH={KH} G={G} hd={hd} L={L} M={M} "
            f"k_len={[max(k, 1) for k in klens]}: max |kernel - plain| {err:.3e} "
            f"(bit-equal {rec['bit_equal']}); {fmt_times(rec)}")
        records["gqa_decode" + ("" if impl == "cordic_pallas" else f"[{impl}]")] = rec
    sub_phase("kernels (4) gqa_decode", t_sub)
    quant_decode_kernel(torch, card, records, q, tables, k_len, klens, gen, ops)
    sub_phase("kernels (4b) gqa_decode kv_quant", t_sub)

    # (9) mla_decode at DeepSeek-V2-Lite's decode shape: B 4 slots, H 16,
    # R 512 (kv_lora), P 64 (rope), L 16, M 8; the block tables and
    # lengths of (4) (ragged and vacant slots), bfloat16 absorbed queries,
    # float32 pools
    m = dcfg.mla
    H, R, P = dcfg.num_heads, m.kv_lora_rank, m.qk_rope_dim
    qe = torch.randn(B, H, R, generator=gen, device=dev).bfloat16()
    qr = torch.randn(B, H, P, generator=gen, device=dev).bfloat16()
    cp = torch.randn(N, L, R, generator=gen, device=dev)
    rp = torch.randn(N, L, P, generator=gen, device=dev)
    kw = dict(scale=1.0 / math.sqrt(m.qk_nope_dim + m.qk_rope_dim))
    args = (qe, qr, cp, rp, tables, k_len)
    lib_t, lib_out = sdpa_library(torch, "mla", (qe, qr), (cp, rp), tables, k_len,
                                  kw["scale"])
    log(f"[mla_decode] library: scaled_dot_product_attention, one KV head of "
        f"[c | r] (the gather not timed): {lib_t[0]:.4f} ms device, "
        f"{lib_t[1]:.4f} ms host-to-host; max |sdpa - exact kernel| "
        f"{float((lib_out - PA.mla_decode(*args, softmax_impl='exact', **kw)).abs().max()):.3e}")
    for impl in ("cordic_pallas", "exact", "cordic_fixed"):
        a = PA.mla_decode(*args, softmax_impl=impl, **kw)
        DECODE_OUTPUTS[f"mla_decode[{impl}]"] = a.cpu()
        b, plain_t = plain_call(torch, lambda: PA.mla_decode_plain(
            *args, softmax_impl=impl, **kw))
        err = float((a - b).abs().max())
        # stated tolerance: one summation order on both sides, so equal on
        # the CORDIC path; the exact path's expf may differ from torch.exp
        # by an ulp, held to the reference's own ATOL 2e-5
        check(bool(torch.isfinite(a).all()), f"mla_decode {impl}: finite")
        check(err == 0.0 if impl != "exact" else err < 2e-5,
              f"mla_decode {impl}: |kernel - plain| {err}")
        check(torch.equal(a.reshape(B, -1).argmax(-1), b.reshape(B, -1).argmax(-1)),
              f"mla_decode {impl}: argmax moved against plain")
        nbytes = (qe.numel() * 2 + qr.numel() * 2 + live_blocks * L * (R + P) * 4
                  + tables.numel() * 4 + k_len.numel() * 4 + a.numel() * 4)
        lanes = live_keys * H
        int_ops = (ops["decode_lane"] if impl != "exact" else 0) * lanes
        bound, by = card.bound(nbytes, int_ops, (2 * (R + P) + 2 * R) * lanes)
        phases = {}
        rec = timed(
            dict(shape=[B, H, R, P, L, M], impl=impl, klens=klens,
                 max_abs_err=err, bit_equal=bool(torch.equal(a, b)),
                 bound_ms=bound, bound_by=by, phases=phases),
            kernel=times(torch, lambda: PA.mla_decode(*args, softmax_impl=impl, **kw),
                         "mla_decode_kernel", parts=phases),
            plain=plain_t, library=lib_t)
        log(f"[mla_decode] {impl} B={B} H={H} R={R} P={P} L={L} M={M} "
            f"k_len={[max(k, 1) for k in klens]}: max |kernel - plain| {err:.3e} "
            f"(bit-equal {rec['bit_equal']}); {fmt_times(rec)}")
        records["mla_decode" + ("" if impl == "cordic_pallas" else f"[{impl}]")] = rec
    sub_phase("kernels (9) mla_decode", t_sub)

    long_decode_kernels(torch, card, records, ycfg, dcfg, gen, ops)
    sub_phase("kernels (9b) decode kernels at the long shape", t_sub)
    order_decode_kernels(torch, records, ycfg, dcfg, gen)
    sub_phase("kernels (9c) every score order", t_sub)


#: the score-order sweep (9c): (kind, rows-or-heads geometry, block length
#: L, kv_quant) for every order paged_attention.dot_order gives the kernels
ORDER_CASES = (
    ("gqa", dict(KH=4, G=8, hd=128), 16, "none"),      # 4 partials, tree
    ("gqa", dict(KH=4, G=8, hd=128), 32, "none"),      # a chain (L >= 17)
    ("gqa", dict(KH=32, G=1, hd=64), 16, "none"),      # a chain (G 1, musicgen)
    ("gqa", dict(KH=4, G=8, hd=128), 1, "none"),       # 8 partials, tree
    ("gqa", dict(KH=8, G=5, hd=128), 1, "none"),       # 8 partials, halves (Qwen)
    ("gqa", dict(KH=4, G=8, hd=128), 32, "int8"),      # a chain on int8 codes
    ("gqa", dict(KH=4, G=8, hd=128), 1, "q2_14"),      # 8 partials on Q2.14 codes
    ("mla", dict(H=16), 16, "none"),                   # 4 partials
    ("mla", dict(H=16), 32, "none"),                   # 2 partials
    ("mla", dict(H=16), 64, "none"),                   # a chain
    ("mla", dict(H=16), 1, "none"),                    # 8 partials, tree
    ("mla", dict(H=4), 1, "none"),                     # 8 partials, halves
    # the P.V orders (pv_order; the cases above take its chain in one piece)
    ("gqa", dict(KH=2, G=2, hd=8), 16, "none"),        # 4 partials (the JAX suite's width)
    ("gqa", dict(KH=2, G=2, hd=8), 16, "int8"),        # 4 partials on int8 codes
    ("mla", dict(H=16), 80, "none"),                   # Eigen's pieces of 64 lanes
    ("mla", dict(H=4, R=16, P=8), 4, "none"),          # 4 partials (the JAX suite's R)
)


def order_decode_kernels(torch, records, ycfg, dcfg, gen):
    """(9c) each score order of the decode kernels (``dot_order``: a chain,
    2, 4 or 8 strided partials, tree or halves) and each P.V order
    (``pv_order``: a chain in one piece or in Eigen's pieces, 4 partials;
    a pv kernel instantiation each), on float32 and quantized pools,
    against the plain version that replays it: cordic_pallas, bfloat16
    queries, B 4 slots at max_len MAX_LEN (k_len 37, vacant, 128, 5; at
    most a table's lanes), bit-equal. Device ms of the whole call and its
    phases go into the record. A tree without ``dot_order`` (an older tree
    under --decode-kernels) skips it."""
    from repro_torch.core import kv_quant as kvq
    from repro_torch.kernels import paged_attention as PA

    if not hasattr(PA, "dot_order"):
        log("[decode orders] this tree has no dot_order: skipped")
        return
    dev = torch.device(DEV)
    m = dcfg.mla
    for kind, geo, L, fmt in ORDER_CASES:
        B, M = SLOTS, -(-MAX_LEN // L)
        klens = [min(k, M * L) for k in (37, 0, MAX_LEN, 5)]
        R, P = geo.get("R", m.kv_lora_rank), geo.get("P", m.qk_rope_dim)
        N = 1 + B * M
        tables = torch.zeros(B, M, dtype=torch.int32)
        nxt = 1
        for r, k in enumerate(klens):
            for c in range(-(-k // L)):
                tables[r, c] = nxt
                nxt += 1
        tables = tables.to(dev)
        k_len = torch.tensor([max(k, 1) for k in klens], dtype=torch.int32, device=dev)
        if kind == "gqa":
            KH, G, hd = geo["KH"], geo["G"], geo["hd"]
            plan = PA.gqa_plan(B, KH, G, hd, L, M)
            q = torch.randn(B, KH, G, hd, generator=gen, device=dev).bfloat16()
            kf = torch.randn(N, L, KH, hd, generator=gen, device=dev)
            vf = torch.randn(N, L, KH, hd, generator=gen, device=dev)
            kw = dict(scale=1.0 / math.sqrt(hd), softmax_impl="cordic_pallas",
                      kv_dtype=torch.bfloat16)
            if fmt != "none":
                spec = kvq.spec_for(fmt)
                ks, vs = kvq.block_scale(kf, spec), kvq.block_scale(vf, spec)
                kf, vf = kvq.quantize(kf, spec, ks), kvq.quantize(vf, spec, vs)
                kw.update(kv_quant=fmt, k_scale_pool=ks, v_scale_pool=vs)
            args, kernel, plain = (q, kf, vf, tables, k_len), PA.gqa_decode, PA.gqa_decode_plain
            name = f"gqa_decode[KH{KH} G{G} hd{hd} L{L}{'' if fmt == 'none' else ' ' + fmt}]"
        else:
            H = geo["H"]
            plan = PA.mla_plan(B, H, R, P, L, M)
            args = (torch.randn(B, H, R, generator=gen, device=dev).bfloat16(),
                    torch.randn(B, H, P, generator=gen, device=dev).bfloat16(),
                    torch.randn(N, L, R, generator=gen, device=dev),
                    torch.randn(N, L, P, generator=gen, device=dev), tables, k_len)
            kw = dict(scale=1.0 / math.sqrt(m.qk_nope_dim + m.qk_rope_dim),
                      softmax_impl="cordic_pallas")
            kernel, plain = PA.mla_decode, PA.mla_decode_plain
            name = f"mla_decode[H{H} R{R} P{P} L{L}]"
        order, pv = plan.order, getattr(plan, "pv_order", None)
        a = kernel(*args, **kw)
        b = plain(*args, **kw)
        DECODE_OUTPUTS[name] = a.cpu()
        err = float((a - b).abs().max())
        check(order.mapped and (pv is None or pv.mapped),
              f"{name}: dot order {order} / P.V order {pv} is not mapped")
        check(bool(torch.isfinite(a).all()) and torch.equal(a, b),
              f"{name} order {order}, P.V {pv}: |kernel - plain| {err} (bit-equal)")
        phases = {}
        t = times(torch, lambda: kernel(*args, **kw), f"{kind}_decode_kernel", parts=phases)
        pv_desc = None if pv is None else [pv.partials, pv.combine, pv.chunk]
        records[name] = dict(order=[order.partials, order.combine], pv_order=pv_desc,
                             max_abs_err=err, bit_equal=True, ms=t[0], host_ms=t[1],
                             phases=phases)
        log(f"[decode orders] {name}: scores {order.partials} partial(s), {order.combine}; "
            f"P.V {pv_desc} (partials, combine, piece); bit-equal to plain; device "
            f"{t[0]:.4f} ms a call, phases {phases}")


def quant_decode_kernel(torch, card, records, q, tables, k_len, klens, gen, ops):
    """(4b) gqa_decode's kv_quant branch at the decode shape, tables and
    lengths of (4): int8 and Q2.14 codes with per-block per-head scales,
    made by kv_quant.block_scale / quantize from seeded floats. Every
    instantiation (q = kv_dtype float32 or bfloat16, the only pairs the
    kernel takes quantized pools for, three softmax impls) against the plain
    version, bit-equal (max |kernel - plain| = 0), and a mixed pair raises;
    timed with bfloat16 queries and kv_dtype on cordic_pallas, the serving
    configuration."""
    from repro_torch.core import kv_quant as kvq
    from repro_torch.kernels import paged_attention as PA

    B, KH, G, hd = q.shape
    L, M = BLOCK_LEN, tables.shape[1]
    N = 1 + B * M
    dev = q.device
    kf = torch.randn(N, L, KH, hd, generator=gen, device=dev) * 2
    vf = torch.randn(N, L, KH, hd, generator=gen, device=dev)
    q32 = q.float()
    live_blocks = sum(-(-max(k, 1) // L) for k in klens)
    lanes = sum(max(k, 1) for k in klens) * KH * G
    for fmt in KV_FORMATS:
        spec = kvq.spec_for(fmt)
        ks, vs = kvq.block_scale(kf, spec), kvq.block_scale(vf, spec)
        kq, vq = kvq.quantize(kf, spec, ks), kvq.quantize(vf, spec, vs)
        qkw = dict(scale=1.0 / math.sqrt(hd), kv_quant=fmt, k_scale_pool=ks,
                   v_scale_pool=vs)
        errs, plain_t = {}, None
        for impl in ("exact", "cordic_fixed", "cordic_pallas"):
            for dt in (torch.float32, torch.bfloat16):
                args = (q32.to(dt), kq, vq, tables, k_len)
                a = PA.gqa_decode(*args, softmax_impl=impl, kv_dtype=dt, **qkw)
                # the serving instantiation's plain call is also its timing
                b, t = plain_call(torch, lambda: PA.gqa_decode_plain(
                    *args, softmax_impl=impl, kv_dtype=dt, **qkw))
                if (impl, dt) == ("cordic_pallas", torch.bfloat16):
                    plain_t, b_serve = t, b
                err = float((a - b).abs().max())
                errs[(impl, str(dt)[6:])] = err
                check(bool(torch.isfinite(a).all()), f"gqa_decode[{fmt}] finite")
                check(err == 0.0, f"gqa_decode[{fmt}] {impl} q = kv_dtype {dt}: "
                      f"|kernel - plain| {err} (bit-equal)")
                check(torch.equal(a.reshape(B, -1).argmax(-1),
                                  b.reshape(B, -1).argmax(-1)),
                      f"gqa_decode[{fmt}] {impl}: argmax moved against plain")
        try:
            PA.gqa_decode(q32.bfloat16(), kq, vq, tables, k_len,
                          kv_dtype=torch.float32, **qkw)
            check(False, f"gqa_decode[{fmt}]: a mixed q / kv_dtype pair launched")
        except TypeError:
            pass
        log(f"[gqa_decode[{fmt}]] max |kernel - plain| by (impl, q = kv_dtype): "
            + ", ".join(f"{k[0]}/{k[1]} {v:.3e}" for k, v in errs.items())
            + "; a mixed q / kv_dtype pair raises")
        qb = q32.bfloat16()
        kw = dict(qkw, softmax_impl="cordic_pallas", kv_dtype=torch.bfloat16)
        a = PA.gqa_decode(qb, kq, vq, tables, k_len, **kw)
        DECODE_OUTPUTS[f"gqa_decode[{fmt}]"] = a.cpu()
        b = b_serve
        code_bytes = kq.element_size()
        nbytes = (qb.numel() * 2 + 2 * live_blocks * L * KH * hd * code_bytes
                  + 2 * live_blocks * KH * 4 + tables.numel() * 4
                  + k_len.numel() * 4 + a.numel() * 4)
        flops = 4 * hd * lanes + dequant_flops() * 2 * live_blocks * L * KH * hd
        bound, by = card.bound(nbytes, ops["decode_lane"] * lanes, flops)
        phases = {}
        rec = timed(
            dict(shape=[B, KH, G, hd, L, M], impl="cordic_pallas", kv_quant=fmt,
                 klens=klens, max_abs_err=float((a - b).abs().max()),
                 bit_equal=bool(torch.equal(a, b)), bound_ms=bound, bound_by=by,
                 phases=phases),
            kernel=times(torch, lambda: PA.gqa_decode(qb, kq, vq, tables, k_len, **kw),
                         "gqa_decode_kernel", parts=phases),
            plain=plain_t)
        log(f"[gqa_decode[{fmt}]] cordic_pallas bf16 B={B} KH={KH} G={G} hd={hd} "
            f"L={L} M={M} k_len={[max(k, 1) for k in klens]}: max |kernel - "
            f"plain| {rec['max_abs_err']:.3e}; {fmt_times(rec)}")
        records[f"gqa_decode[{fmt}]"] = rec


def long_decode_kernels(torch, card, records, ycfg, dcfg, gen, ops):
    """(9b) gqa_decode and mla_decode at the long-context shape, the pools
    of an engine at max_len LONG_MAX_LEN: M 256 table columns, N 1025
    blocks, ragged lengths with a vacant slot (LONG_KLENS: 664 live blocks,
    10,598 live keys). Every GQA branch (three impls on float32 pools,
    cordic_pallas on int8 and Q2.14 pools; bfloat16 queries and kv_dtype)
    and every MLA impl (bfloat16 queries) against its plain version:
    bit-equal on the CORDIC impls and the integer pools, ATOL 2e-5 on
    exact, argmax equal. The plain version runs once per branch, for the
    check; its ``plain_ms`` is that one call's time by CUDA events (host
    gaps included), not a profiled device time. Each branch also runs with
    16-block softmax tiles (a row of up to 256 blocks in 16 tiles: the path
    of rows longer than SOFTMAX_TILE_LANES), bit-equal to the one-tile
    run."""
    from repro_torch.core import kv_quant as kvq
    from repro_torch.kernels import paged_attention as PA

    dev = torch.device(DEV)
    B, L, M = SLOTS, BLOCK_LEN, LONG_MAX_LEN // BLOCK_LEN
    KH, G, hd = ycfg.num_kv_heads, ycfg.num_heads // ycfg.num_kv_heads, ycfg.head_dim
    N = 1 + B * M
    tables = torch.zeros(B, M, dtype=torch.int32)
    nxt = 1
    for r, k in enumerate(LONG_KLENS):
        for c in range(-(-k // L)):
            tables[r, c] = nxt
            nxt += 1
    tables = tables.to(dev)
    k_len = torch.tensor(LONG_KLENS, dtype=torch.int32, device=dev)
    live_blocks = sum(-(-k // L) for k in LONG_KLENS)
    live_keys = sum(LONG_KLENS)
    q = torch.randn(B, KH, G, hd, generator=gen, device=dev).bfloat16()
    kf = torch.randn(N, L, KH, hd, generator=gen, device=dev)
    vf = torch.randn(N, L, KH, hd, generator=gen, device=dev)
    m = dcfg.mla
    H, R, P = dcfg.num_heads, m.kv_lora_rank, m.qk_rope_dim
    qe = torch.randn(B, H, R, generator=gen, device=dev).bfloat16()
    qr = torch.randn(B, H, P, generator=gen, device=dev).bfloat16()
    cp = torch.randn(N, L, R, generator=gen, device=dev)
    rp = torch.randn(N, L, P, generator=gen, device=dev)
    # a tree from before the plans (a --decode-kernels run of an older
    # tree) times its kernels without the plan's report and tiled check
    tiled = {}
    if hasattr(PA, "SOFTMAX_TILE_LANES"):
        gplan, mplan = PA.gqa_plan(B, KH, G, hd, L, M), PA.mla_plan(B, H, R, P, L, M)
        tiled = {"gqa_decode": PA.gqa_plan(B, KH, G, hd, L, M, 16 * L),
                 "mla_decode": PA.mla_plan(B, H, R, P, L, M, 16 * L)}
        log(f"[long decode] B={B} M={M} N={N} k_len={LONG_KLENS}: {live_blocks} live "
            f"blocks, {live_keys} live keys; gqa_decode CTAs (score, softmax, pv, fold) "
            f"{gplan.ctas}, score CTAs with live blocks "
            f"{gplan.live_score_ctas(LONG_KLENS, L)}, workspace "
            f"{4 * gplan.workspace_floats} bytes; mla_decode CTAs {mplan.ctas}, "
            f"score CTAs with live blocks {mplan.live_score_ctas(LONG_KLENS, L)}, "
            f"workspace {4 * mplan.workspace_floats} bytes")
    meta = tables.numel() * 4 + k_len.numel() * 4
    # the library call on the float32 pools' function, per kernel
    lib = {"gqa_decode": sdpa_library(torch, "gqa", q, (kf, vf), tables, k_len,
                                      1.0 / math.sqrt(hd))[0],
           "mla_decode": sdpa_library(torch, "mla", (qe, qr), (cp, rp), tables, k_len,
                                      1.0 / math.sqrt(m.qk_nope_dim + m.qk_rope_dim))[0]}
    log(f"[long decode] library: scaled_dot_product_attention on the gathered "
        f"bfloat16 K/V (the gather not timed): {lib}")
    cases = []
    for impl, fmt in (("cordic_pallas", "none"), ("exact", "none"),
                      ("cordic_fixed", "none"), ("cordic_pallas", "int8"),
                      ("cordic_pallas", "q2_14")):
        kw = dict(scale=1.0 / math.sqrt(hd), softmax_impl=impl, kv_dtype=torch.bfloat16)
        kp, vp, code_bytes, flops = kf, vf, 4, 4 * hd * live_keys * KH * G
        scale_bytes = 0
        if fmt != "none":
            spec = kvq.spec_for(fmt)
            ks, vs = kvq.block_scale(kf * 2, spec), kvq.block_scale(vf, spec)
            kp, vp = kvq.quantize(kf * 2, spec, ks), kvq.quantize(vf, spec, vs)
            kw.update(kv_quant=fmt, k_scale_pool=ks, v_scale_pool=vs)
            code_bytes = kp.element_size()
            scale_bytes = 2 * live_blocks * KH * 4
            flops += dequant_flops() * 2 * live_keys * KH * hd
        nbytes = (q.numel() * 2 + 2 * live_keys * KH * hd * code_bytes + scale_bytes
                  + meta + q.numel() * 4)
        int_ops = (ops["decode_lane"] if impl != "exact" else 0) * live_keys * KH * G
        name = ("gqa_decode" + {"cordic_pallas": "", "exact": "[exact",
                                "cordic_fixed": "[cordic_fixed"}[impl]
                + (f"[{fmt}" if fmt != "none" else ""))
        name = (name + ",long]") if "[" in name else name + "[long]"
        args = (q, kp, vp, tables, k_len)
        cases.append((name, impl, lambda a=args, kw=kw, **pl: PA.gqa_decode(*a, **kw, **pl),
                      lambda a=args, kw=kw: PA.gqa_decode_plain(*a, **kw),
                      "gqa_decode_kernel", nbytes, int_ops, flops, B * KH * G))
    for impl in ("cordic_pallas", "exact", "cordic_fixed"):
        kw = dict(scale=1.0 / math.sqrt(m.qk_nope_dim + m.qk_rope_dim), softmax_impl=impl)
        nbytes = (qe.numel() * 2 + qr.numel() * 2 + live_keys * (R + P) * 4 + meta
                  + qe.numel() * 4)
        lanes = live_keys * H
        int_ops = (ops["decode_lane"] if impl != "exact" else 0) * lanes
        name = {"cordic_pallas": "mla_decode[long]", "exact": "mla_decode[exact,long]",
                "cordic_fixed": "mla_decode[cordic_fixed,long]"}[impl]
        args = (qe, qr, cp, rp, tables, k_len)
        cases.append((name, impl, lambda a=args, kw=kw, **pl: PA.mla_decode(*a, **kw, **pl),
                      lambda a=args, kw=kw: PA.mla_decode_plain(*a, **kw),
                      "mla_decode_kernel", nbytes, int_ops,
                      (2 * (R + P) + 2 * R) * lanes, B * H))
    for name, impl, fn, plain, kernel, nbytes, int_ops, flops, rows in cases:
        a = fn()
        DECODE_OUTPUTS[name] = a.cpu()
        if tiled:
            check(torch.equal(fn(plan=tiled[kernel.removesuffix('_kernel')]), a),
                  f"{name}: 16-block softmax tiles differ from one tile")
        b, (plain_ms, _) = plain_call(torch, plain)
        err = float((a - b).abs().max())
        check(bool(torch.isfinite(a).all()), f"{name}: finite")
        check(err == 0.0 if impl != "exact" else err < 2e-5,
              f"{name}: |kernel - plain| {err}")
        check(torch.equal(a.reshape(B, -1).argmax(-1), b.reshape(B, -1).argmax(-1)),
              f"{name}: argmax moved against plain")
        bound, by = card.bound(nbytes, int_ops, flops)
        phases = {}
        ms, hms = times(torch, fn, kernel, 10, 20, phases)
        lib_t = (lib[kernel.removesuffix("_kernel")]
                 if "int8" not in name and "q2_14" not in name else (None, None))
        rec = dict(shape=[B, M, N], impl=impl, klens=LONG_KLENS, max_abs_err=err,
                   phases=phases,
                   bit_equal=bool(torch.equal(a, b)), bound_ms=bound, bound_by=by,
                   ms=ms, host_ms=hms, plain_ms=plain_ms,
                   plain_host_ms=None, library_ms=lib_t[0], library_host_ms=lib_t[1])
        records[name] = rec
        log(f"[{name}] rows {rows}, k_len {LONG_KLENS}: max |kernel - plain| "
            f"{err:.3e} (bit-equal {rec['bit_equal']}); device {ms:.4f} ms per "
            f"call (host-to-host {hms:.4f} ms; by phase {phases}); plain, one check "
            f"call {rec['plain_ms']:.1f} ms (CUDA events); bound {bound:.5f} ms by {by}")
        del a, b


def timed(rec, kernel, plain, library=None):
    """A kernel record with its device times (``ms``, ``plain_ms``,
    ``library_ms``) and host-to-host times (``*_host_ms``)."""
    for key, t in (("ms", kernel), ("plain_ms", plain), ("library_ms", library)):
        rec[key] = t[0] if t else None
        rec[key.replace("ms", "host_ms")] = t[1] if t else None
    return rec


def fmt_times(r) -> str:
    lib = (f", library {r['library_ms']:.4f} ms (host {r['library_host_ms']:.4f})"
           if r["library_ms"] is not None else "")
    plain = (f"plain {r['plain_ms']:.4f} ms (host {r['plain_host_ms']:.2f})"
             if r["plain_host_ms"] is not None else
             f"plain, one check call {r['plain_ms']:.1f} ms (CUDA events)")
    return (f"device {r['ms']:.4f} ms per call (host-to-host {r['host_ms']:.4f} "
            f"ms); {plain}{lib}; bound {r['bound_ms']:.5f} ms by {r['bound_by']}")


# ---------------------------------------------------------------------------
# Phase 4: the main paths
# ---------------------------------------------------------------------------
def sigmoid_q_map(torch, ycfg):
    """The integer path's input: a (d_model, d_ff) = (4096, 11008) map of
    Q2.14 int16 codes (normal draws, saturated to the format)."""
    dev = torch.device(DEV)
    x = torch.randn(ycfg.d_model, ycfg.d_ff, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(2))
    return torch.round(x * (1 << 14)).clamp(-(1 << 15), (1 << 15) - 1).to(torch.int16)


def sigmoid_path(torch, build, ycfg):
    """The paper's unit through the front door, as examples/quickstart.py
    uses it: ops.sigmoid on the [-1, 1] code grid and on a (d_model, d_ff)
    = (4096, 11008) activation map; the integer datapath ops.sigmoid_q on
    all 2^16 Q2.14 codes and on a code map of the same shape."""
    from repro_torch.kernels import ops

    dev = torch.device(DEV)
    grid = torch.arange(-(1 << 14), (1 << 14) + 1, device=dev) / float(1 << 14)
    acts = torch.randn(ycfg.d_model, ycfg.d_ff, device=dev,
                       generator=torch.Generator(device=dev).manual_seed(1))
    codes = torch.arange(-(1 << 15), 1 << 15, device=dev).to(torch.int16)
    qmap = sigmoid_q_map(torch, ycfg)
    build.reset_launches()
    y1, y2 = ops.sigmoid(grid), ops.sigmoid(acts)
    q1, q2 = ops.sigmoid_q(codes), ops.sigmoid_q(qmap)
    torch.cuda.synchronize()
    counts = dict(build.LAUNCHES)
    check(y1.shape == grid.shape and y2.shape == acts.shape, "ops.sigmoid shape")
    check(bool(torch.isfinite(y2).all()) and float(y2.min()) >= 0.0,
          "ops.sigmoid output finite and in [0, 1]")
    check(q1.dtype == q2.dtype == torch.int16 and q2.shape == qmap.shape,
          "ops.sigmoid_q keeps dtype and shape")
    check(int(q2.min()) >= 0 and int(q2.max()) <= 1 << 14,
          "ops.sigmoid_q codes inside [0, 1]")
    # the float and integer paths agree on the [-1, 1] grid's codes
    same = torch.equal(q1[(1 << 15) - (1 << 14):(1 << 15) + (1 << 14) + 1].long(),
                       torch.round(y1 * (1 << 14)).long())
    check(same, "ops.sigmoid_q codes differ from ops.sigmoid on [-1, 1]")
    log(f"[path sigmoid] ops.sigmoid on {grid.numel()} + {acts.numel()} "
        f"values, ops.sigmoid_q on {codes.numel()} + {qmap.numel()} int16 "
        f"codes (equal to ops.sigmoid's on [-1, 1]); launches {counts}")
    # the engine's other function kinds reach act_2d through the registry:
    # gelu_erf of the same activation map
    from repro_torch.core.activations import get_activation

    gelu = get_activation("gelu_erf", "cordic_pallas")
    build.reset_launches()
    g = gelu(acts)
    torch.cuda.synchronize()
    gelu_counts = dict(build.LAUNCHES)
    check(g.shape == acts.shape and bool(torch.isfinite(g).all()),
          "gelu_erf output finite, of the input's shape")
    check(float((g - torch.nn.functional.gelu(acts)).abs().max()) < 1e-3,
          "gelu_erf within the approximation's 1e-3 of the erf GELU")
    log(f"[path sigmoid] get_activation('gelu_erf', 'cordic_pallas') on "
        f"{acts.numel()} values: max |y - gelu| "
        f"{float((g - torch.nn.functional.gelu(acts)).abs().max()):.3e}; "
        f"launches {gelu_counts}")
    return counts, gelu_counts


#: kernels whose per-step device time the serve profile reports, per arch
SERVE_PROFILE = {
    "yi-9b": ("silu_mul_kernel", "softmax_kernel", "gqa_decode_kernel"),
    # cuBLAS names its Hopper GEMM kernels nvjet_*: the MoE experts' and
    # the head's products
    DEEPSEEK: ("mla_decode_kernel", "act_kernel", "silu_mul_kernel",
               "softmax_kernel", "nvjet"),
}


def arch_line(cfg) -> str:
    if cfg.mla is None:
        return (f"{cfg.num_layers} layers, d_model {cfg.d_model}, "
                f"{cfg.num_heads}/{cfg.num_kv_heads} heads, d_ff {cfg.d_ff}")
    m, e = cfg.mla, cfg.moe
    return (f"{cfg.num_layers} layers ({cfg.block_pattern.count('mla_dense')} "
            f"mla_dense, {cfg.block_pattern.count('mla_moe')} mla_moe), d_model "
            f"{cfg.d_model}, {cfg.num_heads} heads, MLA kv_lora {m.kv_lora_rank} "
            f"qk_nope {m.qk_nope_dim} qk_rope {m.qk_rope_dim} v {m.v_dim}, dense "
            f"FFN {cfg.d_ff_dense}, {e.num_experts} experts x {e.d_ff_expert} "
            f"top-{e.top_k} + {e.num_shared_experts} shared ({e.router_score} "
            "router)")


#: the datapaths each arch is served on: (act_impl, softmax_impl)
SERVE_IMPLS = (("cordic_pallas", "cordic_pallas"), ("cordic_fixed", "cordic_fixed"))


def depth_view(cfg, model, layers):
    """``cfg`` and ``model`` cut to their first ``layers`` blocks: a view
    whose blocks, embedding, final norm and head are ``model``'s own
    tensors (nothing is copied; ``model`` keeps all its blocks). Returns
    (cut cfg, view)."""
    import copy
    import dataclasses

    from torch import nn

    cut = dataclasses.replace(cfg, num_layers=layers,
                              block_pattern=cfg.block_pattern[:layers])
    view = copy.copy(model)
    view._modules = dict(model._modules)
    view._modules["blocks"] = nn.ModuleList(list(model.blocks)[:layers])
    view.cfg = cut
    return cut, view


def side_view(cfg, model):
    """``depth_view`` at SIDE_LAYERS, and the log's note of the cut."""
    layers = SIDE_LAYERS[cfg.name.removesuffix("-smoke")]
    if layers >= cfg.num_layers:
        return cfg, model, "full depth"
    cut, view = depth_view(cfg, model, layers)
    return cut, view, (f"depth cut {cfg.num_layers} -> {layers} layers (a view of "
                       "the model's first blocks, for the time limit)")


def serve_path(torch, build, arch):
    """An arch at full width through ServeEngine: paged KV, decode kernel,
    greedy, the launcher's traffic; served once per datapath of
    SERVE_IMPLS on one model (the weights do not depend on the datapath;
    cordic_fixed on its first SIDE_LAYERS blocks). Returns {act_impl:
    (launch counts, stats)}."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.models import transformer as tf

    base = configs.get_config(arch, act_impl="cordic_pallas")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    model = tf.init(base, seed=0, device=DEV)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[path serve {arch}] {base.name}: {arch_line(base)}, vocab "
        f"{base.vocab_size}, {base.dtype}; {n_params / 1e9:.2f}B params (spec "
        f"{base.param_counts()['total'] / 1e9:.2f}B), weights "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB, init "
        f"{time.perf_counter() - t0:.1f} s")
    out = {}
    for act_impl, softmax_impl in SERVE_IMPLS:
        cfg = dataclasses.replace(base, act_impl=act_impl, softmax_impl=softmax_impl)
        served = model
        if act_impl == "cordic_fixed":
            cfg, served, cut = side_view(cfg, model)
            log(f"[path serve {arch} {act_impl}/{softmax_impl}] {cut}")
        t0 = time.perf_counter()
        out[act_impl] = serve_run(torch, build, arch, cfg, served)
        log(f"[time] serve {arch} {act_impl}: {time.perf_counter() - t0:.1f} s "
            "(warm-up, traffic, logits check, profile)")
        # the long-context serve on this datapath (Yi's kernel datapath also
        # on the quantized pools): the decode kernel's branch at M 256
        t0 = time.perf_counter()
        yi_kernels = arch == "yi-9b" and act_impl == "cordic_pallas"
        formats = ("none",) + (KV_FORMATS if yi_kernels else ())
        quant_view = side_view(cfg, served)[:2] if yi_kernels else None
        out[f"long {act_impl}"] = long_context_pools(torch, build, cfg, served, formats,
                                                     cache_on=yi_kernels,
                                                     quant_view=quant_view)
        log(f"[time] long-context path {arch} {act_impl}: "
            f"{time.perf_counter() - t0:.1f} s")
    if arch == "yi-9b":
        cfg = dataclasses.replace(base, softmax_impl="cordic_pallas")
        ref = out["cordic_pallas"][1]
        for fmt in KV_FORMATS:
            t0 = time.perf_counter()
            # the profile of int8 only, within the time limit
            out[fmt] = serve_run(torch, build, arch, cfg, model, kv_quant=fmt,
                                 n_prof=PROFILE_STEPS if fmt == "int8" else 0)
            st = out[fmt][1]
            same = sum(a == b for rid, toks in ref["out"].items()
                       for a, b in zip(toks, st["out"][rid]))
            log(f"[path serve {arch} kv_quant={fmt}] greedy match against the "
                f"float32 pools' cordic_pallas tokens: {same}/{ref['tokens']} = "
                f"{same / ref['tokens']:.4f} (random weights: reported, not "
                f"gated); pool bytes {st['pool_bytes']} vs {ref['pool_bytes']}: "
                f"{ref['pool_bytes'] / st['pool_bytes']:.3f}x fewer; tok/s "
                f"{st['tok_s'] / ref['tok_s']:.3f}x, step p50 "
                f"{st['step_ms_p50'] / ref['step_ms_p50']:.3f}x, TTFT p50 "
                f"{st['ttft_ms_p50'] / ref['ttft_ms_p50']:.3f}x the float32 run's")
            log(f"[time] serve {arch} kv_quant={fmt}: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        side_cfg, side, cut = side_view(cfg, model)
        log(f"[path serve {arch}] the prefix and chunked traces: {cut}")
        out["prefix"] = prefix_path(torch, build, side_cfg, side)
        log(f"[time] prefix path: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        out["chunked"] = chunked_path(torch, build, side_cfg, side)
        del side
        log(f"[time] chunked path: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        out["dense"] = dense_path(torch, build, cfg, model, ref)
        log(f"[time] dense path: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        out["sampling"] = sampling_path(torch, build, cfg, model, ref)
        log(f"[time] sampling path: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        out["obs"] = obs_path(torch, build, cfg, model, ref)
        log(f"[time] obs path: {time.perf_counter() - t0:.1f} s")
    else:
        cfg = dataclasses.replace(base, softmax_impl="cordic_pallas")
        t0 = time.perf_counter()
        reqs, counts, _ = serve_trace(torch, build, cfg, model, chunked_trace(cfg),
                                      "trace 1, chunked", prefill_chunk=CHUNK,
                                      prefill_batch=CHUNK_BATCH)
        out["chunked"] = {"chunked": counts}
        log(f"[time] chunked path: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        out["dense"] = dense_path(torch, build, cfg, model, out["cordic_pallas"][1],
                                  long=False)
        log(f"[time] dense path: {time.perf_counter() - t0:.1f} s")
    del model
    torch.cuda.empty_cache()
    return out


def serve_run(torch, build, arch, cfg, model, kv_quant="none", n_prof=None):
    """The launcher's traffic through one engine, launch counts zeroed just
    before and read just after; step times, TTFT, memory, a profile of
    ``n_prof`` decode steps (None: PROFILE_STEPS on the kernels' datapath, none on the
    plain one, whose ~40,000 launches a step the profiler booked in ~27 s a
    step; 0: none)."""
    from repro_torch.launch.serve import make_requests
    from repro_torch.models import transformer as tf
    from repro_torch.serve.engine import ServeEngine

    tag = f"[path serve {arch} {cfg.act_impl}/{cfg.softmax_impl}" + (
        f" kv_quant={kv_quant}]" if kv_quant != "none" else "]")
    eng = ServeEngine(cfg, model, slots=SLOTS, max_len=MAX_LEN, kv_impl="paged",
                      block_len=BLOCK_LEN, paged_attend_impl="pallas",
                      kv_quant=kv_quant, device=DEV)
    # warm-up request (cuBLAS handles, first launches), outside the counts
    for r in make_requests(cfg, 1, 2, seed=99):
        eng.submit(r)
    eng.run()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    reqs = make_requests(cfg, REQUESTS, MAX_NEW, seed=0)
    build.reset_launches()
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
    counts = dict(build.LAUNCHES)
    done = reqs
    check(all(r.done and r.error is None and len(r.out) == MAX_NEW for r in done),
          "every request finishes with its tokens")
    check(all(0 <= t < cfg.vocab_size for r in done for t in r.out),
          "tokens inside the vocabulary")
    n_tok = sum(len(r.out) for r in done)
    ttft = sorted((r.t_first - r.t_enqueue) * 1e3 for r in done)
    peak = torch.cuda.max_memory_allocated()
    # the logits of a plain forward of one served prompt are finite
    logits = tf.apply(model, {"tokens": torch.as_tensor(
        done[0].prompt[None], device=DEV).long()}, cfg)[0]
    check(bool(torch.isfinite(logits).all()), "finite logits")
    if kv_quant != "none":
        check(counts.get("gqa_decode", 0) == cfg.num_layers * len(steps),
              f"{tag} gqa_decode launched {counts.get('gqa_decode', 0)} times, "
              f"not {cfg.num_layers} x {len(steps)} decode steps")
        pre, dec = quant_logits(torch, model, eng.cfg, done[0].prompt)
        check(bool(torch.isfinite(pre).all()) and bool(torch.isfinite(dec).all()),
              f"{tag} finite logits through a quantized paged cache")
    stats = dict(requests=len(done), tokens=n_tok, wall_s=wall,
                 tok_s=n_tok / wall, ttft_ms_p50=statistics.median(ttft),
                 ttft_ms_max=ttft[-1], step_ms_p50=statistics.median(steps) * 1e3,
                 steps=len(steps), peak_gib=peak / 2**30,
                 pool_gib=eng.kv_pool_bytes() / 2**30,
                 pool_bytes=eng.kv_pool_bytes(), launches=counts,
                 out={r.rid: r.out for r in done})
    log(f"{tag} {len(done)} requests, {n_tok} tokens in {wall:.3f} s: "
        f"{stats['tok_s']:.1f} tok/s; TTFT p50 {stats['ttft_ms_p50']:.1f} ms, "
        f"max {stats['ttft_ms_max']:.1f} ms; step p50 {stats['step_ms_p50']:.2f} "
        f"ms over {len(steps)} steps; peak memory {stats['peak_gib']:.2f} GiB "
        f"(pools {stats['pool_gib']:.3f} GiB); launches {counts}")
    log(f"{tag} clocks/power after serving: "
        f"{smi('clocks.sm,power.draw,power.limit,temperature.gpu')}")
    log(f"{tag} tokens " + json.dumps({r.rid: r.out for r in done}))
    # the plain datapath issues ~40,000 launches a step; the profiler's
    # bookkeeping of them is slow, so it is not profiled
    t0 = time.perf_counter()
    if n_prof is None:
        n_prof = PROFILE_STEPS if cfg.act_impl == "cordic_pallas" else 0
    stats["profile"] = (profile_steps(torch, eng, cfg, SERVE_PROFILE[arch], n_prof)
                        if n_prof else None)
    log(f"[time] {tag} profile of {n_prof} steps: {time.perf_counter() - t0:.1f} s")
    if (arch == "yi-9b" and cfg.act_impl == "cordic_pallas" and kv_quant == "none"
            and n_prof):
        t0 = time.perf_counter()
        cost_line(torch, eng, cfg, stats["profile"], n_prof)
        log(f"[time] {tag} cost line: {time.perf_counter() - t0:.1f} s")
    del eng, logits
    torch.cuda.empty_cache()
    return counts, stats


#: the cost line's gate: the counted bound of a decode step may exceed the
#: device time the profile measured for such a step by this factor at most
COST_BOUND_SLACK = 1.05


def cost_line(torch, eng, cfg, prof, n_prof):
    """One Yi-9B launcher decode step counted by launch/op_cost.py (every
    aten op's FLOPs and bytes, each kernel wrapper's booked work, against
    the card's peaks: the data sheet's dense BF16, FP32, HBM and NVLink
    rates and this card's INT32 rate) beside the device time per step that
    the profile window just measured on the same engine (``prof``), and
    their ratio. The counted step is the first decode step of the
    profile's traffic again (SLOTS fresh requests). Gate: the bound is not
    above the measured time by more than COST_BOUND_SLACK (a bound above
    the measurement means the count is wrong). Reported only."""
    from repro_torch.launch import op_cost
    from repro_torch.launch.serve import make_requests

    if prof is None:
        log("[cost] yi-9b decode step: the profiler saw no device time; not measured")
        return None
    for r in make_requests(cfg, SLOTS, n_prof + 2, seed=7):
        eng.submit(r)
    eng.step()                                 # prefills + a first decode
    torch.cuda.synchronize()
    with op_cost.OpCost() as oc:
        eng.step()
        torch.cuda.synchronize()
    eng.run()
    counts = oc.result()
    card = Card(torch)
    peaks = dict(kcost().PEAKS, int32_op_s=card.int32_ops_s)
    terms = op_cost.roofline_terms(counts, peaks)
    bound_ms = terms["bound_s"] * 1e3
    measured_ms = prof["busy_ms"] / n_prof
    ratio = bound_ms / measured_ms
    log(f"[cost] yi-9b launcher decode step ({SLOTS} slots): counted "
        f"{counts['product_flops']:.4g} product FLOPs, {counts['other_flops']:.4g} "
        f"other FLOPs, {counts['kernel_int_ops']:.4g} kernel INT32 ops, "
        f"{counts['hbm_bytes']:.4g} HBM bytes over {counts['aten_ops']} aten ops and "
        f"kernel calls {counts['kernel_calls']}; terms compute "
        f"{terms['compute_s'] * 1e3:.4f} ms, memory {terms['memory_s'] * 1e3:.4f} ms "
        f"({terms['dominant']}); bound {bound_ms:.4f} ms vs device time "
        f"{measured_ms:.4f} ms a step (profile window of {n_prof} steps): ratio "
        f"{ratio:.4f} (gate <= {COST_BOUND_SLACK}); peaks {peaks}")
    check(ratio <= COST_BOUND_SLACK, f"the counted bound of a Yi-9B decode step "
          f"{bound_ms:.4f} ms exceeds its measured device time {measured_ms:.4f} ms")
    RESULTS["cost yi-9b decode step"] = dict(
        bound_ms=bound_ms, measured_ms=measured_ms, ratio=ratio,
        dominant=terms["dominant"], hbm_bytes=counts["hbm_bytes"],
        product_flops=counts["product_flops"], kernel_calls=counts["kernel_calls"])
    return ratio


def quant_logits(torch, model, cfg, prompt):
    """Logits of a bucket-wide prefill of ``prompt`` and of one decode step
    (through gqa_decode's kv_quant branch) in a fresh one-slot quantized
    paged cache; ``cfg`` is the serving engine's."""
    from repro_torch.models import transformer as tf

    M = MAX_LEN // BLOCK_LEN
    cache = tf.init_paged_cache(cfg, 1, M + 1, BLOCK_LEN, M, device=DEV)
    cache.tables[0] = torch.arange(1, M + 1, dtype=torch.int32, device=DEV)
    toks = torch.zeros(1, BLOCK_LEN, dtype=torch.long, device=DEV)
    toks[0, :len(prompt)] = torch.as_tensor(prompt, device=DEV)
    pre = tf.apply(model, {"tokens": toks}, cfg, cache=cache)[0][:, :len(prompt)]
    cache.lens[0] = len(prompt)              # the pad tail is not kept
    nxt = pre[:, -1].argmax(-1, keepdim=True)
    dec = tf.apply(model, {"tokens": nxt}, cfg, cache=cache)[0]
    return pre, dec


def prefix_path(torch, build, cfg, model):
    """The radix prefix cache at Yi-9B width over int8 pools: a prime
    request of a PREFIX_LEN-token shared prompt served to completion, then
    PREFIX_WAVE requests of that prompt plus a 3-8-token tail (a chat or
    agent deployment whose requests share one system prompt), MAX_NEW new
    tokens each, with the cache off, on, and on with chunks of CHUNK packed
    CHUNK_BATCH rows a dispatch, one engine each. The paged prefill runs
    the row-count-invariant product (kernels/gemm.py), so a position's K, V
    and logits do not depend on where its prefill started or how many rows
    shared its dispatch: every cache-on token must equal the cache-off
    run's (ROADMAP B.10)."""
    import numpy as np

    from repro_torch.serve.engine import Request, ServeEngine

    rng = np.random.default_rng(11)
    shared = rng.integers(0, cfg.vocab_size, PREFIX_LEN).astype(np.int32)
    tails = [rng.integers(0, cfg.vocab_size, int(rng.integers(3, 9))).astype(np.int32)
             for _ in range(PREFIX_WAVE)]

    def request(rid):
        prompt = shared.copy() if rid == 0 else np.concatenate([shared, tails[rid - 1]])
        return Request(rid=rid, prompt=prompt, max_new_tokens=MAX_NEW)

    runs = {"off": dict(prefix_cache=False), "on": dict(prefix_cache=True),
            "on, multi-row": dict(prefix_cache=True, prefill_chunk=CHUNK,
                                  prefill_batch=CHUNK_BATCH),
            "off, float32 chain": dict(prefix_cache=False)}
    res = {}
    for name, kw in runs.items():
        with chain_products(name.endswith("float32 chain")):
            eng = ServeEngine(cfg, model, slots=SLOTS, max_len=MAX_LEN, kv_impl="paged",
                              block_len=BLOCK_LEN, paged_attend_impl="pallas",
                              kv_quant="int8", device=DEV, **kw)
        groups = []
        dispatch = eng._dispatch_prefill
        eng._dispatch_prefill = lambda g: (groups.append(len(g)), dispatch(g))
        prime = request(0)
        eng.submit(prime)
        eng.run()
        wave = [request(1 + i) for i in range(PREFIX_WAVE)]
        pre_tokens, hit0 = eng.prefill_tokens, eng.prefix_hit_tokens
        groups.clear()
        build.reset_launches()
        t0 = time.perf_counter()
        for r in wave:
            eng.submit(r)
        shared_peak = 0
        while eng.has_work:
            eng.step()
            shared_peak = max(shared_peak, eng.pager.blocks_shared)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check(all(r.done and len(r.out) == MAX_NEW for r in wave),
              "prefix trace: every request finishes")
        hits = eng.prefix_hit_tokens - hit0
        ttft = sorted((r.t_first - r.t_enqueue) * 1e3 for r in wave)
        res[name] = r = dict(
            tokens=[prime.out] + [r.out for r in wave], hit_tokens=hits,
            prompt_tokens=sum(len(r.prompt) for r in wave) - hits,
            prefill_width=eng.prefill_tokens - pre_tokens, groups=list(groups),
            shared_peak=shared_peak, peak_blocks=eng.pager.stats().peak_in_use,
            ttft_p50=statistics.median(ttft), ttft_max=ttft[-1], wall_s=wall,
            launches=dict(build.LAUNCHES),
            hits=eng.prefix.hits if eng.prefix is not None else 0)
        log(f"[path prefix] cache {name}: {PREFIX_WAVE} requests after a "
            f"{PREFIX_LEN}-token prime in {wall:.3f} s; prefix hit tokens {hits} "
            f"({r['hits']} hits); prompt tokens prefilled {r['prompt_tokens']}, "
            f"prefill row widths {r['prefill_width']}, dispatches of {groups} rows; "
            f"blocks shared (peak) {shared_peak}; peak blocks in use "
            f"{r['peak_blocks']}; TTFT p50 {r['ttft_p50']:.1f} ms, max "
            f"{r['ttft_max']:.1f} ms; launches {r['launches']}")
        del eng
        torch.cuda.empty_cache()
    off, on, multi = res["off"], res["on"], res["on, multi-row"]
    n_tok = (1 + PREFIX_WAVE) * MAX_NEW
    chain = res["off, float32 chain"]
    log(f"[path prefix] cache off, the bf16 products on the tensor cores against the "
        f"float32 chain (the SIMT route, every product's former arithmetic): "
        f"{sum(a == b for x, y in zip(off['tokens'], chain['tokens']) for a, b in zip(x, y))}"
        f"/{n_tok} tokens equal (reported, not gated)")
    for name in ("on", "on, multi-row"):
        same = sum(a == b for x, y in zip(off["tokens"], res[name]["tokens"])
                   for a, b in zip(x, y))
        log(f"[path prefix] cache {name}: tokens equal to cache off's {same}/{n_tok}")
        check(res[name]["tokens"] == off["tokens"],
              f"prefix cache {name}: tokens differ from cache off's ({same}/{n_tok})")
        check(res[name]["hit_tokens"] == PREFIX_WAVE * PREFIX_LEN,
              f"prefix cache {name}: the wave hits the prime's blocks")
        for k in ("gemm", "gemm_tc"):
            check(res[name]["launches"].get(k, 0) > 0,
                  f"prefix cache {name}: the paged prefill never launched {k}")
    check(max(multi["groups"]) > 1, "prefix cache, multi-row: no multi-row dispatch")
    log(f"[path prefix] every cache-on token equals cache off's ({n_tok} tokens, "
        f"gated), multi-row too (dispatches of {multi['groups']} rows); prefill "
        f"tokens saved {off['prompt_tokens'] - on['prompt_tokens']} of "
        f"{off['prompt_tokens']} (row widths {off['prefill_width']} -> "
        f"{on['prefill_width']}); peak blocks {off['peak_blocks']} -> "
        f"{on['peak_blocks']}; TTFT p50 {off['ttft_p50']:.1f} -> "
        f"{on['ttft_p50']:.1f} ms ({multi['ttft_p50']:.1f} ms multi-row)")
    return res


def long_context_pools(torch, build, cfg, model, formats, cache_on=False,
                       quant_view=None):
    """Engines at max_len LONG_MAX_LEN with SLOTS slots for each pool
    format of ``formats``: kv_pool_bytes, the decode kernel's workspace per
    call and the device memory the engine allocated; then each serves one
    LONG_PROMPT-token request (LONG_PROMPT_FIXED on the cordic_fixed
    softmax; 8 new tokens, greedy) on ``cfg``'s datapath,
    launch counts zeroed just before and read just after, so the decode
    kernel (gqa_decode, or mla_decode on an MLA arch) runs at the long
    shape (M 256 table columns) on every decode step. ``cache_on`` serves
    the request once more with the prefix cache on (float32 pools): its
    TTFT beside the cache-off one (whole rows either way since ROADMAP
    B.10; the block-wide pieces took 15.2-20.3 s) and its tokens gated
    equal. ``quant_view`` (cfg, model), a ``side_view`` of the model,
    serves the quantized formats instead (pool bytes compared a layer):
    a prefill through the invariant product costs ~5.7 s at Yi's 48
    layers, for the time limit. Returns {format: launch counts}."""
    import numpy as np

    from repro_torch.serve.engine import Request, ServeEngine

    base, counts = None, {}
    kernel = "mla_decode" if cfg.mla is not None else "gqa_decode"
    tag = f"{cfg.name} {cfg.act_impl}/{cfg.softmax_impl}"
    n_prompt = LONG_PROMPT_FIXED if cfg.softmax_impl == "cordic_fixed" else LONG_PROMPT
    prompt = np.random.default_rng(5).integers(0, cfg.vocab_size, n_prompt)
    ttft = {}
    for fmt in formats + (("none, cache on",) if cache_on else ()):
        c, m = (quant_view if quant_view and fmt in KV_FORMATS else (cfg, model))
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        eng = ServeEngine(c, m, slots=SLOTS, max_len=LONG_MAX_LEN,
                          kv_impl="paged", block_len=BLOCK_LEN,
                          paged_attend_impl="pallas", kv_quant=fmt.split(",")[0],
                          prefix_cache=fmt.endswith("cache on"), device=DEV)
        torch.cuda.synchronize()
        delta = torch.cuda.memory_allocated() - before
        nbytes = eng.kv_pool_bytes()
        base = base or nbytes / c.num_layers
        check(delta >= nbytes, f"long-context {fmt}: allocated {delta} < pools {nbytes}")
        ws = eng.decode_workspace_bytes()
        log(f"[path memory] {tag} max_len {LONG_MAX_LEN}, {SLOTS} slots, "
            f"{eng.pager.stats().num_blocks} blocks, {c.num_layers} layers, kv_quant={fmt}: "
            f"kv_pool_bytes {nbytes} ({nbytes / 1e9:.3f} GB, "
            f"{base * c.num_layers / nbytes:.3f}x fewer than float32), "
            f"memory_allocated delta {delta} ({delta / 1e9:.3f} GB); "
            f"{kernel} workspace per call {ws} bytes ({ws / 1e9:.3f} GB, "
            f"{ws / nbytes:.3f}x the pools)")
        req = Request(rid=0, prompt=prompt.astype(np.int32), max_new_tokens=8)
        build.reset_launches()
        t0 = time.perf_counter()
        eng.submit(req)
        steps = []
        while eng.has_work:
            ts = time.perf_counter()
            eng.step()
            steps.append(time.perf_counter() - ts)
        torch.cuda.synchronize()
        counts[fmt] = dict(build.LAUNCHES)
        check(req.done and len(req.out) == 8 and all(0 <= t < cfg.vocab_size for t in req.out),
              f"long-context {fmt}: the request finishes with its tokens")
        check(counts[fmt].get(kernel, 0) == c.num_layers * len(steps),
              f"long-context {tag} {fmt}: {kernel} launched "
              f"{counts[fmt].get(kernel, 0)} times, not {c.num_layers} x "
              f"{len(steps)} steps")
        LONG_STEPS[cfg.name, cfg.softmax_impl, fmt] = (
            statistics.median(steps[1:]) * 1e3, list(req.out))
        ttft[fmt] = (req.t_first - req.t_enqueue) * 1e3
        log(f"[path long {tag} {fmt}] one {n_prompt}-token request, 8 new tokens in "
            f"{time.perf_counter() - t0:.3f} s: TTFT {ttft[fmt]:.1f} "
            f"ms; step p50 after the prefill's {statistics.median(steps[1:]) * 1e3:.2f} "
            f"ms over {len(steps) - 1} steps; tokens {req.out}; launches {counts[fmt]}")
        del eng
        torch.cuda.empty_cache()
    if cache_on:
        on, off = (LONG_STEPS[cfg.name, cfg.softmax_impl, f][1] for f in ("none, cache on", "none"))
        check(on == off, f"long-context {tag}: cache-on tokens {on} differ from cache off's {off}")
        log(f"[path long {tag}] TTFT of one {n_prompt}-token request: cache off "
            f"{ttft['none']:.1f} ms, cache on {ttft['none, cache on']:.1f} ms (both whole "
            "rows through the invariant product; tokens equal)")
    return counts


def chunked_trace(cfg):
    """Trace 1: REQUESTS prompts of 17-100 tokens, so chunks of CHUNK span
    most of them and a dispatch packs several rows."""
    import numpy as np

    rng = np.random.default_rng(21)
    return [rng.integers(0, cfg.vocab_size, int(rng.integers(17, 101))).astype(np.int32)
            for _ in range(REQUESTS)]


def serve_trace(torch, build, cfg, model, prompts, what, max_new=MAX_NEW,
                max_len=MAX_LEN, **kw):
    """``prompts`` (greedy, ``max_new`` new tokens each, or one budget a
    prompt) through a fresh engine with the engine knobs ``kw``, launch
    counts zeroed just before and read just after; every request must
    finish with its tokens. Returns (requests, launch counts, stats)."""
    from repro_torch.serve.engine import Request, ServeEngine

    eng = ServeEngine(cfg, model, slots=SLOTS, max_len=max_len, kv_impl="paged",
                      block_len=BLOCK_LEN, paged_attend_impl="pallas", device=DEV, **kw)
    groups = []
    dispatch = eng._dispatch_prefill
    eng._dispatch_prefill = lambda g: (groups.append(len(g)), dispatch(g))
    budgets = max_new if isinstance(max_new, list) else [max_new] * len(prompts)
    reqs = [Request(rid=i, prompt=p, max_new_tokens=n)
            for i, (p, n) in enumerate(zip(prompts, budgets))]
    build.reset_launches()
    t0 = time.perf_counter()
    for r in reqs:
        eng.submit(r)
    steps = 0
    while eng.has_work:
        eng.step()
        steps += 1
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(build.LAUNCHES)
    check(all(r.done and r.error is None and len(r.out) == r.max_new_tokens
              and all(0 <= t < cfg.vocab_size for t in r.out) for r in reqs),
          f"{cfg.name} {what}: every request finishes with its tokens")
    ttft = [(r.t_first - r.t_enqueue) * 1e3 for r in reqs]
    stats = dict(tokens=[r.out for r in reqs], ttft_ms=ttft, wall_s=wall, steps=steps,
                 groups=groups, hits=eng.prefix.hits if eng.prefix is not None else 0)
    log(f"[path chunked {cfg.name}] {what} ({kw}): {len(reqs)} requests, prompts "
        f"{[len(p) for p in prompts]}, {sum(len(r.out) for r in reqs)} tokens in "
        f"{wall:.3f} s over {steps} steps; prefill dispatches of {groups} rows; TTFT "
        f"p50 {statistics.median(ttft):.1f} ms, max {max(ttft):.1f} ms; launches {counts}")
    log(f"[path chunked {cfg.name}] {what} tokens {json.dumps(stats['tokens'])}")
    del eng
    torch.cuda.empty_cache()
    return reqs, counts, stats


def chunked_path(torch, build, cfg, model):
    """Yi-9B's chunked and multi-row prefill and ``score``: trace 1 with and
    without chunks, with the cache off and on; the paged prefill's products
    do not depend on the row count (kernels/gemm.py, ROADMAP B.10), so the
    multi-row chunked runs (CHUNK_BATCH rows a dispatch), cache on or off,
    and the cache-on unchunked run must all emit the single-row unchunked
    run's tokens; trace 2 (the long prompt beside short ones) with the
    chunk and without, the short requests' TTFT read; ``score`` of a
    SCORE_LEN-token prompt through log_softmax_2d. Returns {run: launch
    counts}."""
    import dataclasses

    import numpy as np

    from repro_torch.serve.engine import ServeEngine

    prompts = chunked_trace(cfg)
    chunk = dict(prefill_chunk=CHUNK, prefill_batch=CHUNK_BATCH)
    runs, counts = {}, {}
    for name, kw in (("trace 1", {}), ("trace 1, chunked", chunk),
                     ("trace 1, cache on", dict(prefix_cache=True)),
                     ("trace 1, cache on, chunked", dict(prefix_cache=True, **chunk))):
        _, counts[name], runs[name] = serve_trace(torch, build, cfg, model, prompts, name, **kw)
    n_tok = REQUESTS * MAX_NEW
    base = runs["trace 1"]["tokens"]
    for name in ("trace 1, chunked", "trace 1, cache on", "trace 1, cache on, chunked"):
        same = sum(a == b for x, y in zip(base, runs[name]["tokens"]) for a, b in zip(x, y))
        log(f"[path chunked {cfg.name}] {name}: tokens equal to the single-row unchunked "
            f"run's {same}/{n_tok}")
        check(runs[name]["tokens"] == base,
              f"{name}: tokens differ from the single-row unchunked run's ({same}/{n_tok})")
        if "chunked" in name:
            check(max(runs[name]["groups"]) > 1, f"{name}: no multi-row dispatch")
        for k in ("gemm", "gemm_tc"):
            check(counts[name].get(k, 0) > 0, f"{name}: the paged prefill never launched {k}")
    rng = np.random.default_rng(23)
    long = [rng.integers(0, cfg.vocab_size, LONG_PROMPT).astype(np.int32)]
    shorts = [rng.integers(0, cfg.vocab_size, 8).astype(np.int32) for _ in range(LONG_SHORTS)]
    ttft = {}
    for name, kw in (("trace 2, chunked", dict(prefill_chunk=LONG_CHUNK)), ("trace 2", {})):
        _, counts[name], st = serve_trace(torch, build, cfg, model, long + shorts, name,
                                          max_new=[8] + [MAX_NEW] * LONG_SHORTS,
                                          max_len=LONG_MAX_LEN, **kw)
        ttft[name] = st["ttft_ms"]
    log(f"[path chunked {cfg.name}] trace 2: the {LONG_PROMPT}-token prompt's TTFT "
        f"{ttft['trace 2, chunked'][0]:.1f} ms chunked ({LONG_CHUNK}), "
        f"{ttft['trace 2'][0]:.1f} ms whole; the {LONG_SHORTS} short requests' TTFT "
        f"{[round(t, 1) for t in ttft['trace 2, chunked'][1:]]} ms chunked, "
        f"{[round(t, 1) for t in ttft['trace 2'][1:]]} ms whole (a reading, not a claim)")
    prompt = np.random.default_rng(31).integers(0, cfg.vocab_size, SCORE_LEN).astype(np.int32)
    lps = {}
    for impl in ("exact", "cordic_pallas"):
        eng = ServeEngine(dataclasses.replace(cfg, loss_impl=impl), model, slots=1,
                          max_len=MAX_LEN, kv_impl="paged", block_len=BLOCK_LEN,
                          paged_attend_impl="pallas", device=DEV)
        build.reset_launches()
        t0 = time.perf_counter()
        lps[impl] = eng.score(prompt)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        counts[f"score {impl}"] = dict(build.LAUNCHES)
        del eng
    lp = lps["cordic_pallas"]
    check(lp.shape == (SCORE_LEN - 1,) and bool(np.isfinite(lp).all())
          and float(lp.max()) <= 1e-3, "score: finite log-probs of the prompt's shape")
    check(counts["score cordic_pallas"].get("log_softmax_2d", 0) > 0,
          "score never launched log_softmax_2d")
    log(f"[path score {cfg.name}] {SCORE_LEN}-token prompt: {lp.shape[0]} log-probs over "
        f"{cfg.vocab_size} lanes in {ms:.1f} ms (host clock); mean {float(lp.mean()):.4f}; "
        f"max |cordic_pallas - exact| {float(np.abs(lp - lps['exact']).max()):.3e}; "
        f"launches {counts['score cordic_pallas']}")
    torch.cuda.empty_cache()
    return counts


def drive(torch, eng, reqs):
    """Submit ``reqs`` to ``eng`` and step it until it drains, each step
    timed on the host clock; returns the step times (s) and the wall time."""
    t0 = time.perf_counter()
    for r in reqs:
        eng.submit(r)
    steps = []
    while eng.has_work:
        ts = time.perf_counter()
        eng.step()
        steps.append(time.perf_counter() - ts)
    torch.cuda.synchronize()
    return steps, time.perf_counter() - t0


def dense_serve(torch, build, cfg, model, prompt=None, max_len=MAX_LEN, max_new=8):
    """One dense-plane engine (SLOTS slots, the table-free attend) serving
    the launcher's traffic, or one ``prompt`` of ``max_new`` tokens, launch
    counts zeroed just before and read just after, decode steps and prefill
    dispatches read from its metrics. softmax_2d must launch once a layer
    on every apply: each decode step and each prefill. Returns (requests,
    launch counts, stats)."""
    from repro_torch import obs as obs_lib
    from repro_torch.launch.serve import make_requests
    from repro_torch.serve.engine import Request, ServeEngine

    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    eng = ServeEngine(cfg, model, slots=SLOTS, max_len=max_len, kv_impl="dense",
                      block_len=BLOCK_LEN, device=DEV)
    torch.cuda.synchronize()
    delta = torch.cuda.memory_allocated() - before
    check(delta >= eng.kv_cache_bytes(), f"dense {cfg.name}: allocated {delta} < "
          f"caches {eng.kv_cache_bytes()}")
    if prompt is None:
        for r in make_requests(cfg, 1, 2, seed=99):     # warm-up, outside the counts
            eng.submit(r)
        eng.run()
        reqs = make_requests(cfg, REQUESTS, MAX_NEW, seed=0)
    else:
        reqs = [Request(rid=0, prompt=prompt.astype("int32"), max_new_tokens=max_new)]
    ob = obs_lib.Observability()
    eng.attach_obs(ob)
    build.reset_launches()
    steps, wall = drive(torch, eng, reqs)
    counts = dict(build.LAUNCHES)
    check(all(r.done and r.error is None and len(r.out) == r.max_new_tokens
              and all(0 <= t < cfg.vocab_size for t in r.out) for r in reqs),
          f"dense {cfg.name}: every request finishes with its tokens")
    n_dec = ob.metrics.get("engine.phase.dispatch_ms").count
    n_pre = ob.metrics.get("engine.prefill.dispatches").value
    check(counts.get("softmax_2d", 0) == cfg.num_layers * (n_dec + n_pre),
          f"dense {cfg.name}: softmax_2d launched {counts.get('softmax_2d', 0)} times, "
          f"not {cfg.num_layers} x ({n_dec} decode steps + {n_pre} prefills)")
    for k in ("gqa_decode", "mla_decode"):
        check(counts.get(k, 0) == 0, f"dense {cfg.name}: the paged decode kernel {k} ran")
    ttft = sorted((r.t_first - r.t_enqueue) * 1e3 for r in reqs)
    stats = dict(out={r.rid: r.out for r in reqs}, cache_bytes=eng.kv_cache_bytes(),
                 alloc_delta=delta, decode_steps=n_dec, prefills=n_pre, wall_s=wall,
                 step_ms_p50=statistics.median(steps[1:] if prompt is not None
                                               else steps) * 1e3,
                 ttft_ms_p50=statistics.median(ttft), tokens=sum(len(r.out) for r in reqs))
    del eng
    torch.cuda.empty_cache()
    return reqs, counts, stats


def dense_path(torch, build, cfg, model, ref, long=True):
    """(g) The dense KV plane at full width: the launcher traffic (greedy,
    SLOTS slots, MAX_LEN) with softmax_2d's launches per decode step, its
    tokens set beside the paged run's ``ref`` (a match count); then (Yi)
    one LONG_PROMPT-token request at LONG_MAX_LEN, every decode step's
    softmax_2d at SLOTS x H rows of LONG_MAX_LEN lanes, its step p50
    beside the paged engine's. Returns {run: launch counts}."""
    import numpy as np

    tag = f"[path dense {cfg.name} {cfg.act_impl}/{cfg.softmax_impl}]"
    counts = {}
    reqs, counts["launcher"], st = dense_serve(torch, build, cfg, model)
    same = sum(a == b for rid, toks in ref["out"].items()
               for a, b in zip(toks, st["out"][rid]))
    log(f"{tag} {len(reqs)} requests, {st['tokens']} tokens in {st['wall_s']:.3f} s; "
        f"{st['decode_steps']} decode steps + {st['prefills']} prefills, softmax_2d "
        f"{counts['launcher'].get('softmax_2d', 0)} launches = {cfg.num_layers} a decode "
        f"step and a prefill; step p50 {st['step_ms_p50']:.2f} ms (paged "
        f"{ref['step_ms_p50']:.2f} ms), TTFT p50 {st['ttft_ms_p50']:.1f} ms (paged "
        f"{ref['ttft_ms_p50']:.1f}); caches {st['cache_bytes']} bytes; greedy match "
        f"against the paged decode kernel's tokens {same}/{ref['tokens']} (reported, "
        f"not gated: another attend); launches {counts['launcher']}")
    log(f"{tag} tokens {json.dumps(st['out'])}")
    if not long:
        return counts
    prompt = np.random.default_rng(5).integers(0, cfg.vocab_size, LONG_PROMPT)
    _, counts["long"], lst = dense_serve(torch, build, cfg, model, prompt=prompt,
                                         max_len=LONG_MAX_LEN)
    p50, ptoks = LONG_STEPS[cfg.name, cfg.softmax_impl, "none"]
    log(f"{tag} one {LONG_PROMPT}-token request at max_len {LONG_MAX_LEN}, {SLOTS} "
        f"slots: caches {lst['cache_bytes']} bytes ({lst['cache_bytes'] / 1e9:.3f} GB), "
        f"memory_allocated delta {lst['alloc_delta']}; {lst['decode_steps']} decode "
        f"steps, softmax_2d at {SLOTS * cfg.num_heads} x {LONG_MAX_LEN} a layer: "
        f"{counts['long'].get('softmax_2d', 0)} launches; step p50 after the prefill "
        f"{lst['step_ms_p50']:.2f} ms dense vs {p50:.2f} ms paged (gqa_decode); TTFT "
        f"{lst['ttft_ms_p50']:.1f} ms; tokens {lst['out'][0]} (paged {ptoks})")
    return counts


def sampler_alone(torch):
    """(h) The sampler on fixed logits (4 x 64,000 float32 from a seed,
    keys of (seed 0, rid, step)) on the card and on the CPU: the Gumbel
    noise and the tokens must be equal; timed beside the argmax."""
    from repro_torch.serve import prng
    from repro_torch.serve import sampling as sp

    V = 64000
    gen = torch.Generator().manual_seed(0)
    logits = torch.randn(4, V, generator=gen) * 3
    rids, steps = torch.tensor([0, 1, 2, 3]), torch.tensor([0, 1, 5, 15])
    temps = torch.tensor([0.8, 0.8, 2.5, 0.5])
    top_ks = torch.tensor([40, 0, 8, 40])
    greedy = torch.tensor([False, False, False, True])
    keys = sp.request_key(prng.threefry_seed(0), rids, steps)
    knobs = (keys, temps, top_ks, greedy)
    dl = logits.to(DEV)
    noise = {"cpu": prng.gumbel(keys, (V,)), DEV: prng.gumbel(keys.to(DEV), (V,)).cpu()}
    toks = {"cpu": sp.sample_batched(logits, *knobs),
            DEV: sp.sample_batched(dl, *knobs).cpu()}
    scaled_eq = torch.equal(sp.scale_by_temperature(dl, temps).cpu(),
                            sp.scale_by_temperature(logits, temps))
    check(torch.equal(noise[DEV], noise["cpu"]), "the card's Gumbel noise differs "
          "from the CPU's")
    check(torch.equal(toks[DEV], toks["cpu"]), "the card's sampled tokens differ "
          "from the CPU's")
    t_s = times(torch, lambda: sp.sample_batched(dl, *knobs), iters=10)
    t_g = times(torch, lambda: sp.greedy_tokens(dl))
    log(f"[path sampler] 4 x {V} logits, keys (0, rid {rids.tolist()}, step "
        f"{steps.tolist()}), T {temps.tolist()}, top_k {top_ks.tolist()}, greedy "
        f"{greedy.tolist()}: Gumbel noise and tokens {toks[DEV].tolist()} equal to the "
        f"CPU's (temperature-scaled logits equal: {scaled_eq}); sample_batched device "
        f"{t_s[0]:.4f} ms, host-to-host {t_s[1]:.3f} ms per call; argmax device "
        f"{t_g[0]:.4f} ms, host-to-host {t_g[1]:.4f} ms")
    return t_s, t_g


def sampling_path(torch, build, cfg, model, ref):
    """(h) Yi's launcher prompts on the paged plane with the kernels, even
    rids sampled at MIX, odd rids greedy, served twice with seed 0: the two
    runs' tokens must be equal, and the greedy requests' tokens those of the
    all-greedy run ``ref`` (same batch shapes, so those rows' logits are the
    same). Returns the launch counts."""
    from repro_torch.launch.serve import make_requests
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.sampling import SamplingParams

    t_s, t_g = sampler_alone(torch)
    runs = []
    for _ in range(2):
        eng = ServeEngine(cfg, model, slots=SLOTS, max_len=MAX_LEN, kv_impl="paged",
                          block_len=BLOCK_LEN, paged_attend_impl="pallas", seed=0,
                          device=DEV)
        for r in make_requests(cfg, 1, 2, seed=99):
            eng.submit(r)
        eng.run()
        reqs = make_requests(cfg, REQUESTS, MAX_NEW, seed=0)
        for r in reqs[::2]:
            r.sampling = SamplingParams(*MIX)
        build.reset_launches()
        steps, wall = drive(torch, eng, reqs)
        runs.append(({r.rid: r.out for r in reqs}, statistics.median(steps) * 1e3,
                     dict(build.LAUNCHES)))
        del eng
    out, p50, counts = runs[0]
    check(runs[1][0] == out, "sampled serving with seed 0 did not repeat its tokens")
    for rid in range(1, REQUESTS, 2):
        check(out[rid] == ref["out"][rid], f"greedy request {rid} in the sampling mix "
              "differs from the all-greedy run")
    differ = sum(out[rid] != ref["out"][rid] for rid in range(0, REQUESTS, 2))
    log(f"[path sampling {cfg.name}] launcher prompts, even rids T={MIX[0]} "
        f"top_k={MIX[1]}, odd greedy, paged + kernels, twice with seed 0: tokens repeat; "
        f"the {REQUESTS // 2} greedy requests equal the all-greedy run's; {differ} of "
        f"{REQUESTS // 2} sampled requests differ from their greedy tokens; step p50 "
        f"{p50:.2f} / {runs[1][1]:.2f} ms vs {ref['step_ms_p50']:.2f} ms all-greedy "
        f"(sampler alone {t_s[1]:.3f} ms host-to-host a call); launches {counts}")
    log(f"[path sampling {cfg.name}] tokens {json.dumps(out)}")
    torch.cuda.empty_cache()
    return counts


def obs_path(torch, build, cfg, model, ref):
    """(i) Yi's launcher traffic on the paged plane with the kernels, with
    Observability(trace=True) attached after the warm-up and the serve
    inside observe_saturation: its tokens must equal the obs-off run
    ``ref``; writes OUT/metrics.json and OUT/trace.json (held to
    validate_chrome_trace) and logs TTFT, TPOT, the step and each phase's
    p50. Returns the launch counts."""
    from repro_torch import obs as obs_lib
    from repro_torch.launch.serve import make_requests
    from repro_torch.serve.engine import ServeEngine

    eng = ServeEngine(cfg, model, slots=SLOTS, max_len=MAX_LEN, kv_impl="paged",
                      block_len=BLOCK_LEN, paged_attend_impl="pallas", device=DEV)
    for r in make_requests(cfg, 1, 2, seed=99):
        eng.submit(r)
    eng.run()
    ob = obs_lib.Observability(trace=True)
    eng.attach_obs(ob)
    reqs = make_requests(cfg, REQUESTS, MAX_NEW, seed=0)
    build.reset_launches()
    with obs_lib.observe_saturation(ob.metrics):
        drive(torch, eng, reqs)
    counts = dict(build.LAUNCHES)
    check({r.rid: r.out for r in reqs} == ref["out"],
          "tokens with observability on differ from the run with it off")
    m = ob.metrics
    m.to_json(str(OUT / "metrics.json"))
    ob.trace.export(str(OUT / "trace.json"))
    obs_lib.validate_chrome_trace(json.loads((OUT / "trace.json").read_text()))
    def q(name, p):
        return m.get(name).quantile(p)

    phases = {n.split(".")[2][:-3]: q(n, 0.5) for n in m.names()
              if n.startswith("engine.phase.")}
    log(f"[path obs {cfg.name}] tokens equal the obs-off run's; "
        f"{len(ob.trace.events)} trace events, {len(m.names())} metrics "
        f"(chiprun_out/metrics.json, trace.json: validate_chrome_trace passes); "
        f"launches {counts}")
    log(f"[obs] TTFT p50 {q('engine.ttft_ms', 0.5):.2f} ms, p99 "
        f"{q('engine.ttft_ms', 0.99):.2f} ms; TPOT p50 {q('engine.tpot_ms', 0.5):.3f} ms")
    log(f"[obs] engine.step_ms p50 {q('engine.step_ms', 0.5):.3f} ms over "
        f"{m.get('engine.step_ms').count} steps; phase p50 (ms) "
        + ", ".join(f"{k} {v:.3f} (n {m.get(f'engine.phase.{k}_ms').count})"
                    for k, v in sorted(phases.items())))
    log(f"[obs] saturation: " + json.dumps({n: m.get(n).value for n in m.names()
                                          if n.startswith("fixed_point.")}))
    del eng
    torch.cuda.empty_cache()
    return counts


def profile_steps(torch, eng, cfg, kernels, n_steps: int = PROFILE_STEPS):
    """Device busy share and kernel time by name over a few engine steps
    (4 fresh requests: their prefills, then decode steps), from
    torch.profiler's CUDA activity. Outside the launch counts."""
    from repro_torch.launch.serve import make_requests

    for r in make_requests(cfg, SLOTS, n_steps + 2, seed=7):
        eng.submit(r)
    eng.step()                                 # prefills + a first decode
    torch.cuda.synchronize()

    def steps():
        for _ in range(n_steps):
            eng.step()

    out = profile_window(torch, steps, n_steps, f"{cfg.name} decode steps",
                         kernels)
    eng.run()
    return out


def profile_window(torch, run, n_steps, what, kernels):
    """Wall time of ``run`` (``n_steps`` steps, ended by a synchronize) under
    torch.profiler, the device's busy time in it (the summed durations of
    its kernels) and the kernels by time; logs them. None when the
    profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile

    # device activity alone: the host ops' events are not read here, and
    # booking them took ~1.8 s more a window of 12,000 launches on an H100
    # machine's host
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for ev in prof.key_averages():
        if "CUDA" not in str(getattr(ev, "device_type", "")):
            continue                           # host ops: their kernels count below
        dev_us = getattr(ev, "self_device_time_total", 0.0)
        if dev_us > 0:
            by_name[ev.key] = by_name.get(ev.key, 0.0) + dev_us / 1e3
    busy = sum(by_name.values())
    if busy == 0:
        log("[profile] the profiler saw no device time: busy share not measured")
        return None
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    log(f"[profile] {n_steps} {what}: wall {wall_ms:.1f} ms, device busy "
        f"{busy:.1f} ms ({100 * busy / wall_ms:.1f}%), idle "
        f"{100 * (1 - busy / wall_ms):.1f}%")
    for name, ms in top:
        log(f"[profile]   {ms / n_steps:8.3f} ms/step  {name[:90]}")
    for kern in kernels:
        ms = sum(v for k, v in by_name.items() if kern in k)
        log(f"[profile]   {kern}: {ms / n_steps:.4f} ms/step")
    return {"wall_ms": wall_ms, "busy_ms": busy, "idle": 1 - busy / wall_ms,
            "top": top}


# ---------------------------------------------------------------------------
# Phase 4j-4k: the recurrent pair and the attention archs of the recurrent
# slice
# ---------------------------------------------------------------------------
#: the recurrent pair, served on the dense plane at full width and depth
RECURRENT_ARCHS = ("xlstm-1.3b", "zamba2-1.2b")
#: the attention archs at full width, with the depth one card holds, cut
#: further for the time limit (None: full depth). Weights in bf16, the
#: lm_head in float32: qwen2.5-32b 67.1 GB and deepseek-coder-33b 67.2 GB
#: whole; phi3.5-moe's 32 layers are 84 GB of experts alone and
#: command-r-plus's 64 layers 201 GB
ATTENTION_ARCHS = {"qwen2.5-32b": 16, "deepseek-coder-33b": 16,
                   "phi3.5-moe-42b-a6.6b": 16, "command-r-plus-104b": 8,
                   # the embeds archs, served on token ids as the
                   # launcher serves them
                   "musicgen-large": 16, "internvl2-1b": None}
#: the weight bytes one card holds beside the serves' pools and workspaces
CARD_WEIGHT_BYTES = 75e9
#: gqa_decode's record of each arch whose decode shape is a new group width
#: (held against plain in group_check)
GROUP_RECORDS = {"qwen2.5-32b": "G5", "musicgen-large": "G1", "internvl2-1b": "G7"}
#: the recurrent pair's cordic_fixed serve, cut to fit the time limit
#: (plain Q2.14 SiLUs: ~850 host operations a call, ~0.8 s a decode step)
FIXED_REQUESTS, FIXED_MAX_NEW = 4, 8
#: decode after an 8-token prefill against the 9-token prefill's last
#: position: the reference's own bounds (tests/test_models.py)
STATE_ATOL = {"mlstm": 2e-3, "mamba2": 2e-4}
#: the logits check: the kernel route against the plain versions on the
#: card, the bar tests/test_torch_models.py holds the port to against JAX
LOGITS_ATOL = 1e-3


class PlainRoute:
    """Inside it, the row kernels' wrappers (act_2d, silu_mul_2d,
    softmax_2d) run their plain PyTorch versions on card tensors, so a
    forward computes the plain-version logits of the same model; no launch
    is counted."""

    def __enter__(self):
        from repro_torch.kernels import cordic_act as K
        from repro_torch.kernels import softmax_cordic as SM

        self.saved = (K.act_2d, K.silu_mul_2d, SM.softmax_2d)
        K.act_2d = lambda x, op, **kw: K.act_2d_plain(x, op, **kw)
        K.silu_mul_2d = lambda g, u, **kw: K.silu_mul_2d_plain(g, u, **kw)
        SM.softmax_2d = lambda x, **kw: SM.softmax_2d_plain(x, **kw)
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import cordic_act as K
        from repro_torch.kernels import softmax_cordic as SM

        K.act_2d, K.silu_mul_2d, SM.softmax_2d = self.saved
        return False


def launcher_serve(torch, build, cfg, model, n_req=REQUESTS, max_new=MAX_NEW,
                   warm=True, **engine_kw):
    """The launcher's traffic (``n_req`` greedy requests of ``max_new``
    tokens, SLOTS slots, MAX_LEN) through one engine built with
    ``engine_kw``, after a warm-up request outside the counts; launch
    counts zeroed just before and read just after, decode steps and
    prefill dispatches from its metrics. Returns (requests, launch counts,
    stats, engine)."""
    from repro_torch import obs as obs_lib
    from repro_torch.launch.serve import make_requests
    from repro_torch.serve.engine import ServeEngine

    eng = ServeEngine(cfg, model, slots=SLOTS, max_len=MAX_LEN, block_len=BLOCK_LEN,
                      device=DEV, **engine_kw)
    if warm:
        for r in make_requests(cfg, 1, 2, seed=99):
            eng.submit(r)
        eng.run()
    reqs = make_requests(cfg, n_req, max_new, seed=0)
    ob = obs_lib.Observability()
    eng.attach_obs(ob)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    steps, wall = drive(torch, eng, reqs)
    counts = dict(build.LAUNCHES)
    check(all(r.done and r.error is None and len(r.out) == max_new
              and all(0 <= t < cfg.vocab_size for t in r.out) for r in reqs),
          f"{cfg.name} {engine_kw}: every request finishes with its tokens")
    ttft = sorted((r.t_first - r.t_enqueue) * 1e3 for r in reqs)
    n_tok = sum(len(r.out) for r in reqs)
    stats = dict(out={r.rid: r.out for r in reqs}, tokens=n_tok, wall_s=wall,
                 tok_s=n_tok / wall, step_ms_p50=statistics.median(steps) * 1e3,
                 ttft_ms_p50=statistics.median(ttft), ttft_ms_max=ttft[-1],
                 decode_steps=ob.metrics.get("engine.phase.dispatch_ms").count,
                 prefills=int(ob.metrics.get("engine.prefill.dispatches").value),
                 prefill_tokens=int(ob.metrics.get("engine.prefill.tokens").value),
                 cache_bytes=eng.kv_cache_bytes(),
                 peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    return reqs, counts, stats, eng


def serve_line(tag, st, counts) -> str:
    return (f"{tag} {len(st['out'])} requests, {st['tokens']} tokens in "
            f"{st['wall_s']:.3f} s: {st['tok_s']:.1f} tok/s; step p50 "
            f"{st['step_ms_p50']:.2f} ms ({st['decode_steps']} decode steps, "
            f"{st['prefills']} prefills of {st['prefill_tokens']} tokens); TTFT p50 "
            f"{st['ttft_ms_p50']:.1f} ms, max {st['ttft_ms_max']:.1f} ms; KV bytes "
            f"{st['cache_bytes']}; peak memory {st['peak_gib']:.2f} GiB; launches {counts}")


def match_count(a, b) -> int:
    return sum(x == y for rid, toks in a.items() for x, y in zip(toks, b[rid]))


def manual_tokens(torch, cfg, model, prompt, n_tok):
    """A manual exact-length prefill of ``prompt`` in a fresh one-row dense
    cache (``make_prefill_step``), then greedy decode steps, each row of a
    SLOTS-row copy of that cache fed the same token: every row is the
    request alone, and the card's products see the engine's row counts
    (cuBLAS picks its GEMM by the row count, ROADMAP F6). Returns row 0's
    tokens; every row must agree."""
    from repro_torch.models import transformer as tf
    from repro_torch.serve.engine import make_prefill_step

    one = tf.init_cache(cfg, 1, MAX_LEN, device=DEV)
    with torch.inference_mode():
        logits = make_prefill_step(cfg)(model, one, torch.as_tensor(
            prompt[None], device=DEV).long())
        out = [int(logits[0].argmax())]
        cache = tf.stack_caches([one] * SLOTS)
        for _ in range(n_tok - 1):
            tok = torch.full((SLOTS, 1), out[-1], dtype=torch.long, device=DEV)
            nxt = tf.apply(model, {"tokens": tok}, cfg, cache)[0][:, -1].argmax(-1)
            check(bool((nxt == nxt[0]).all()), f"{cfg.name}: the copies of one "
                  "request decoded apart")
            out.append(int(nxt[0]))
    return out


def state_continuation(torch, cfg):
    """(3) An mLSTM or Mamba2 block at full width in float32 (random weights
    from a seed, the reference's exact activations): the decode step after
    an 8-token prefill against the 9-token prefill's last position, within
    the reference's atol. Returns {kind: max |error|}."""
    import dataclasses

    from repro_torch.models import ssm as ssmm
    from repro_torch.models import xlstm as xlm

    kinds = {"mlstm": (xlm.MLSTM, xlm.mlstm_apply, xlm.mlstm_init_cache),
             "mamba2": (ssmm.Mamba2, ssmm.mamba2_apply, ssmm.mamba2_init_cache)}
    cfg = dataclasses.replace(cfg, act_impl="exact")
    out = {}
    for kind in set(cfg.block_pattern) & set(kinds):
        module, apply, init = kinds[kind]
        gen = torch.Generator(device=DEV).manual_seed(3)
        with torch.inference_mode():
            blk = module(cfg, dtype=torch.float32, device=torch.device(DEV), gen=gen)
            x = 0.5 * torch.randn(2, 9, cfg.d_model, generator=gen, device=DEV)
            full = apply(blk, x, cfg)
            cache = init(cfg, 2, device=DEV)
            apply(blk, x[:, :8], cfg, cache)
            dec = apply(blk, x[:, 8:9], cfg, cache)
        err = float((dec[:, 0] - full[:, 8]).abs().max())
        log(f"[path recurrent {cfg.name}] {kind} block, float32, d_model {cfg.d_model}: "
            f"decode after an 8-token prefill vs the 9-token prefill's last position: "
            f"max |diff| {err:.3e} (reference atol {STATE_ATOL[kind]}); state bytes a "
            f"row {sum(v[0].numel() * 4 for v in cache.values())}")
        check(err <= STATE_ATOL[kind], f"{cfg.name} {kind}: decode after prefill "
              f"off by {err} (atol {STATE_ATOL[kind]})")
        out[kind] = err
        del blk, cache
    return out


def slstm_host_ops(torch, build, cfg, model):
    """The sLSTM time loop's cost on the host: PyTorch operations
    dispatched (a TorchDispatchMode count, kernel wrappers' own included)
    and kernel launches for one sLSTM block on 2 and on 1 positions of one
    row; the difference is one token's step of the loop. Returns (ops,
    launches) per token and layer."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.models import xlstm as xlm

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    blk = next(b for b, k in zip(model.blocks, cfg.block_pattern) if k == "slstm")
    out = {}
    for S in (1, 2):
        x = torch.zeros(1, S, cfg.d_model, dtype=torch.bfloat16, device=DEV)
        with torch.inference_mode(), Count():
            Count.n = 0
            build.reset_launches()
            xlm.slstm_apply(blk.mixer, x, cfg)
            out[S] = (Count.n, sum(build.LAUNCHES.values()))
    return out[2][0] - out[1][0], out[2][1] - out[1][1]


def recurrent_path(torch, build, arch):
    """(j) A recurrent arch at full width and depth, random weights from
    seed 0, on the dense plane (the only plane it has) with the kernels
    (act_impl and softmax_impl cordic_pallas): (1) the kernel route's
    logits of a launcher prompt against the plain versions' on the same
    model, (2) the launcher traffic, whose greedy tokens must equal each
    request's manual exact-length prefill and decode loop, with a short
    profile; then the model's first SIDE_LAYERS blocks on cordic_fixed
    (FIXED_REQUESTS x FIXED_MAX_NEW); (3) decode after prefill of the arch's mLSTM / Mamba2
    block. Returns {run: launch counts}."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.launch.serve import make_requests
    from repro_torch.models import transformer as tf

    base = configs.get_config(arch, act_impl="cordic_pallas")
    cfg = dataclasses.replace(base, softmax_impl="cordic_pallas")
    tag = f"[path recurrent {arch}]"
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    model = tf.init(cfg, seed=0, device=DEV)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    kinds = {k: cfg.block_pattern.count(k) for k in sorted(set(cfg.block_pattern))}
    log(f"{tag} {cfg.num_layers} layers {kinds}"
        + (f" + {tf.num_shared_apps(cfg)} applications of one shared "
           f"{cfg.shared_block} block" if cfg.shared_block else "")
        + f", d_model {cfg.d_model}, {cfg.num_heads} heads, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab_size}, {cfg.dtype}; {len(tf.segments(cfg))} segments; "
        f"{n_params / 1e9:.3f}B params (spec {cfg.param_counts()['total'] / 1e9:.3f}B: "
        f"the JAX spec's projections, whatever the arch's name), weights "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB, init "
        f"{time.perf_counter() - t0:.1f} s; nothing cut")
    counts = {}
    # (1) the logits check
    t0 = time.perf_counter()
    prompt = make_requests(cfg, 1, 1, seed=0)[0].prompt
    toks = torch.as_tensor(prompt[None], device=DEV).long()
    with torch.inference_mode():
        build.reset_launches()
        kern = tf.apply(model, {"tokens": toks}, cfg)[0]
        fwd_counts = dict(build.LAUNCHES)
        with PlainRoute():
            build.reset_launches()
            plain = tf.apply(model, {"tokens": toks}, cfg)[0]
            check(not build.LAUNCHES, f"{tag} the plain route launched {dict(build.LAUNCHES)}")
    err = float((kern - plain).abs().max())
    log(f"{tag} logits check, a {len(prompt)}-token prompt: max |kernel route - plain "
        f"versions| {err:.3e} (bound {LOGITS_ATOL}; bit-equal {torch.equal(kern, plain)}), "
        f"argmax equal {torch.equal(kern.argmax(-1), plain.argmax(-1))}; the forward's "
        f"launches {fwd_counts} ({time.perf_counter() - t0:.1f} s)")
    check(bool(torch.isfinite(kern).all()) and err <= LOGITS_ATOL,
          f"{tag} kernel-route logits off the plain versions' by {err}")
    check(fwd_counts.get("act_2d", 0) > 0, f"{tag} the forward never launched act_2d")
    # (2) the launcher traffic on the kernels, against the manual loop
    t0 = time.perf_counter()
    reqs, counts["cordic_pallas"], st, eng = launcher_serve(
        torch, build, cfg, model, kv_impl="dense")
    c = counts["cordic_pallas"]
    log(serve_line(f"{tag} cordic_pallas/cordic_pallas dense:", st, c))
    log(f"{tag} tokens {json.dumps(st['out'])}")
    check(not eng._bucketed and st["prefill_tokens"] == sum(len(r.prompt) for r in reqs),
          f"{tag} prefill not at exact length: {st['prefill_tokens']} tokens")
    check(c.get("act_2d", 0) > 0, f"{tag} serving never launched act_2d")
    for k in ("gqa_decode", "mla_decode"):
        check(c.get(k, 0) == 0, f"{tag} the paged decode kernel {k} ran")
    n_apps = tf.num_shared_apps(cfg)
    check(c.get("softmax_2d", 0) == n_apps * (st["decode_steps"] + st["prefills"]),
          f"{tag} softmax_2d launched {c.get('softmax_2d', 0)} times, not {n_apps} "
          f"shared applications x ({st['decode_steps']} decode steps + "
          f"{st['prefills']} prefills)")
    check((c.get("silu_mul_2d", 0) > 0) == bool(n_apps),
          f"{tag} silu_mul_2d launched {c.get('silu_mul_2d', 0)} times")
    log(f"[time] {tag} traffic: {time.perf_counter() - t0:.1f} s")
    if "slstm" in cfg.block_pattern:
        n_ops, n_launch = slstm_host_ops(torch, build, cfg, model)
        n_sl = cfg.block_pattern.count("slstm")
        log(f"{tag} the sLSTM time loop: {n_ops} host operations ({n_launch} kernel "
            f"launches) a token and layer, {n_ops * n_sl} a prefill token over its "
            f"{n_sl} sLSTM layers")
        st["slstm_ops_per_token_layer"] = n_ops
    t0 = time.perf_counter()
    same = 0
    for r in reqs:
        want = manual_tokens(torch, cfg, model, r.prompt, len(r.out))
        same += sum(a == b for a, b in zip(r.out, want))
        check(r.out == want, f"{tag} request {r.rid}: engine {r.out} vs manual "
              f"exact-length prefill and decode {want}")
    log(f"{tag} engine tokens == each request's manual exact-length prefill and "
        f"decode loop: {same}/{st['tokens']} ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    prof = profile_steps(torch, eng, cfg, ("act_kernel", "silu_mul_kernel",
                                           "softmax_kernel", "nvjet"), PROFILE_STEPS)
    log(f"[time] {tag} profile: {time.perf_counter() - t0:.1f} s")
    del eng
    torch.cuda.empty_cache()
    # the paper-faithful datapath on the model's first blocks: no row kernel
    t0 = time.perf_counter()
    fcfg, fmodel, cut = side_view(
        dataclasses.replace(cfg, act_impl="cordic_fixed", softmax_impl="cordic_fixed"),
        model)
    _, counts["cordic_fixed"], fst, eng = launcher_serve(
        torch, build, fcfg, fmodel, FIXED_REQUESTS, FIXED_MAX_NEW, warm=False,
        kv_impl="dense")
    log(serve_line(f"{tag} cordic_fixed/cordic_fixed dense ({FIXED_REQUESTS} requests x "
                   f"{FIXED_MAX_NEW} tokens, {cut}):", fst, counts["cordic_fixed"]))
    log(f"{tag} cordic_fixed tokens {json.dumps(fst['out'])}")
    for k in ("act_2d", "silu_mul_2d", "softmax_2d"):
        check(counts["cordic_fixed"].get(k, 0) == 0, f"{tag} cordic_fixed launched {k}")
    log(f"[time] {tag} cordic_fixed: {time.perf_counter() - t0:.1f} s")
    del eng, model, fmodel
    torch.cuda.empty_cache()
    state_continuation(torch, cfg)
    RESULTS[arch] = dict(st, out=None, profile=prof, fixed_tok_s=fst["tok_s"],
                         fixed_step_ms_p50=fst["step_ms_p50"])
    return counts


#: per-arch summaries of phase 4j-4k, logged at the end
RESULTS = {}


def archs_paths(torch, build, card, records, ops):
    """(j), (k) and (l): the recurrent pair, then the attention archs, each
    checked for the kernels its path must launch, then log_softmax_2d at
    each trained vocabulary and the train path of every block kind. Returns
    ({arch: {datapath: launch counts}}, {arch: launch counts}, {arch: launch
    counts of its train steps})."""
    rec = {}
    for arch in RECURRENT_ARCHS:
        rec[arch] = recurrent_path(torch, build, arch)
        phase_done(f"path recurrent {arch}")
    att = attention_archs_path(torch, build, card, records, ops)
    phase_done("path attention archs")
    vocab_log_softmax(torch, card, records, ops)
    phase_done("kernels log_softmax_2d at the trained vocabularies")
    train = train_archs_path(torch, build)
    phase_done("path train archs")
    return rec, att, train


def group_check(torch, card, records, cfg, ops, name):
    """gqa_decode at an arch's decode shape on the launcher's ragged tables
    (B 4, L 16, M 8; qwen2.5-32b: KH 8, G 5, hd 128; musicgen-large: KH 32,
    G 1, hd 64; internvl2-1b: KH 2, G 7, hd 64: group widths and head dims
    no earlier record had), against its plain version: bit-equal on the
    kernels' datapath. Recorded as ``gqa_decode[<name>]``."""
    from repro_torch.kernels import paged_attention as PA

    dev = torch.device(DEV)
    gen = torch.Generator(device=dev).manual_seed(5)
    B, KH, L, M = SLOTS, cfg.num_kv_heads, BLOCK_LEN, MAX_LEN // BLOCK_LEN
    G, hd = cfg.num_heads // KH, cfg.head_dim
    klens = [37, 0, MAX_LEN, 5]
    N = 1 + B * M
    q = torch.randn(B, KH, G, hd, generator=gen, device=dev).bfloat16()
    kp = torch.randn(N, L, KH, hd, generator=gen, device=dev)
    vp = torch.randn(N, L, KH, hd, generator=gen, device=dev)
    tables = torch.zeros(B, M, dtype=torch.int32, device=dev)
    nxt = 1
    for r, k in enumerate(klens):
        for c in range(-(-k // L)):
            tables[r, c] = nxt
            nxt += 1
    k_len = torch.tensor([max(k, 1) for k in klens], dtype=torch.int32, device=dev)
    kw = dict(scale=1.0 / math.sqrt(hd), kv_dtype=torch.bfloat16,
              softmax_impl="cordic_pallas")
    a = PA.gqa_decode(q, kp, vp, tables, k_len, **kw)
    b, plain_t = plain_call(torch, lambda: PA.gqa_decode_plain(q, kp, vp, tables, k_len, **kw))
    err = float((a - b).abs().max())
    check(bool(torch.isfinite(a).all()) and err == 0.0,
          f"gqa_decode G={G}: |kernel - plain| {err} (bit-equal)")
    live_blocks = sum(-(-max(k, 1) // L) for k in klens)
    lanes = sum(max(k, 1) for k in klens) * KH * G
    nbytes = (q.numel() * 2 + 2 * live_blocks * L * KH * hd * 4 + tables.numel() * 4
              + k_len.numel() * 4 + a.numel() * 4)
    bound, by = card.bound(nbytes, ops["decode_lane"] * lanes, 4 * hd * lanes)
    rec = timed(dict(shape=[B, KH, G, hd, L, M], impl="cordic_pallas", klens=klens,
                     max_abs_err=err, bit_equal=True, bound_ms=bound, bound_by=by),
                kernel=times(torch, lambda: PA.gqa_decode(q, kp, vp, tables, k_len, **kw),
                             "gqa_decode_kernel"),
                plain=plain_t)
    log(f"[gqa_decode] {cfg.name} B={B} KH={KH} G={G} hd={hd} L={L} M={M}: max "
        f"|kernel - plain| {err:.3e} (bit-equal); {fmt_times(rec)}")
    records[f"gqa_decode[{name}]"] = rec


def attention_archs_path(torch, build, card, records, ops):
    """(k) The attention archs of the slice at full width (depth cut where
    one card cannot hold the weights: ATTENTION_ARCHS), random weights from
    seed 0, the kernels' datapath: the launcher traffic on the paged plane
    with the decode kernel (gqa_decode a layer every decode step), with the
    table gather and on the dense plane; kernel tokens set beside the
    gather's and the dense plane's (match counts, reported). Qwen's group
    of 5 held against plain first. Returns {arch: launch counts of the
    kernel run}."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.models import transformer as tf

    out = {}
    for arch, layers in ATTENTION_ARCHS.items():
        t_arch = time.perf_counter()
        full = configs.get_config(arch, act_impl="cordic_pallas")
        # the launcher's switch: the embeds archs serve on token ids
        cfg = dataclasses.replace(full, softmax_impl="cordic_pallas", input_mode="tokens")
        cut = "nothing cut"
        if layers:
            cfg = dataclasses.replace(cfg, num_layers=layers,
                                      block_pattern=cfg.block_pattern[:layers])
            n_full = full.param_counts()["total"]
            why = (f"{n_full / 1e9:.1f}B params do not fit one card"
                   if 2 * n_full > CARD_WEIGHT_BYTES else "for the time limit")
            cut = f"depth cut {full.num_layers} -> {layers} layers ({why})"
        tag = f"[path attention {arch}]"
        if arch in GROUP_RECORDS:
            group_check(torch, card, records, cfg, ops, GROUP_RECORDS[arch])
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        model = tf.init(cfg, seed=0, device=DEV)
        torch.cuda.synchronize()
        n_params = sum(p.numel() for p in model.parameters())
        moe = (f", {cfg.moe.num_experts} experts x {cfg.moe.d_ff_expert} top-"
               f"{cfg.moe.top_k}" if cfg.moe else f", {cfg.mlp_kind} MLP")
        log(f"{tag} {cfg.num_layers} layers {sorted(set(cfg.block_pattern))}, d_model "
            f"{cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads (group "
            f"{cfg.num_heads // cfg.num_kv_heads}), d_ff {cfg.d_ff}{moe}, vocab "
            f"{cfg.vocab_size}, qkv_bias {cfg.qkv_bias}, {cfg.dtype}; {n_params / 1e9:.2f}B "
            f"params, weights {torch.cuda.memory_allocated() / 2**30:.2f} GiB, init "
            f"{time.perf_counter() - t0:.1f} s; {cut}")
        runs = {}
        for name, kw in (("paged kernel", dict(kv_impl="paged", paged_attend_impl="pallas")),
                         ("paged gather", dict(kv_impl="paged", paged_attend_impl="gather")),
                         ("dense", dict(kv_impl="dense"))):
            _, c, st, eng = launcher_serve(torch, build, cfg, model, **kw)
            del eng
            torch.cuda.empty_cache()
            runs[name] = (c, st)
            log(serve_line(f"{tag} {name}:", st, c))
        c, st = runs["paged kernel"]
        check(c.get("gqa_decode", 0) == cfg.num_layers * st["decode_steps"],
              f"{tag} gqa_decode launched {c.get('gqa_decode', 0)} times, not "
              f"{cfg.num_layers} x {st['decode_steps']} decode steps")
        check(c.get("softmax_2d", 0) > 0, f"{tag} the prefill never launched softmax_2d")
        # the MoE's SiLU (F2) and the GELU MLP's tanh run act_2d, the SwiGLU
        # silu_mul_2d
        ffn_kernel = "silu_mul_2d" if cfg.moe is None and cfg.mlp_kind == "swiglu" else "act_2d"
        check(c.get(ffn_kernel, 0) > 0, f"{tag} the FFN never launched {ffn_kernel}")
        log(f"{tag} tokens (paged kernel) {json.dumps(st['out'])}")
        for name in ("paged gather", "dense"):
            log(f"{tag} greedy match, paged kernel against {name}: "
                f"{match_count(st['out'], runs[name][1]['out'])}/{st['tokens']} "
                "(reported, not gated: the card's products differ by attend path)")
        out[arch] = c
        RESULTS[arch] = dict(st, out=None, cut=cut)
        del model
        torch.cuda.empty_cache()
        log(f"[time] {tag}: {time.perf_counter() - t_arch:.1f} s")
    return out


# ---------------------------------------------------------------------------
# Phase 4c: the train path
# ---------------------------------------------------------------------------
def train_cfg(configs):
    """Yi-9B widths (configs/yi_9b.py:full), depth cut to TRAIN_LAYERS
    (block_pattern=() lets the config rebuild its pattern), every datapath
    on the CORDIC kernels."""
    import dataclasses

    return dataclasses.replace(
        configs.get_config("yi-9b", act_impl="cordic_pallas"),
        num_layers=TRAIN_LAYERS, block_pattern=(),
        softmax_impl="cordic_pallas", loss_impl="cordic_pallas")


def train_path(torch, build):
    """Training at Yi-9B width through the loop a user runs
    (train/loop.py): 8 steps of the synthetic pipeline with AdamW and
    async checkpoints every 4 steps; the latest checkpoint restored into a
    fresh state, bit-equal; 6 steps on one fixed batch, the loss falling;
    one eval step; 3 steps under the profiler."""
    import shutil
    import tempfile

    from repro_torch import configs
    from repro_torch.checkpoint import manager as ckpt
    from repro_torch.data.pipeline import DataConfig, SyntheticLMDataset
    from repro_torch.optim import adamw
    from repro_torch.train import loop as loop_lib
    from repro_torch.train import step as step_lib

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = train_cfg(configs)
    n_params = cfg.param_counts()["total"]
    log(f"[path train] {cfg.name} x{cfg.num_layers} layers: d_model "
        f"{cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab_size}, compute {cfg.dtype}, float32 "
        f"master weights; {n_params / 1e9:.3f}B params; batch {TRAIN_BATCH} x "
        f"{TRAIN_SEQ} tokens; act/softmax/loss impl {cfg.act_impl}/"
        f"{cfg.softmax_impl}/{cfg.loss_impl}")
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        # (1) the loop: 8 steps, checkpoints at 4 and 8
        lc = loop_lib.LoopConfig(total_steps=8, ckpt_every=4, ckpt_dir=ckpt_dir,
                                 log_every=1, seed=0)
        build.reset_launches()
        t0 = time.perf_counter()
        out = loop_lib.run(cfg, lc, log=log, device=DEV)
        torch.cuda.synchronize()
        loop_s = time.perf_counter() - t0
        loop_counts = dict(build.LAUNCHES)
        hist = out["history"]
        check(len(hist) == 8 and all(math.isfinite(h["loss"]) and
                                     math.isfinite(h["grad_norm"]) for h in hist),
              "8 loop steps with finite losses and grad norms")
        per_step = {k: v / len(hist) for k, v in loop_counts.items()}
        log(f"[path train] loop: 8 steps in {loop_s:.1f} s (checkpoints "
            f"included); losses {[round(h['loss'], 4) for h in hist]}; grad "
            f"norms {[round(h['grad_norm'], 4) for h in hist]}; launches "
            f"{loop_counts} ({per_step} per step)")
        for k in ("act_2d", "softmax_2d", "log_softmax_2d"):
            check(loop_counts.get(k, 0) > 0, f"a train step never launched {k}")
        check(loop_counts.get("silu_mul_2d", 0) == 0,
              "silu_mul_2d launched under grad (the JAX rule's primal is "
              "u * (g * s) from act_2d)")

        # (2) restore the latest checkpoint into a fresh state: bit-equal
        state = out.pop("state")
        last = ckpt.latest_step(ckpt_dir)
        check(last == 8, f"latest checkpoint is step 8 (got {last})")
        t0 = time.perf_counter()
        fresh = step_lib.init_state(cfg, 1, adamw.AdamWConfig(), device=DEV)
        fresh, found = loop_lib.restore_latest(lc, fresh)
        restore_s = time.perf_counter() - t0
        same = all(torch.equal(a, b) for a, b in
                   zip(state.params.parameters(), fresh.params.parameters()))
        same_opt = (int(fresh.opt.step) == int(state.opt.step) == 8 and all(
            torch.equal(state.opt.mu[k], fresh.opt.mu[k])
            and torch.equal(state.opt.nu[k], fresh.opt.nu[k]) for k in state.opt.mu))
        log(f"[path train] restored step {found[0]} into a fresh state in "
            f"{restore_s:.1f} s: params bit-equal {same}, moments and step "
            f"bit-equal {same_opt}")
        check(same and same_opt, "checkpoint round trip is not bit-equal")
        del state, out
        shutil.rmtree(ckpt_dir, ignore_errors=True)
        torch.cuda.empty_cache()

        # (3) 6 steps on batch_at(0) from the restored state: the loss falls
        ds = SyntheticLMDataset(DataConfig(vocab_size=cfg.vocab_size,
                                           seq_len=TRAIN_SEQ,
                                           global_batch=TRAIN_BATCH, seed=0))
        batch = loop_lib.to_device(ds.batch_at(0), DEV)
        train_step = step_lib.make_train_step(
            cfg, adamw.AdamWConfig(lr=DESCENT_LR), warmup_steps=0)
        log(f"[path train] peak memory of the loop and the restore (two "
            f"states): {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        torch.cuda.reset_peak_memory_stats()     # one state from here on
        build.reset_launches()
        losses, dts = [], []
        for _ in range(DESCENT_STEPS):
            t0 = time.perf_counter()
            fresh, m = train_step(fresh, batch)
            losses.append(m["loss"].item())
            dts.append(time.perf_counter() - t0)
            check(math.isfinite(losses[-1]) and math.isfinite(float(m["grad_norm"])),
                  "finite loss and grad norm")
        step_counts = dict(build.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        log(f"[path train] {DESCENT_STEPS} steps on batch_at(0), lr "
            f"{DESCENT_LR} (warmup 0, total 10000: scale ~1): losses "
            f"{[round(x, 4) for x in losses]}; launches {step_counts}")
        check(losses[-1] < losses[0], "the loss does not fall on a fixed batch")
        check(step_counts.get("silu_mul_2d", 0) == 0, "silu_mul_2d under grad")

        # (4) one eval step: no grad, so the fused SwiGLU kernel runs
        build.reset_launches()
        em = step_lib.make_eval_step(cfg)(fresh.params, batch)
        eval_loss = em["loss"].item()
        eval_counts = dict(build.LAUNCHES)
        log(f"[path train] eval step: loss {eval_loss:.4f}; launches {eval_counts}")
        check(math.isfinite(eval_loss), "finite eval loss")
        for k in ("silu_mul_2d", "softmax_2d", "log_softmax_2d"):
            check(eval_counts.get(k, 0) > 0, f"the eval step never launched {k}")

        # (5) device idle share over 3 steps
        def three():
            nonlocal fresh
            for _ in range(3):
                fresh, m = train_step(fresh, batch)
                m["loss"].item()

        prof = profile_window(torch, three, 3, "train steps",
                              ("act_kernel", "softmax_kernel",
                               "log_softmax_cluster_kernel", "gemm"))
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    p50 = statistics.median(dts)
    stats = dict(step_ms_p50=p50 * 1e3, tok_s=TRAIN_BATCH * TRAIN_SEQ / p50,
                 peak_gib=peak / 2**30, loop_s=loop_s, restore_s=restore_s,
                 idle=prof["idle"] if prof else None)
    idle = "not measured" if prof is None else f"{100 * prof['idle']:.1f}%"
    log(f"[path train] step p50 {stats['step_ms_p50']:.2f} ms (host clock, "
        f"ending in loss.item()) over {DESCENT_STEPS} steps: "
        f"{stats['tok_s']:.0f} tokens/s; peak memory {stats['peak_gib']:.2f} "
        f"GiB; device idle {idle} over 3 steps")
    log(f"[path train] clocks/power after training: "
        f"{smi('clocks.sm,power.draw,power.limit,temperature.gpu')}")
    del fresh, batch
    torch.cuda.empty_cache()
    return loop_counts, stats


# ---------------------------------------------------------------------------
# Phase 4l: the train path of every block kind
# ---------------------------------------------------------------------------
#: each arch at full width, depth cut to what one card holds beside float32
#: master weights, AdamW's moments, the error-feedback buffers and a second
#: set of gradients (the remat comparison): layers kept. deepseek: 1
#: mla_dense + 2 mla_moe; xlstm: 7 mLSTM + 1 sLSTM; zamba2: 12 Mamba2 layers,
#: the shared block applied twice
TRAIN_ARCHS = {"deepseek-v2-lite-16b": 3, "phi3.5-moe-42b-a6.6b": 2,
               "xlstm-1.3b": 8, "zamba2-1.2b": 12, "musicgen-large": 4,
               "internvl2-1b": 4}
#: their vocabularies: log_softmax_2d's widths on the loss
TRAIN_VOCABS = {"deepseek-v2-lite-16b": 102400, "phi3.5-moe-42b-a6.6b": 32064,
                "xlstm-1.3b": 50304, "zamba2-1.2b": 32000, "musicgen-large": 2048,
                "internvl2-1b": 151655}
#: steps on one batch, the loss falling; steps under the profiler
TRAIN_ARCH_STEPS, TRAIN_PROFILE_STEPS = 4, 3


def vocab_log_softmax(torch, card, records, ops):
    """log_softmax_2d at each trained arch's vocabulary (TRAIN_VOCABS): the
    loss's (B*S, V) = (256, V) float32 logits, a masked tail on some rows,
    against its plain version, bit-equal, timed beside torch.log_softmax.
    151,655 lanes (internvl2-1b) is the first odd width on a main path: the
    scalar route, not the 16-byte one."""
    from repro_torch.kernels import softmax_cordic as SM

    dev = torch.device(DEV)
    gen = torch.Generator(device=dev).manual_seed(4)
    rows = TRAIN_BATCH * TRAIN_SEQ
    for V in sorted(set(TRAIN_VOCABS.values())):
        z = torch.randn(rows, V, generator=gen, device=dev) * 3
        z[:8, V - V // 64:] = -1e30
        a = SM.log_softmax_2d(z)
        b, plain_t = plain_call(torch, lambda: SM.log_softmax_2d_plain(z))
        err = float((a - b).abs().max())
        check(torch.equal(a, b) and math.isfinite(err),
              f"log_softmax_2d at {V} lanes differs from its plain version")
        live = int((z - z.amax(-1, keepdim=True) >= -20.0).sum())
        bound, by = card.bound(8 * z.numel(), ops["log_softmax_lane_tab"] * live
                               + ops["log_row"] * rows, 3 * z.numel())
        rec = timed(dict(shape=[rows, V], dtype="float32", max_abs_err=err,
                         bound_ms=bound, bound_by=by),
                    kernel=times(torch, lambda: SM.log_softmax_2d(z), "log_softmax_"),
                    plain=plain_t,
                    library=times(torch, lambda: torch.log_softmax(z, dim=-1)))
        records[f"log_softmax_2d[V{V}]"] = rec
        log(f"[log_softmax_2d] {[rows, V]}: bit-exact; plan {SM.log_softmax_plan(V)}; "
            f"{fmt_times(rec)}")
        del z, a, b


def train_arch_cfg(configs, arch):
    """(full config, the trained one): TRAIN_ARCHS[arch] layers, float32
    master weights over the config's compute dtype, every datapath on the
    CORDIC kernels, token inputs (the launcher's switch for the embeds
    archs)."""
    import dataclasses

    full = configs.get_config(arch, act_impl="cordic_pallas")
    n = min(TRAIN_ARCHS[arch], full.num_layers)
    return full, dataclasses.replace(
        full, num_layers=n, block_pattern=full.block_pattern[:n], input_mode="tokens",
        softmax_impl="cordic_pallas", loss_impl="cordic_pallas")


def train_archs_path(torch, build):
    """(l) Each arch of TRAIN_ARCHS trained at full width (train_arch).
    Returns {arch: launch counts of its TRAIN_ARCH_STEPS steps}."""
    out = {}
    for arch in TRAIN_ARCHS:
        t0 = time.perf_counter()
        out[arch] = train_arch(torch, build, arch)
        log(f"[time] [path train {arch}]: {time.perf_counter() - t0:.1f} s")
    return out


def train_arch(torch, build, arch):
    """One arch through the train step a user runs (train/step.py), random
    weights from seed 0, on batch_at(0) of the loop's pipeline (8 x 32
    tokens): (1) the gradients of the initial weights under remat "full"
    and "dots", bit-equal to "none" (deterministic algorithms on), each
    forward kernel launched twice under "full" (once where the shared block
    runs: it is not wrapped, as in JAX); (2) TRAIN_ARCH_STEPS steps, the
    loss falling, every gradient norm finite, the launches checked: act_2d
    and log_softmax_2d always, softmax_2d where the arch has attention,
    silu_mul_2d never (F1); (3) an eval step; (4) one step with int8
    error-feedback compression; (5) TRAIN_PROFILE_STEPS steps under the
    profiler: the device's idle share. Step p50 (host clock, ending in
    loss.item()) and peak memory of (2)."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.data.pipeline import DataConfig, SyntheticLMDataset
    from repro_torch.distributed import compression as comp
    from repro_torch.models import transformer as tf
    from repro_torch.optim import adamw
    from repro_torch.train import loop as loop_lib
    from repro_torch.train import step as step_lib

    full, cfg = train_arch_cfg(configs, arch)
    tag = f"[path train {arch}]"
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    opt = adamw.AdamWConfig(lr=DESCENT_LR)
    state = step_lib.init_state(cfg, 0, opt, device=DEV)
    n_params = sum(p.numel() for p in state.params.parameters())
    kinds = {k: cfg.block_pattern.count(k) for k in sorted(set(cfg.block_pattern))}
    log(f"{tag} {cfg.num_layers} of {full.num_layers} layers {kinds}"
        + (f" + {tf.num_shared_apps(cfg)} applications of the shared block"
           if cfg.shared_block else "")
        + f", d_model {cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads, vocab "
        f"{cfg.vocab_size}, compute {cfg.dtype}, float32 master weights: "
        f"{n_params / 1e9:.3f}B params; batch {TRAIN_BATCH} x {TRAIN_SEQ} tokens")
    batch = loop_lib.to_device(SyntheticLMDataset(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
        seed=0)).batch_at(0), DEV)
    attends = bool(set(cfg.block_pattern) & set(tf.ATTENTION_KINDS)) or cfg.shared_block

    # (1) remat: the same gradients, the forward kernels launched twice
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        build.reset_launches()
        _, _, g_none = step_lib.grads_of(state.params, batch, cfg)
        torch.cuda.synchronize()
        base = dict(build.LAUNCHES)
        for mode in ("full", "dots"):
            build.reset_launches()
            _, _, g = step_lib.grads_of(state.params, batch,
                                        dataclasses.replace(cfg, remat=mode))
            torch.cuda.synchronize()
            counts = dict(build.LAUNCHES)
            same = [k for k in g_none if not torch.equal(g[k], g_none[k])]
            log(f"{tag} remat={mode}: gradients bit-equal to remat=none on "
                f"{len(g_none) - len(same)} of {len(g_none)} leaves; launches {counts} "
                f"(none: {base})")
            check(not same, f"{tag} remat={mode} gradients differ from none: {same[:5]}")
            # each block's forward kernels run again in the backward; the
            # shared block's (unwrapped) once
            for k in ("act_2d", "softmax_2d"):
                n0, n1 = base.get(k, 0), counts.get(k, 0)
                check(n1 == 2 * n0 if cfg.shared_block is None else n0 <= n1 <= 2 * n0,
                      f"{tag} remat={mode}: {k} launched {n1} times against {n0}")
            check(counts["act_2d"] > base["act_2d"], f"{tag} remat={mode}: no recompute")
            check(counts.get("log_softmax_2d", 0) == base.get("log_softmax_2d", 0),
                  f"{tag} remat={mode}: the loss is outside the blocks")
            del g
        del g_none
    finally:
        torch.use_deterministic_algorithms(False)

    # (2) steps on one batch: the loss falls
    train_step = step_lib.make_train_step(cfg, opt, warmup_steps=0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    losses, gns, dts = [], [], []
    for _ in range(TRAIN_ARCH_STEPS):
        t0 = time.perf_counter()
        state, m = train_step(state, batch)
        losses.append(m["loss"].item())
        dts.append(time.perf_counter() - t0)
        gns.append(float(m["grad_norm"]))
    counts = dict(build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    log(f"{tag} {TRAIN_ARCH_STEPS} steps on batch_at(0), lr {DESCENT_LR} (warmup 0): "
        f"losses {[round(x, 5) for x in losses]}; grad norms "
        f"{[round(x, 4) for x in gns]}; launches {counts}")
    check(all(math.isfinite(x) for x in losses + gns), f"{tag} finite losses and grad norms")
    check(losses[-1] < losses[0], f"{tag} the loss does not fall on a fixed batch")
    must = ["act_2d", "log_softmax_2d"] + (["softmax_2d"] if attends else [])
    for k in must:
        check(counts.get(k, 0) > 0, f"{tag} a train step never launched {k}")
    check(counts.get("silu_mul_2d", 0) == 0,
          f"{tag} silu_mul_2d launched under grad (F1: the JAX rule's primal)")

    # (3) one eval step
    build.reset_launches()
    em = step_lib.make_eval_step(cfg)(state.params, batch)
    eval_loss = em["loss"].item()
    eval_counts = dict(build.LAUNCHES)
    check(math.isfinite(eval_loss), f"{tag} finite eval loss")
    log(f"{tag} eval step: loss {eval_loss:.5f}; launches {eval_counts}")

    # (4) one step with int8 error-feedback compression
    state = state._replace(err=comp.init_error_state(step_lib.named_params(state.params)))
    cstep = step_lib.make_train_step(cfg, opt, warmup_steps=0, compress=True)
    state, m = cstep(state, batch)
    closs = m["loss"].item()
    err_abs = max(float(e.abs().max()) for e in state.err.values())
    log(f"{tag} compressed step: loss {closs:.5f}, grad norm {float(m['grad_norm']):.4f}, "
        f"largest error-feedback entry {err_abs:.3e}; peak memory with the buffers "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    check(math.isfinite(closs) and math.isfinite(err_abs) and err_abs > 0,
          f"{tag} the compressed step")
    state = state._replace(err=None)
    torch.cuda.empty_cache()

    # (5) the device's idle share over a few steps
    def steps():
        nonlocal state
        for _ in range(TRAIN_PROFILE_STEPS):
            state, mm = train_step(state, batch)
            mm["loss"].item()

    prof = profile_window(torch, steps, TRAIN_PROFILE_STEPS, f"{arch} train steps",
                          ("act_kernel", "softmax_kernel", "log_softmax_", "nvjet", "gemm"))
    p50 = statistics.median(dts)
    RESULTS[f"train {arch}"] = dict(
        layers=cfg.num_layers, params=n_params, step_ms_p50=p50 * 1e3,
        tok_s=TRAIN_BATCH * TRAIN_SEQ / p50, peak_gib=peak / 2**30,
        idle=prof["idle"] if prof else None, losses=losses, launches=counts)
    idle = "not measured" if prof is None else f"{100 * prof['idle']:.1f}%"
    log(f"{tag} step p50 {p50 * 1e3:.2f} ms over {TRAIN_ARCH_STEPS} steps "
        f"({TRAIN_BATCH * TRAIN_SEQ / p50:.0f} tokens/s); peak memory "
        f"{peak / 2**30:.2f} GiB; device idle {idle} over {TRAIN_PROFILE_STEPS} steps")
    del state, batch
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# Phase 5: identity on the smoke config
# ---------------------------------------------------------------------------
def identity_phase(torch, arch, impl, kv_quant="none", prefix_cache=False):
    """A smoke config in float32 served on the card (kernels) and on the CPU
    (plain versions), 3 requests x 8 tokens (with the prefix cache: 4
    requests after a shared two-block prompt, so that later ones hit);
    the tokens must be equal. On quantized pools the card also serves
    with the gather attend, whose tokens must equal the kernel's."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.launch.serve import make_requests
    from repro_torch.models import transformer as tf
    from repro_torch.serve.engine import ServeEngine

    cfg = dataclasses.replace(configs.get_smoke(arch, act_impl=impl),
                              softmax_impl=impl)
    cpu_model = tf.init(cfg, seed=0, device="cpu")
    gpu_model = tf.Transformer(cfg, device=torch.device(DEV))
    gpu_model.load_state_dict(cpu_model.state_dict())
    n, prefix_len = (4, 32) if prefix_cache else (3, 0)
    runs = [("cpu", cpu_model, "pallas"), (DEV, gpu_model, "pallas")]
    if kv_quant != "none":
        runs.append((DEV, gpu_model, "gather"))
    out, hits = {}, {}
    for dev, model, attend in runs:
        eng = ServeEngine(cfg, model, slots=2, max_len=64, kv_impl="paged",
                          paged_attend_impl=attend, kv_quant=kv_quant,
                          prefix_cache=prefix_cache, device=dev)
        for r in make_requests(cfg, n, 8, seed=0, prefix_len=prefix_len):
            eng.submit(r)
        out[dev, attend] = {r.rid: r.out for r in eng.run()}
        hits[dev, attend] = eng.prefix.hits if prefix_cache else 0
    what = (f"{cfg.name} float32 {impl}" + (f" kv_quant={kv_quant}" if kv_quant != "none"
                                            else "")
            + (f" prefix cache ({hits[DEV, 'pallas']} hits)" if prefix_cache else ""))
    log(f"[identity] {what}, {n} requests x 8 tokens: card (kernels) "
        f"{out[DEV, 'pallas']} vs CPU (plain) {out['cpu', 'pallas']}")
    check(out[DEV, "pallas"] == out["cpu", "pallas"],
          f"{what}: card tokens differ from the CPU run")
    check(not prefix_cache or hits[DEV, "pallas"] > 0, f"{what}: no prefix hit")
    if kv_quant != "none":
        log(f"[identity] {what}: card gather attend {out[DEV, 'gather']}")
        check(out[DEV, "gather"] == out[DEV, "pallas"],
              f"{what}: the kernel's tokens differ from the gather attend's")


def chunked_identity_phase(torch, arch):
    """A smoke config in float32 with chunked, multi-row prefill (chunks of
    16, two rows a dispatch, prompts of 5-40 tokens): the card's tokens
    equal the CPU's with the same knobs; on Yi also ``score`` of a 24-token
    prompt through log_softmax_2d, within tests/test_torch_models.py's
    logit bound (1e-3) of the CPU's plain version."""
    import dataclasses

    import numpy as np

    from repro_torch import configs
    from repro_torch.models import transformer as tf
    from repro_torch.serve.engine import Request, ServeEngine

    cfg = dataclasses.replace(configs.get_smoke(arch, act_impl="cordic_pallas"),
                              softmax_impl="cordic_pallas", loss_impl="cordic_pallas")
    cpu_model = tf.init(cfg, seed=0, device="cpu")
    gpu_model = tf.Transformer(cfg, device=torch.device(DEV))
    gpu_model.load_state_dict(cpu_model.state_dict())
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in (5, 40, 17, 33)]
    score_prompt = rng.integers(0, cfg.vocab_size, 24).astype(np.int32)
    out, scores = {}, {}
    for dev, model in (("cpu", cpu_model), (DEV, gpu_model)):
        eng = ServeEngine(cfg, model, slots=2, max_len=64, kv_impl="paged",
                          paged_attend_impl="pallas", prefill_chunk=16, device=dev)
        for i, p in enumerate(prompts):
            eng.submit(Request(rid=i, prompt=p, max_new_tokens=8))
        out[dev] = {r.rid: r.out for r in eng.run()}
        scores[dev] = eng.score(score_prompt)
    log(f"[identity] {cfg.name} float32 chunked (16, 2 rows a dispatch), prompts "
        f"{[len(p) for p in prompts]} x 8 tokens: card (kernels) {out[DEV]} vs CPU "
        f"(plain) {out['cpu']}")
    check(out[DEV] == out["cpu"], f"{cfg.name} chunked: card tokens differ from the CPU run")
    err = float(np.abs(scores[DEV] - scores["cpu"]).max())
    log(f"[identity] {cfg.name} score of a 24-token prompt (log_softmax_2d): max |card - "
        f"CPU| {err:.3e}")
    check(err <= 1e-3, f"{cfg.name} score: card log-probs differ from the CPU's")


def dense_identity_phase(torch, arch):
    """A smoke config in float32 on the dense plane, 4 requests x 8 tokens
    through 2 slots, all greedy and then with the sampling mix (even rids
    at MIX): the card's tokens with the kernels equal the CPU's with the
    plain versions."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.launch.serve import make_requests
    from repro_torch.models import transformer as tf
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.sampling import SamplingParams

    cfg = dataclasses.replace(configs.get_smoke(arch, act_impl="cordic_pallas"),
                              softmax_impl="cordic_pallas")
    cpu_model = tf.init(cfg, seed=0, device="cpu")
    gpu_model = tf.Transformer(cfg, device=torch.device(DEV))
    gpu_model.load_state_dict(cpu_model.state_dict())
    for mix in (False, True):
        out = {}
        for dev, model in (("cpu", cpu_model), (DEV, gpu_model)):
            eng = ServeEngine(cfg, model, slots=2, max_len=64, kv_impl="dense",
                              device=dev)
            reqs = make_requests(cfg, 4, 8, seed=0)
            for r in reqs[::2] if mix else ():
                r.sampling = SamplingParams(*MIX)
            for r in reqs:
                eng.submit(r)
            eng.run()
            out[dev] = {r.rid: r.out for r in reqs}
        what = f"{cfg.name} float32 dense" + (f", even rids sampled at {MIX}" if mix else "")
        log(f"[identity] {what}, 4 requests x 8 tokens: card (kernels) {out[DEV]} vs "
            f"CPU (plain) {out['cpu']}")
        check(out[DEV] == out["cpu"], f"{what}: card tokens differ from the CPU run")


#: train identity tolerance, card against CPU. The kernels equal the plain
#: versions bit for bit, so only the matmuls' summation order differs; on
#: an H100 (torch 2.11, CUDA 12.8) the losses agreed to 7.6e-8 at step 0
#: (one float32 ulp) and 1.6e-6 after. The bounds are about ten times
#: that. The recipe can amplify an ulp: JAX against itself with its
#: weights nudged one ulp spreads by up to 9e-5 (tests/test_torch_train.py)
TRAIN_ID_RTOL = (1e-6, 2e-5)          # step 0, later steps
#: later steps' bound of the archs whose recipe spreads wider: the
#: port on the CPU against itself with every weight nudged one float32 ulp
#: (logged beside each arch's check as the recipe's own spread) moved the
#: smoke losses by up to 3.1e-4 (deepseek-v2-lite: the nudge moves its MoE
#: routing), 9.9e-5 (xlstm) and 7.9e-6 (zamba2) at steps 2-4, where the
#: card moved deepseek's by 4.1e-4 (an H100, torch 2.11); about five times the
#: spread. Step 0 keeps TRAIN_ID_RTOL[0] on every arch
TRAIN_ID_LATER = {"deepseek-v2-lite-16b": 2e-3, "xlstm-1.3b": 5e-4,
                  "zamba2-1.2b": 5e-5}


#: the train identity's smoke configs: the dense model, then one
#: of each other block kind: MLA with MoE, GQA with MoE, both recurrent
TRAIN_ID_ARCHS = ("yi-9b", "deepseek-v2-lite-16b", "phi3.5-moe-42b-a6.6b",
                  "xlstm-1.3b", "zamba2-1.2b")


def train_identity_phase(torch, archs=TRAIN_ID_ARCHS):
    """Each arch's smoke config in float32, 5 steps (lr 1e-2, warmup 2,
    total 5, batch_at(0)) from the same weights: on the card with the
    kernels and on the CPU with the plain versions; and on the CPU from
    the weights nudged one ulp, whose spread is logged beside the check."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.data.pipeline import DataConfig, SyntheticLMDataset
    from repro_torch.models import transformer as tf
    from repro_torch.optim import adamw
    from repro_torch.train import loop as loop_lib
    from repro_torch.train import step as step_lib

    for arch in archs:
        cfg = dataclasses.replace(configs.get_smoke(arch, act_impl="cordic_pallas"),
                                  softmax_impl="cordic_pallas", loss_impl="cordic_pallas")
        batch = SyntheticLMDataset(DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                              global_batch=8, seed=0)).batch_at(0)
        init = tf.init(cfg, 0, "cpu", dtype=torch.float32).state_dict()
        # the recipe's own spread: the CPU run from weights one ulp up
        nudged = {k: torch.nextafter(v, torch.full_like(v, math.inf))
                  for k, v in init.items()}
        losses = {}
        for dev, weights in (("cpu", init), (DEV, init), ("nudged", nudged)):
            params = tf.Transformer(cfg, device=torch.device(
                "cpu" if dev == "nudged" else dev), dtype=torch.float32)
            params.load_state_dict(weights)
            state = step_lib.TrainState(
                params, adamw.init(step_lib.named_params(params)), None)
            train_step = step_lib.make_train_step(
                cfg, adamw.AdamWConfig(lr=1e-2), warmup_steps=2, total_steps=5)
            b = loop_lib.to_device(batch, params.embed.device)
            losses[dev] = []
            for _ in range(5):
                state, m = train_step(state, b)
                losses[dev].append(m["loss"].item())
        rel = [abs(a - c) / abs(c) for a, c in zip(losses[DEV], losses["cpu"])]
        spread = [abs(a - c) / abs(c) for a, c in zip(losses["nudged"], losses["cpu"])]
        later = TRAIN_ID_LATER.get(arch, TRAIN_ID_RTOL[1])
        log(f"[identity] {cfg.name} float32 train, 5 steps: card (kernels) "
            f"{losses[DEV]} vs CPU (plain) {losses['cpu']}; relative differences "
            f"{[f'{r:.2e}' for r in rel]} (tolerance {TRAIN_ID_RTOL[0]} at step 0, "
            f"{later} after; the CPU from weights one ulp up: "
            f"{[f'{r:.2e}' for r in spread]})")
        check(rel[0] <= TRAIN_ID_RTOL[0] and max(rel[1:]) <= later,
              f"{cfg.name}: card train losses differ from the CPU run")


# ---------------------------------------------------------------------------
# Phase 4 (m): tensor parallelism, every rank on the one card
# ---------------------------------------------------------------------------
#: the tensor-parallel runs: (run, tp), a run an arch or an arch with
#: " seq" (kv_shard="seq_model" on the dense plane). DeepSeek-V2-Lite's
#: heads cut serves at full depth against the serve path's run of the same
#: traffic, model and engine knobs; every other run is cut to SIDE_LAYERS
#: blocks (the recurrent pair's on the dense plane) and its tp 1 reference
#: is the same model served in this process
SEQ = " seq"
#: a run computing in float32 (the flagged C.7 run, ``--c7``)
F32 = " f32"
C7_RUNS = (("xlstm-1.3b" + F32, 2), ("zamba2-1.2b" + F32, 2))


def run_arch(run: str) -> str:
    """The arch of a tp run's name (without " seq" / " f32")."""
    return run.removesuffix(SEQ).removesuffix(F32)

TP_RUNS = (("yi-9b", 2), ("yi-9b", 4), (DEEPSEEK, 2),
           ("xlstm-1.3b", 2), ("xlstm-1.3b", 4), ("zamba2-1.2b", 2),
           ("yi-9b" + SEQ, 2), (DEEPSEEK + SEQ, 2))
#: the kernels each run's ranks must launch
TP_KERNELS = {"yi-9b": ("gqa_decode", "silu_mul_2d", "softmax_2d"),
              DEEPSEEK: ("mla_decode", "act_2d", "silu_mul_2d", "softmax_2d"),
              "xlstm-1.3b": ("act_2d",),
              "zamba2-1.2b": ("act_2d", "silu_mul_2d", "softmax_2d"),
              "yi-9b" + SEQ: ("silu_mul_2d",) + SPLIT_LAUNCHES,
              DEEPSEEK + SEQ: ("act_2d", "silu_mul_2d") + SPLIT_LAUNCHES}
#: positions of the probe's dense cache under kv_shard="seq_model"
PROBE_LEN = 128


#: the sublayer probe's bound: max |tp n - tp 1| over max |tp 1| of each
#: sublayer's output (set from a sound run: see PERF.md); a rank that skips
#: its reduction must land above it
TP_PROBE_TOL = 2 ** -5


def tp_cfg(run, smoke=False):
    """The config every tp run of ``run`` serves (``smoke``: the smoke one,
    Yi's one KV head padded to 4 so that it divides tp, the xLSTM's 2 heads
    made 4). Every run but DeepSeek-V2-Lite's heads cut is cut to its
    SIDE_LAYERS blocks (xLSTM: 7 mLSTMs and the sLSTM at index 7; Zamba2:
    two shared-block applications); a " seq" run sets
    kv_shard="seq_model", a " f32" run computes in float32 (``--c7``)."""
    import dataclasses

    from repro_torch import configs

    arch, seq = run_arch(run), run.endswith(SEQ)
    get = configs.get_smoke if smoke else configs.get_config
    cfg = dataclasses.replace(get(arch, act_impl="cordic_pallas"),
                              softmax_impl="cordic_pallas",
                              kv_shard="seq_model" if seq else "auto")
    if run.endswith(F32):
        cfg = dataclasses.replace(cfg, dtype="float32")
    if smoke and arch == "xlstm-1.3b":
        cfg = dataclasses.replace(cfg, num_heads=4, num_kv_heads=4)
    elif smoke and cfg.mla is None and arch in ("yi-9b",):
        cfg = dataclasses.replace(cfg, pad_heads_to=4)
    if run != DEEPSEEK and not smoke:
        n = SIDE_LAYERS[arch]
        cfg = dataclasses.replace(cfg, num_layers=n, block_pattern=cfg.block_pattern[:n])
    return cfg


def tp_probe(model, cfg, mesh, dev, reduce=True):
    """Sublayers on one seeded input, without a cache: {name: float32
    output on the host}. Attention archs: the attention, then the MLP or
    MoE, of blocks 0 and 1. Recurrent archs: the first block's mixer of
    each kind (the mLSTM and the sLSTM, or Mamba2), and the shared block's
    attention and MLP. Every sublayer gets the same input at every tp, so
    the MoE's routing is the same and only the partial sums' rounding may
    differ. ``reduce=False``: the rank's reductions skipped (each output
    its partial sum), the error the probe's bound must catch. Under
    kv_shard="seq_model" on a mesh the attention runs through a fresh
    dense cache of PROBE_LEN positions (the rank's span of them), as a
    prefill from position 0: the position cut is a cache's."""
    import torch

    from repro_torch.distributed import sharding as shd
    from repro_torch.models import attention as attn
    from repro_torch.models import common as cm
    from repro_torch.models import mlp as mlpm
    from repro_torch.models import moe as moem
    from repro_torch.models import transformer as tf

    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn(2, 12, cfg.d_model, generator=g, device=dev).to(cm.dtype_of(cfg.dtype))
    apply_attn = attn.mla_apply if cfg.mla is not None else attn.gqa_apply

    def cache(i):
        if not shd.seq_cut(cfg, mesh):
            return None
        return tf.init_cache(cfg, x.shape[0], PROBE_LEN, device=dev, mesh=mesh,
                             kv_heads=shd.local_kv_heads(cfg, mesh)).layers[i]

    out, red = {}, shd.all_reduce_
    if not reduce:
        shd.all_reduce_ = lambda t, mesh=None: t
    try:
        with torch.no_grad(), shd.serving_mesh(mesh):
            if cfg.block_pattern[0] in ("mlstm", "slstm", "mamba2"):
                for kind in dict.fromkeys(cfg.block_pattern):
                    i = cfg.block_pattern.index(kind)
                    blk = model.blocks[i]
                    out[f"block {i} {kind}"] = blk._apply(
                        blk.mixer, cm.rmsnorm(blk.ln, x, cfg.norm_eps), cfg, None)
                blocks = [("shared", model.shared)] if model.shared is not None else []
            else:
                blocks = list(enumerate(model.blocks[:2]))
            for i, blk in blocks:
                out[f"block {i} attention"] = apply_attn(
                    blk.attn, cm.rmsnorm(blk.ln1, x, cfg.norm_eps), cfg,
                    cache=cache(i) if isinstance(i, int) else None)
                h = cm.rmsnorm(blk.ln2, x, cfg.norm_eps)
                if blk.is_moe:
                    out[f"block {i} moe"] = moem.moe_apply(blk.ffn, h, cfg)[0]
                else:
                    ffn = getattr(blk, "ffn", None) or blk.mlp
                    out[f"block {i} mlp"] = mlpm.swiglu_apply(ffn, h, cfg)
    finally:
        shd.all_reduce_ = red
    return {k: v.float().cpu() for k, v in out.items()}


def tp_probe_ref(arch, smoke=False):
    """``tp_probe`` at tp 1 on an attention arch cut to its first two
    blocks: the weights are drawn leaf by leaf from one generator,
    embedding first, so blocks 0 and 1 are the full model's (and a
    SIDE_LAYERS cut's: the reference of the arch's every run)."""
    import dataclasses

    import torch

    from repro_torch.models import transformer as tf

    cfg = tp_cfg(arch, smoke)
    cfg = dataclasses.replace(cfg, num_layers=2, block_pattern=cfg.block_pattern[:2])
    model = tf.init(cfg, seed=0, device=DEV)
    out = tp_probe(model, cfg, None, DEV)
    del model
    if DEV == "cuda":
        torch.cuda.empty_cache()
    return out


def tp_rank(job):
    """One rank of ``tp_path`` (a ``run_ranks`` target; spawned ranks import
    it from this script), or, for a list of jobs, each in turn: the arch at
    full width on this rank's mesh, its shard of the seed-0 weights built
    leaf by leaf, the launcher traffic (REQUESTS greedy requests, SLOTS
    slots, MAX_LEN; an attention arch on the paged plane with BLOCK_LEN and
    the decode kernel, a recurrent one on the dense plane) after a warm-up
    request, launch counts and the mesh's collective counts zeroed just
    before. On the paged plane the first decode step's decode kernel call
    is kept and held against its plain version on the same head slice after
    the run. A " seq" run (kv_shard="seq_model", dense plane) keeps each
    split softmax launch's first call instead, held against its plain
    version, and the first probabilities against whole-row softmax_2d on
    the ranks' gathered scores. Then ``tp_probe`` on the rank's shard, with
    its reductions and without."""
    if isinstance(job, list):
        return [tp_rank(j) for j in job]
    import torch

    from repro_torch import obs as obs_lib
    from repro_torch.distributed import sharding as shd
    from repro_torch.kernels import build
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.kernels import softmax_cordic as SM
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch.serve import make_requests
    from repro_torch.models import transformer as tf
    from repro_torch.serve.engine import ServeEngine

    dev = job.get("device", "cuda")
    cuda = dev == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = tp_cfg(job["arch"], job.get("smoke", False))
    mesh = mesh_lib.mesh_or_none(job["tp"])
    seq = shd.seq_cut(cfg, mesh)
    paged = tf.attention_only(cfg) and cfg.kv_shard == "auto"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = tf.init(cfg, seed=0, device=dev, mesh=mesh)
    if cuda:
        torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    plane = (dict(kv_impl="paged", block_len=BLOCK_LEN, paged_attend_impl="pallas")
             if paged else dict(kv_impl="dense"))
    eng = ServeEngine(cfg, model, slots=SLOTS, max_len=MAX_LEN, mesh=mesh,
                      device=dev, **plane)
    for r in make_requests(cfg, 1, 2, seed=99):
        eng.submit(r)
    eng.run()
    mla = cfg.mla is not None
    attr = "paged_attend_mla" if mla else "paged_attend_gqa"
    orig, first = getattr(kops, attr), {}

    def keep(t):
        return t.clone() if torch.is_tensor(t) else t

    def spy(*a, **kw):
        out = orig(*a, **kw)
        if not first:
            first.update(args=[keep(t) for t in a],
                         kw={k: keep(v) for k, v in kw.items()}, out=out.clone())
        return out

    setattr(kops, attr, spy)
    split = {}

    def split_spy(name):
        fn = getattr(SM, name)

        def call(*a, **kw):
            out = fn(*a, **kw)
            if name not in split:
                split[name] = ([keep(t) for t in a], out.clone())
            return out
        return fn, call

    split_orig = {n: split_spy(n) for n in SPLIT_LAUNCHES} if seq else {}
    for n, (_, call) in split_orig.items():
        setattr(SM, n, call)
    obs = obs_lib.Observability()
    eng.attach_obs(obs)
    reqs = make_requests(cfg, REQUESTS, MAX_NEW, seed=0)
    if cuda:
        torch.cuda.synchronize()
    if mesh is not None:
        mesh.stats.clear()
    build.reset_launches()
    t0 = time.perf_counter()
    for r in reqs:
        eng.submit(r)
    steps = []
    while eng.has_work:
        ts = time.perf_counter()
        eng.step()
        steps.append(time.perf_counter() - ts)
    if cuda:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(build.LAUNCHES)
    setattr(kops, attr, orig)
    for n, (fn, _) in split_orig.items():
        setattr(SM, n, fn)
    res = {}
    if seq:
        plains = {"softmax_split_max": SM.softmax_split_max_plain,
                  "softmax_split_windows": SM.softmax_split_windows_plain,
                  "softmax_split_probs": SM.softmax_split_probs_plain}
        res["split_bit_equal"] = {
            n: bool(torch.equal(plains[n](*split[n][0]), split[n][1]))
            for n in SPLIT_LAUNCHES}
        x, m, w = split["softmax_split_probs"][0]
        whole = SM.softmax_2d(torch.cat(shd.all_gather(x, mesh), dim=-1))
        span = x.shape[1]
        res["split_shape"] = list(x.shape)
        res["whole_bit_equal"] = bool(torch.equal(
            whole[:, mesh.model_rank * span:(mesh.model_rank + 1) * span],
            split["softmax_split_probs"][1]))
    if paged:
        plain = PA.mla_decode_plain if mla else PA.gqa_decode_plain
        ref = plain(*first["args"], **first["kw"])
        res.update(kernel_q_shape=list(first["args"][0].shape),
                   kernel_pool_shape=list(first["args"][2].shape),
                   kernel_err=float((first["out"] - ref).abs().max()),
                   kernel_bit_equal=bool(torch.equal(first["out"], ref)))
    coll = obs.metrics.get("engine.phase.collective_ms")
    n_tok = sum(len(r.out) for r in reqs)
    stats = dict(mesh.stats) if mesh is not None else {}
    probe = {"sound": tp_probe(model, cfg, mesh, dev),
             "unreduced": tp_probe(model, cfg, mesh, dev, reduce=False)}
    res.update(probe=probe, rank=mesh.model_rank if mesh is not None else 0,
               done=all(r.done and r.error is None and len(r.out) == MAX_NEW for r in reqs),
               out={r.rid: list(r.out) for r in reqs}, tokens=n_tok,
               step_ms_p50=statistics.median(steps) * 1e3, steps=len(steps),
               tok_s=n_tok / wall, wall_s=wall, init_s=init_s,
               collective_ms_p50=coll.quantile(0.5) if coll is not None else None,
               peak_gib=(torch.cuda.max_memory_allocated() / 2**30 if cuda else 0.0),
               pool_bytes=eng.kv_pool_bytes(), state_bytes=eng.state_bytes(),
               cache_bytes=eng.kv_cache_bytes(), launches=counts,
               kv_shape=list(next((v.shape for k, v in eng._caches.layers[0].items()
                                   if k in ("k", "c_kv", "k_pool", "c_kv_pool")), ())),
               backend=mesh.backend if mesh is not None else "none",
               staged=bool(mesh is not None and mesh.staged and cuda),
               all_reduces=stats.get("all_reduce", 0),
               collective_bytes=stats.get("bytes", 0))
    del eng, model, first, split
    if cuda:
        torch.cuda.empty_cache()
    return res


def tp_state_bytes(cfg, tp, base):
    """A rank's recurrent state bytes from tp 1's ``base``: 1/tp, but for
    each Mamba2 layer's whole B / C conv columns (2 G N channels over
    d_conv - 1 positions a slot, float32), which every rank holds."""
    if cfg.ssm is None:
        return base // tp
    s = cfg.ssm
    whole = (cfg.block_pattern.count("mamba2") * SLOTS * (s.d_conv - 1)
             * 2 * s.n_groups * s.d_state * 4)
    return (base - whole) // tp + whole


def tp_path(torch, build, ref, smoke=False, runs=TP_RUNS):
    """(m) tensor-parallel serving on the one card: Yi-9B at full width cut
    to SIDE_LAYERS blocks at tp 2 and 4, DeepSeek-V2-Lite at full width and
    depth at tp 2, xLSTM-1.3B at tp 2 and 4 and Zamba2-1.2B at tp 2 at full
    width cut to SIDE_LAYERS blocks (dense plane), and at tp 2 Yi-9B and
    DeepSeek-V2-Lite cut to SIDE_LAYERS blocks with kv_shard="seq_model" on
    the dense plane, one process per rank (gloo: NCCL refuses two ranks on
    one device; CUDA tensors staged through host memory); the runs of one
    tp share one group of ranks. DeepSeek-V2-Lite's heads cut serves the
    same traffic as the serve path's tp 1 run (``ref``: {arch: its
    stats}); every other run's tp 1 reference is the same model served here
    (``tp_rank`` at tp 1; a " seq" run's is the whole dense cache). Gates:
    each sublayer on every
    rank's shard computes tp 1's output on the same input within
    TP_PROBE_TOL, and lands outside it with the rank's reductions skipped
    (``tp_probe``: a wrong cut, slice or reduction fails it); every rank
    emits the same tokens, each rank's first decode-kernel call on its head
    slice is bit-equal to the plain version (paged plane), each Yi rank's
    pools hold 1/tp of tp 1's bytes, each recurrent rank's state 1/tp of
    tp 1's but the stated Mamba2 B / C columns (``tp_state_bytes``), each
    " seq" rank's cache T/tp positions of every KV head and its first call
    of each split launch bit-equal to plain, the split probabilities
    bit-equal to whole-row softmax_2d on the gathered scores, every rank
    launched its run's kernels. Reported: token matches against tp 1 (and
    a " seq" run's against the heads cut's tp 2 run), step p50, tok/s, the
    collective span's p50, each rank's peak memory.
    ``smoke``: the smoke configs (a CPU rehearsal). Returns {(arch, tp):
    [each rank's launch counts]}."""
    from repro_torch.launch import mesh as mesh_lib

    if DEV == "cuda":
        build.build_all()                 # built already: no rank runs nvcc
        torch.cuda.empty_cache()
    out, probe_ref, ref = {}, {}, dict(ref)
    t0 = time.perf_counter()
    for run in dict.fromkeys(a for a, _ in runs):
        arch = run_arch(run)
        if run not in ref:
            base = tp_rank(dict(arch=run, tp=1, device=DEV, smoke=smoke))
            ref[run] = base
            if arch in RECURRENT_ARCHS:
                probe_ref[run] = base["probe"]["sound"]
            cfg = tp_cfg(run, smoke)
            log(f"[path tp {run} tp=1] {cfg.num_layers} layers, "
                f"{'paged' if base['pool_bytes'] else 'dense'} plane: step p50 "
                f"{base['step_ms_p50']:.2f} ms, {base['tok_s']:.2f} tok/s, state bytes "
                f"{base['state_bytes']}, KV {base['kv_shape']}, peak "
                f"{base['peak_gib']:.2f} GiB; launches {base['launches']}")
        if run not in probe_ref:
            probe_ref[run] = probe_ref.get(arch) or tp_probe_ref(arch, smoke)
            probe_ref.setdefault(arch, probe_ref[run])
    log(f"[time] [path tp] references: {time.perf_counter() - t0:.1f} s")
    for tp in dict.fromkeys(t for _, t in runs):
        t0 = time.perf_counter()
        archs = [a for a, t in runs if t == tp]
        backend = mesh_lib.pick_backend(tp, DEV)
        jobs = [dict(arch=a, tp=tp, device=DEV, smoke=smoke) for a in archs]
        # each run took 19-46 s on the card (PERF.md): a rank that takes
        # several times that fails the phase inside the script's time limit
        group = mesh_lib.run_ranks(tp_rank, tp, jobs, backend=backend,
                                   timeout=200 * len(jobs))
        for j, arch in enumerate(archs):
            res = [g[j] for g in group]
            # a seq run's heads cut: the same arch's run in this group, where
            # it serves the same depth
            cut = arch.removesuffix(SEQ)
            heads = (group[0][archs.index(cut)] if arch.endswith(SEQ) and cut in archs
                     and tp_cfg(cut, smoke).num_layers == tp_cfg(arch, smoke).num_layers
                     else None)
            tp_gates(arch, tp, res, ref[arch], probe_ref[arch], smoke, heads)
            out[(arch, tp)] = [r["launches"] for r in res]
        log(f"[time] [path tp] tp={tp} group {archs}: {time.perf_counter() - t0:.1f} s")
    return out


def tp_gates(arch, tp, res, base, probe_ref, smoke, heads=None):
    """``tp_path``'s gates and report for one (run, tp) run; ``heads``: a
    " seq" run's heads-cut run of the same arch and tp (rank 0's result),
    whose tokens are reported beside tp 1's."""
    tag = f"[path tp {arch} tp={tp}]"
    check(all(r["done"] for r in res), f"{tag} every request finishes on every rank")
    check(all(r["out"] == res[0]["out"] for r in res),
          f"{tag} every rank emits the same tokens")
    for name, want in probe_ref.items():
        scale = float(want.abs().max())
        errs = {k: [float((r["probe"][k][name] - want).abs().max()) / scale
                    for r in res] for k in ("sound", "unreduced")}
        log(f"{tag} {name}: max |tp {tp} - tp 1| / max |tp 1| ({scale:.4g}) per rank "
            f"{[f'{e:.3e}' for e in errs['sound']]}; reductions skipped "
            f"{[f'{e:.3e}' for e in errs['unreduced']]} (bound {TP_PROBE_TOL})")
        check(max(errs["sound"]) <= TP_PROBE_TOL,
              f"{tag} {name}: a rank's shard computes otherwise than tp 1")
        check(min(errs["unreduced"]) > TP_PROBE_TOL,
              f"{tag} {name}: the probe cannot tell a skipped reduction")
    recurrent = run_arch(arch) in RECURRENT_ARCHS
    seq = arch.endswith(SEQ)
    cfg = tp_cfg(arch, smoke)
    for r in res:
        if seq:
            for n, ok in r["split_bit_equal"].items():
                check(ok, f"{tag} rank {r['rank']}: the first {n} call on "
                      f"{r['split_shape']} differs from its plain version")
            check(r["whole_bit_equal"], f"{tag} rank {r['rank']}: the split softmax "
                  f"on {r['split_shape']} differs from whole-row softmax_2d on the "
                  "ranks' gathered scores")
            b = base["kv_shape"]
            check(r["kv_shape"] == [b[0], b[1] // tp] + b[2:],
                  f"{tag} rank {r['rank']}: KV buffer {r['kv_shape']} is not T/{tp} "
                  f"positions of tp 1's {b}")
        elif not recurrent:
            check(r["kernel_bit_equal"], f"{tag} rank {r['rank']}: the first decode "
                  f"step's kernel on its head slice {r['kernel_q_shape']} differs from "
                  f"plain by {r['kernel_err']}")
        if DEV == "cuda":
            for k in TP_KERNELS.get(arch, TP_KERNELS[run_arch(arch)]):
                check(r["launches"].get(k, 0) > 0,
                      f"{tag} rank {r['rank']} never launched {k}")
        if arch == "yi-9b":
            check(r["pool_bytes"] * tp == base["pool_bytes"],
                  f"{tag} rank {r['rank']}: pool bytes {r['pool_bytes']} are not "
                  f"1/{tp} of tp 1's {base['pool_bytes']}")
        if recurrent:
            want = tp_state_bytes(cfg, tp, base["state_bytes"])
            check(r["state_bytes"] == want,
                  f"{tag} rank {r['rank']}: state bytes {r['state_bytes']}, not "
                  f"{want} (tp 1: {base['state_bytes']})")
    same = sum(a == b for rid, toks in base["out"].items()
               for a, b in zip(toks, res[0]["out"][rid]))
    r0 = res[0]
    if seq:
        vs_heads = (sum(a == b for rid, toks in heads["out"].items()
                        for a, b in zip(toks, r0["out"][rid])) if heads else None)
        log(f"{tag} kv_shard=seq_model, dense plane: KV buffer per rank "
            f"{r0['kv_shape']} (tp 1: {base['kv_shape']}); token match against the "
            f"heads cut's tp {tp} run (paged plane): "
            f"{f'{vs_heads}/' + str(base['tokens']) if heads else 'none at this depth'}; each "
            f"rank's first split launches on {r0['split_shape']} bit-equal to plain, "
            f"the split result bit-equal to whole-row softmax_2d")
    log(f"{tag} backend {r0['backend']}, CUDA tensors staged through host memory: "
        f"{'yes' if r0['staged'] else 'no'}; {tp} ranks on one card; init "
        f"{[round(r['init_s'], 1) for r in res]} s")
    log(f"{tag} token match against tp 1: {same}/{base['tokens']} (reported, not "
        f"gated: row-parallel sums of bfloat16 partials round otherwise); step p50 "
        f"{r0['step_ms_p50']:.2f} ms over {r0['steps']} steps (tp 1: "
        f"{base['step_ms_p50']:.2f}), {r0['tok_s']:.2f} tok/s (tp 1: "
        f"{base['tok_s']:.2f}), collective span p50 {r0['collective_ms_p50']:.3f} ms; "
        f"{r0['all_reduces']} all-reduces of {r0['collective_bytes']} bytes on rank 0")
    if recurrent:
        extra = tp_state_bytes(cfg, tp, base["state_bytes"]) - base["state_bytes"] // tp
        log(f"{tag} per rank: state bytes {[r['state_bytes'] for r in res]} (tp 1: "
            f"{base['state_bytes']}; beyond 1/{tp} of it, the whole Mamba2 B / C conv "
            f"columns' {extra} bytes), peak memory GiB "
            f"{[round(r['peak_gib'], 2) for r in res]}; "
            f"launches {[r['launches'] for r in res]}")
    elif seq:
        log(f"{tag} per rank: peak memory GiB {[round(r['peak_gib'], 2) for r in res]}, "
            f"cache bytes {[r['cache_bytes'] for r in res]} (tp 1: "
            f"{base['cache_bytes']}); launches {[r['launches'] for r in res]}")
    else:
        log(f"{tag} per rank: peak memory GiB "
            f"{[round(r['peak_gib'], 2) for r in res]}, pool bytes "
            f"{[r['pool_bytes'] for r in res]} (tp 1: {base['pool_bytes']}), first "
            f"decode kernel q {r0['kernel_q_shape']} pool {r0['kernel_pool_shape']}: "
            f"|kernel - plain| {[r['kernel_err'] for r in res]}; launches "
            f"{[r['launches'] for r in res]}")
    RESULTS[f"tp {arch} tp={tp}"] = dict(
        match=same, of=base["tokens"], step_ms_p50=r0["step_ms_p50"],
        tok_s=r0["tok_s"], collective_ms_p50=r0["collective_ms_p50"],
        peak_gib=[r["peak_gib"] for r in res], backend=r0["backend"],
        staged=r0["staged"], all_reduces=r0["all_reduces"],
        state_bytes=[r["state_bytes"] for r in res],
        tp1_step_ms_p50=base["step_ms_p50"], tp1_tok_s=base["tok_s"])


# ---------------------------------------------------------------------------
# (n) the train step on a ("data", "model") mesh
# ---------------------------------------------------------------------------
#: (arch, layers, (data, model), zero1, compress): each arch at full width,
#: depth cut so that every rank's float32 master weights, AdamW moments
#: and gradients fit the one card together; Yi at one layer (a data-parallel
#: step stages every gradient through the host, most of them the
#: vocabulary's; the runs of one depth share a one-rank reference)
MESH_TRAIN_RUNS = (
    ("yi-9b", 1, (1, 2), False, False),
    ("yi-9b", 1, (2, 1), True, False),
    ("yi-9b", 1, (2, 2), True, False),
    ("yi-9b", 1, (2, 2), True, True),
    (DEEPSEEK, 3, (1, 2), False, False),
    ("zamba2-1.2b", 12, (1, 2), False, False),
    ("xlstm-1.3b", 8, (1, 2), False, False),
)
MESH_TRAIN_STEPS = 4
#: the steps of a data-parallel run: each stages every gradient (3.48 GB
#: for Yi at tp 1) and, under ZeRO-1, every parameter through the host
MESH_TRAIN_DP_STEPS = 2
#: archs trained on the mesh in float32 compute, so that the gradient gate
#: reads the mesh and not bfloat16's rounding (ROADMAP F11): in bfloat16 a
#: row-parallel partial sum one ulp off flips DeepSeek's top-6 of 64 random
#: experts for some tokens (its router's leaf 0.307 from the one-rank
#: step's); the recurrent pair's bfloat16 gradients are set to 0.2-0.6
#: relative by their rounding alone: on one rank a leaf's bfloat16
#: gradient lies as far from its float32 one as the mesh's from the one
#: rank's (``--mesh-train-witness``: Zamba2 0.206 / 0.216 at
#: ``blocks.9.mixer.conv_w``, xLSTM 0.621 / 0.513 at ``blocks.0.mixer.b_if``;
#: 1.2e-3 and 8.9e-4 on the mesh in float32)
MESH_TRAIN_F32 = (DEEPSEEK, "zamba2-1.2b", "xlstm-1.3b")
#: step 0's loss against the one-rank step's (relative)
MESH_TRAIN_LOSS_TOL = 2 ** -7
#: the kernels of a train step on the CORDIC datapaths
MESH_TRAIN_KERNELS = ("act_2d", "softmax_2d", "log_softmax_2d")
#: per process: each kernel's first call on the path (args, kwargs, output)
_MESH_FIRST = {}
#: the ZeRO-1 gate's whole-moment AdamW (``zero1_shadow``) updates each
#: leaf in flat pieces of this many elements: AdamW works element by
#: element, so the pieces' update is bit for bit the whole leaf's, and its
#: temporaries stay small beside the rank's own
SHADOW_PIECE = 1 << 24
#: per process: the whole-moment AdamW a ZeRO-1 run is held against
_MESH_SHADOW = {}


def zero1_shadow(state):
    """On a ZeRO-1 rank: a copy of its parameters (whole over the data
    axis) with whole moments, updated by AdamW without ZeRO-1 from the
    gradients, global norm and learning rate the step hands its own AdamW,
    and held against the step's parameters at every step.
    ``adamw.apply_updates`` stays wrapped until ``zero1_shadow_end``."""
    import torch

    from repro_torch.optim import adamw
    from repro_torch.train import step as step_lib

    params = {k: p.detach().clone() for k, p in step_lib.named_params(state.params).items()}
    sh = _MESH_SHADOW
    sh.update(params=params, opt=adamw.init(params), differ=set(), steps=0,
              orig=adamw.apply_updates,
              bytes=3 * sum(p.numel() * p.element_size() for p in params.values()))
    orig = sh["orig"]

    def flat(t):
        return t.reshape(-1).split(SHADOW_PIECE)

    def call(p, st, grads, cfg, lr_scale=1.0, *, gn=None, slices=None):
        # the parameters the step starts from: ZeRO-1's gathered, the shadow's whole
        sh["differ"].update(k for k, v in p.items() if not torch.equal(v, sh["params"][k]))
        o = sh["opt"]
        for k, w in sh["params"].items():
            for a, m, v, g in zip(flat(w), flat(o.mu[k]), flat(o.nu[k]), flat(grads[k])):
                orig({k: a}, adamw.AdamWState(o.step, {k: m}, {k: v}), {k: g}, cfg,
                     lr_scale, gn=gn)
        sh["opt"] = adamw.AdamWState(o.step + 1, o.mu, o.nu)
        sh["steps"] += 1
        return orig(p, st, grads, cfg, lr_scale, gn=gn, slices=slices)

    adamw.apply_updates = call


def zero1_shadow_end(state):
    """``zero1_shadow``'s reading after the last step: (the leaves whose
    parameters differed from the whole-moment AdamW's at any step, the
    steps held); the wrapper removed and the copy freed."""
    import torch

    from repro_torch.optim import adamw
    from repro_torch.train import step as step_lib

    sh = _MESH_SHADOW
    adamw.apply_updates = sh["orig"]
    final = step_lib.named_params(state.params)
    sh["differ"].update(k for k, v in final.items() if not torch.equal(v, sh["params"][k]))
    out = sorted(sh["differ"]), sh["steps"]
    sh.clear()
    return out


def mesh_train_cfg(arch, layers, smoke=False):
    """The arch at full width (``smoke``: its smoke config) cut to
    ``layers`` blocks, every datapath on the CORDIC kernels, token inputs;
    float32 compute for MESH_TRAIN_F32."""
    import dataclasses

    from repro_torch import configs

    get = configs.get_smoke if smoke else configs.get_config
    cfg = get(arch, act_impl="cordic_pallas")
    n = min(layers, cfg.num_layers)
    return dataclasses.replace(cfg, num_layers=n, block_pattern=cfg.block_pattern[:n],
                               input_mode="tokens", softmax_impl="cordic_pallas",
                               loss_impl="cordic_pallas",
                               dtype="float32" if arch in MESH_TRAIN_F32 else cfg.dtype)


def mesh_train_batch(cfg):
    """The loop pipeline's batch_at(0), 8 x 32 tokens (numpy)."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLMDataset

    return SyntheticLMDataset(DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                                         global_batch=TRAIN_BATCH, seed=0)).batch_at(0)


def mesh_train_before(payload, state, batch, cfg, mesh):
    """``rank_train``'s probe before the steps, on every rank: step 0's
    reduced gradients gathered whole over the model axis leaf by leaf and
    held against the one-rank step's (saved at ``payload["ref"]``) on model
    rank 0 of data rank 0 (no ``ref``: checked by an earlier run on the
    same mesh, whose step-0 gradients ZeRO-1 and compression do not
    change); with ``payload["shadow"]`` the ZeRO-1 gate's whole-moment
    AdamW installed (``zero1_shadow``); then the launch counts zeroed and
    each kernel's first call on the steps kept. Returns {leaf: relative L2
    error}."""
    import torch

    from repro_torch.distributed import sharding as shd
    from repro_torch.kernels import build
    from repro_torch.kernels import cordic_act as K
    from repro_torch.kernels import softmax_cordic as SM
    from repro_torch.train import step as step_lib

    errs = {}
    if payload["ref"] is not None:
        _, _, g = step_lib.grads_of(state.params, batch, cfg)
        step_lib.reduce_grads(state.params, g, cfg, mesh)
        ref = torch.load(payload["ref"], mmap=True) if mesh.rank == 0 else None
        cuts, parts = shd.leaf_cuts(state.params), shd.leaf_parts(state.params)
        for k in list(g):
            full = shd.full_leaf(g.pop(k), mesh, cuts.get(k), parts.get(k))
            if ref is not None:
                r = ref[k].to(full.device, torch.float32)
                errs[k] = float((full.float() - r).norm() / r.norm().clamp_min(1e-30))
            del full
        del ref
    if payload.get("shadow"):
        zero1_shadow(state)
    if payload["device"] == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    _MESH_FIRST.clear()

    def spy(mod, name):
        orig = getattr(mod, name)

        def call(*a, **kw):
            out = orig(*a, **kw)
            if name not in _MESH_FIRST:
                _MESH_FIRST[name] = ([t.clone() if torch.is_tensor(t) else t for t in a],
                                     dict(kw), out.clone(), (mod, orig))
            return out
        setattr(mod, name, call)

    for mod, name in ((K, "act_2d"), (SM, "softmax_2d"), (SM, "log_softmax_2d")):
        spy(mod, name)
    build.reset_launches()
    return errs


def mesh_train_after(payload, state, batch, cfg, mesh):
    """``rank_train``'s probe after the steps: the launch counts and peak
    memory of the steps (less the ZeRO-1 gate's copy of the parameters and
    whole moments, which the steps hold beside their own), each kernel's
    first call against its plain version, and under ``payload["shadow"]``
    the ZeRO-1 gate's reading (``zero1_shadow_end``)."""
    import torch

    from repro_torch.kernels import build
    from repro_torch.kernels import cordic_act as K
    from repro_torch.kernels import softmax_cordic as SM
    from repro_torch.train import step as step_lib

    counts = dict(build.LAUNCHES)
    shadow_bytes = _MESH_SHADOW.get("bytes", 0)
    peak = ((torch.cuda.max_memory_allocated() - shadow_bytes) / 2**30
            if payload["device"] == "cuda" else 0.0)
    plain = {"act_2d": K.act_2d_plain, "softmax_2d": SM.softmax_2d_plain,
             "log_softmax_2d": SM.log_softmax_2d_plain}
    first = {}
    for name, (a, kw, out, (mod, orig)) in list(_MESH_FIRST.items()):
        setattr(mod, name, orig)
        want = plain[name](*a, **kw)
        first[name] = dict(shape=list(a[0].shape), equal=bool(torch.equal(out, want)),
                           err=float((out.float() - want.float()).abs().max()))
    _MESH_FIRST.clear()
    params = step_lib.named_params(state.params)
    differ = zero1_shadow_end(state) if payload.get("shadow") else None
    moments = list(state.opt.mu.values()) + list(state.opt.nu.values())
    return dict(launches=counts, peak_gib=peak, first=first, differ=differ,
                rank=mesh.rank, n_params=sum(p.numel() for p in params.values()),
                opt_bytes=sum(t.numel() * t.element_size() for t in moments))


def mesh_train_ref(torch, arch, layers, smoke=False):
    """The one-rank step of the same depth, weights (seed 0) and global
    batch in this process: step 0's loss and gradients (saved for the
    ranks to read), the losses of MESH_TRAIN_STEPS steps."""
    import os
    import tempfile

    from repro_torch.optim import adamw
    from repro_torch.train import loop as loop_lib
    from repro_torch.train import step as step_lib

    cfg = mesh_train_cfg(arch, layers, smoke)
    opt = adamw.AdamWConfig(lr=DESCENT_LR)
    state = step_lib.init_state(cfg, 0, opt, device=DEV)
    batch = loop_lib.to_device(mesh_train_batch(cfg), DEV)
    loss, _, g = step_lib.grads_of(state.params, batch, cfg)
    path = os.path.join(tempfile.gettempdir(),
                        f"mesh_train_ref_{arch}_{layers}_{os.getpid()}.pt")
    torch.save({k: v.detach().cpu() for k, v in g.items()}, path)
    del g
    step = step_lib.make_train_step(cfg, opt, warmup_steps=0)
    losses, dts = [], []
    for _ in range(MESH_TRAIN_STEPS):
        t0 = time.perf_counter()
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        dts.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() / 2**30 if DEV == "cuda" else 0.0
    del state, batch
    if DEV == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    return dict(loss0=float(loss), losses=losses, path=path, step_ms_p50=
                statistics.median(dts) * 1e3, peak_gib=peak)


def mesh_train_path(torch, build, smoke=False, runs=MESH_TRAIN_RUNS):
    """(n) The train step on a ("data", "model") mesh, every rank a process
    on the one card (gloo, CUDA tensors staged through host memory), each
    run MESH_TRAIN_STEPS steps (MESH_TRAIN_DP_STEPS with data ranks) of
    rank_train (launch/train.py, the entry point a user calls through
    launch/mesh.run_ranks) on the 8 x 32-token batch, the kernels' datapaths. The ranks of one world size share one
    group. The reference of an arch is its one-rank step in this process
    (``mesh_train_ref``). Gates per run: every rank's losses equal; step
    0's loss within MESH_TRAIN_LOSS_TOL of the one-rank step's; each
    gradient leaf gathered whole within TP_PROBE_TOL (relative L2) of the
    one-rank step's; the loss falling; each rank's first call of each
    kernel bit-equal to its plain version on that rank's shape, and every
    kernel of the arch launched; ZeRO-1's parameters bit-equal, at every
    step, to those of AdamW with whole moments on the same gradients
    (``zero1_shadow``). Reported: step p50, the collectives and bytes of a
    step, each rank's peak memory, ZeRO-1's moment bytes a rank. Returns
    {run tag: [each rank's launch counts]}."""
    import os

    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch.train import rank_train

    if DEV == "cuda":
        build.build_all()                 # built already: no rank runs nvcc
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    refs = {}
    for arch, layers, *_ in runs:
        if (arch, layers) not in refs:
            refs[arch, layers] = mesh_train_ref(torch, arch, layers, smoke)
            r = refs[arch, layers]
            log(f"[path mesh-train {arch}] one-rank reference, {layers} layers: losses "
                f"{[round(x, 5) for x in r['losses']]}, step p50 {r['step_ms_p50']:.1f} "
                f"ms, peak {r['peak_gib']:.2f} GiB")
    log(f"[time] [path mesh-train] references: {time.perf_counter() - t0:.1f} s")
    jobs_by_world, tags, checked = {}, {}, {}
    for arch, layers, (dp, tp), zero1, compress in runs:
        cfg = mesh_train_cfg(arch, layers, smoke)
        tag = f"{arch} ({dp}, {tp})" + (" zero1" if zero1 else "") + (
            " compress" if compress else "")
        # the first run of (arch, mesh) checks the step-0 gradients
        first = checked.setdefault((arch, dp, tp), tag) == tag
        steps = MESH_TRAIN_STEPS if dp == 1 else MESH_TRAIN_DP_STEPS
        job = dict(cfg=cfg, tp=tp, batch=mesh_train_batch(cfg), steps=steps,
                   device=DEV, lr=DESCENT_LR, zero1=zero1, compress=compress,
                   before=(mesh_train_before, {"ref": refs[arch, layers]["path"] if first
                                               else None,
                                               "device": DEV, "shadow": zero1}),
                   after=(mesh_train_after, {"device": DEV, "shadow": zero1}))
        jobs_by_world.setdefault(dp * tp, []).append(("repro_torch.launch.train:rank_train",
                                                      job))
        tags.setdefault(dp * tp, []).append((tag, (arch, layers), cfg, checked[arch, dp, tp]))
    out = {}
    try:
        for world, jobs in jobs_by_world.items():
            t1 = time.perf_counter()
            backend = mesh_lib.pick_backend(world, DEV)
            res = mesh_lib.run_ranks(mesh_lib.rank_jobs, world, jobs, backend=backend,
                                     timeout=150 * len(jobs))
            for j, (tag, arch, cfg, by) in enumerate(tags[world]):
                ranks = [r[j] for r in res]
                mesh_train_gates(tag, cfg, ranks, refs[arch], by)
                out[tag] = [r["after"]["launches"] for r in ranks]
            log(f"[time] [path mesh-train] {world} ranks, {len(jobs)} runs: "
                f"{time.perf_counter() - t1:.1f} s")
    finally:
        for r in refs.values():
            if os.path.exists(r["path"]):
                os.remove(r["path"])
    return out


#: the data axes' position cut (o): Zamba2's shared block at SIDE_LAYERS
#: depth (two applications), batch 1, a (2, 1) mesh; the prompt, the decode
#: steps and the cache's positions (whole 32-lane windows a span)
DATA_SEQ_ARCH, DATA_SEQ_PROMPT, DATA_SEQ_STEPS, DATA_SEQ_LEN = "zamba2-1.2b", 24, 8, 128


def data_seq_rank(job):
    """One rank of ``data_seq_path`` (a ``run_ranks`` target), or the one-rank
    reference in this process: ``launch/dryrun.rank_decode`` with the launch
    counts zeroed just before and read just after."""
    import torch

    from repro_torch.kernels import build
    from repro_torch.launch import dryrun

    torch.backends.cuda.matmul.allow_tf32 = False
    build.LAUNCHES.clear()
    out = dryrun.rank_decode(job)
    out["launches"] = dict(build.LAUNCHES)
    return out


def data_seq_path(torch, build, smoke=False):
    """(o) The data axes' position cut of the dense caches (ROADMAP A.17b)
    on the card: Zamba2-1.2B at full width cut to SIDE_LAYERS blocks
    (``tp_cfg``: cordic_pallas, two shared-block applications), one row
    (batch 1, which the data axes do not divide: kv_shard resolves to
    "seq_data"), on a (2, 1) mesh of two processes on the one card (gloo,
    staged through host memory): a prefill of DATA_SEQ_PROMPT tokens and
    DATA_SEQ_STEPS greedy decode steps (``launch/dryrun.rank_decode``, the
    dry run's steps) at DATA_SEQ_LEN positions, against one rank in this
    process. Gates: both ranks resolve "seq_data" and emit the same tokens,
    each rank's attention buffers hold half of one rank's bytes, the data
    group's collectives run, and each rank launched the split softmax's
    three kernels and the activations. Reported: the tokens against one
    rank's. Returns [each rank's launch counts]."""
    import numpy as np

    from repro_torch.launch import mesh as mesh_lib

    if DEV == "cuda":
        build.build_all()                 # built already: no rank runs nvcc
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cfg = tp_cfg(DATA_SEQ_ARCH, smoke)
    prompt = np.random.default_rng(7).integers(0, cfg.vocab_size, (1, DATA_SEQ_PROMPT))
    job = dict(cfg=cfg, prompt=prompt, steps=DATA_SEQ_STEPS, max_len=DATA_SEQ_LEN,
               tp=1, device=DEV)
    one = data_seq_rank(job)
    if DEV == "cuda":
        torch.cuda.empty_cache()
    res = mesh_lib.run_ranks(data_seq_rank, 2, job, backend=mesh_lib.pick_backend(2, DEV),
                             timeout=300)
    tag = f"[path data-seq {DATA_SEQ_ARCH} (2, 1)]"
    for r in res:
        check(r["kv_shard"] == "seq_data", f"{tag} kv_shard resolved to {r['kv_shard']}")
        check(r["tokens"] == res[0]["tokens"], f"{tag} the ranks emit different tokens")
        check(2 * r["cache_bytes"] == one["cache_bytes"],
              f"{tag} a rank's attention buffers hold {r['cache_bytes']} bytes, not half "
              f"of one rank's {one['cache_bytes']}")
        check(r["stats"].get("data_all_reduce", 0) > 0
              and r["stats"].get("data_all_gather", 0) > 0,
              f"{tag} no collectives over the data group: {r['stats']}")
        if DEV == "cuda":
            for k in ("act_2d", "silu_mul_2d") + SPLIT_LAUNCHES:
                check(r["launches"].get(k, 0) > 0, f"{tag} never launched {k}")
    same = sum(a == b for a, b in zip(one["tokens"][0], res[0]["tokens"][0]))
    log(f"{tag} {cfg.num_layers} layers, {DATA_SEQ_PROMPT}-token prompt, "
        f"{DATA_SEQ_STEPS} decode steps at {DATA_SEQ_LEN} positions: attention buffers "
        f"a rank {res[0]['cache_bytes']} bytes (one rank {one['cache_bytes']}); tokens "
        f"{res[0]['tokens'][0]} against one rank's {one['tokens'][0]}: {same}/"
        f"{DATA_SEQ_STEPS + 1} equal (reported: the split sums' float32 partials "
        f"round otherwise); data-group collectives a rank {res[0]['stats']}; launches "
        f"{[r['launches'] for r in res]}; {time.perf_counter() - t0:.1f} s")
    return [r["launches"] for r in res]


def mesh_train_gates(tag, cfg, ranks, ref, checked_by):
    """``mesh_train_path``'s gates and report for one run (``checked_by``:
    the run on the same mesh that checked the step-0 gradients)."""
    name, tag = tag, f"[path mesh-train {tag}]"
    losses = ranks[0]["losses"]
    check(all(r["losses"] == losses for r in ranks), f"{tag} every rank's losses equal")
    rel0 = abs(losses[0] / ref["loss0"] - 1)
    check(rel0 <= MESH_TRAIN_LOSS_TOL, f"{tag} step 0's loss {losses[0]} against the "
          f"one-rank step's {ref['loss0']}: {rel0:.3e} relative")
    check(all(math.isfinite(x) for x in losses + ranks[0]["grad_norms"]),
          f"{tag} finite losses and gradient norms")
    check(losses[-1] < losses[0], f"{tag} the loss does not fall: {losses}")
    errs = ranks[0]["before"]
    if checked_by == name:
        check(bool(errs), f"{tag} no gradient leaf was checked")
        top = sorted(errs.items(), key=lambda kv: -kv[1])[:4]
        worst = top[0]
        check(worst[1] <= TP_PROBE_TOL, f"{tag} gradient leaf {worst[0]}: relative L2 "
              f"{worst[1]:.3e} from the one-rank step's")
        grad_note = (f"worst gradient leaves {[(k, f'{v:.3e}') for k, v in top]} (bound "
                     f"{TP_PROBE_TOL})")
    else:
        top, worst = None, (None, RESULTS[f"mesh-train {checked_by}"]["worst_grad"])
        grad_note = f"step-0 gradients those of {checked_by}"
    attends = bool(set(cfg.block_pattern) & {"dense", "gqa_moe", "mla_dense", "mla_moe"}) \
        or cfg.shared_block is not None
    must = [k for k in MESH_TRAIN_KERNELS if k != "softmax_2d" or attends]
    for r in ranks:
        a = r["after"]
        for k in must:
            if DEV == "cuda":
                check(a["launches"].get(k, 0) > 0, f"{tag} rank {a['rank']} never "
                      f"launched {k}")
            f = a["first"].get(k)
            check(f is not None and f["equal"], f"{tag} rank {a['rank']}: {k}'s first "
                  f"call differs from its plain version: {f}")
        if a["differ"] is not None:
            differ, held = a["differ"]
            check(held == len(losses) and not differ, f"{tag} rank {a['rank']}: ZeRO-1's "
                  f"parameters differ from whole-moment AdamW's on {differ[:5]} "
                  f"({held} steps held)")
    st = ranks[0]["stats"]
    p50 = statistics.median(ranks[0]["step_ms"])
    zero1_note = ("; ZeRO-1 parameters bit-equal to whole-moment AdamW's at every "
                  "step" if ranks[0]["after"]["differ"] is not None else "")
    log(f"{tag} losses {[round(x, 5) for x in losses]} (one rank: "
        f"{[round(x, 5) for x in ref['losses']]}); step 0 {rel0:.3e} relative; "
        f"{grad_note}{zero1_note}")
    log(f"{tag} step p50 {p50:.1f} ms (one rank: {ref['step_ms_p50']:.1f} ms); a step's "
        f"collectives {st}; AdamW moment bytes per rank "
        f"{[r['after']['opt_bytes'] for r in ranks]}; peak memory GiB per rank "
        f"{[round(r['after']['peak_gib'], 2) for r in ranks]} (one rank: "
        f"{ref['peak_gib']:.2f}); first calls {ranks[0]['after']['first']}; launches "
        f"{[r['after']['launches'] for r in ranks]}")
    RESULTS[f"mesh-train {name}"] = dict(
        losses=losses, step_ms_p50=p50, stats=st, worst_grad=worst[1], worst_leaves=top,
        loss0_rel=rel0,
        peak_gib=[r["after"]["peak_gib"] for r in ranks], ref_step_ms_p50=ref["step_ms_p50"],
        n_params=[r["after"]["n_params"] for r in ranks],
        opt_bytes=[r["after"]["opt_bytes"] for r in ranks])


def mesh_train_witness(torch, build):
    """``--mesh-train-witness``: the reading behind MESH_TRAIN_F32 for the
    recurrent pair. Their (1, 2) runs in the configs' bfloat16, each gate
    logged instead of raised; then, on one rank, each leaf's bfloat16
    step-0 gradient against its float32 one (the same weights and batch):
    a leaf whose bfloat16 gradient lies as far from its float32 one as the
    mesh's lies from the one rank's is set by bfloat16's rounding, not by
    the mesh. Returns the gates that failed."""
    global MESH_TRAIN_F32, check
    import dataclasses

    from repro_torch.optim import adamw
    from repro_torch.train import loop as loop_lib
    from repro_torch.train import step as step_lib

    runs = [r for r in MESH_TRAIN_RUNS if r[0] in RECURRENT_ARCHS]
    failed, raising, kept = [], check, MESH_TRAIN_F32

    def logged(ok, what):
        if not ok:
            failed.append(what)
            log(f"[witness] gate failed: {what}")

    MESH_TRAIN_F32, check = tuple(a for a in kept if a not in RECURRENT_ARCHS), logged
    try:
        mesh_train_path(torch, build, runs=runs)
    finally:
        MESH_TRAIN_F32, check = kept, raising
    for arch, layers, *_ in runs:
        grads = {}
        for dt in ("bfloat16", "float32"):
            cfg = dataclasses.replace(mesh_train_cfg(arch, layers), dtype=dt)
            state = step_lib.init_state(cfg, 0, adamw.AdamWConfig(lr=DESCENT_LR), device=DEV)
            batch = loop_lib.to_device(mesh_train_batch(cfg), DEV)
            _, _, g = step_lib.grads_of(state.params, batch, cfg)
            grads[dt] = {k: v.detach().float().cpu() for k, v in g.items()}
            del state, batch, g
            torch.cuda.empty_cache()
        f32 = grads["float32"]
        rel = {k: float((v - f32[k]).norm() / f32[k].norm().clamp_min(1e-30))
               for k, v in grads["bfloat16"].items()}
        mesh = dict(RESULTS[f"mesh-train {arch} (1, 2)"]["worst_leaves"] or [])
        top = sorted(rel.items(), key=lambda kv: -kv[1])[:6]
        log(f"[witness {arch}] one rank, bfloat16 step-0 gradients against float32's "
            f"(relative L2): worst {[(k, f'{v:.3e}') for k, v in top]}, median "
            f"{statistics.median(rel.values()):.3e}; at the mesh's worst leaves "
            f"{[(k, f'mesh {v:.3e}', f'bf16-f32 {rel[k]:.3e}') for k, v in mesh.items()]}")
        RESULTS[f"witness {arch}"] = dict(bf16_vs_f32_top=top, mesh_bf16_top=mesh,
                                          bf16_vs_f32_at_mesh={k: rel[k] for k in mesh})
    return failed


# ---------------------------------------------------------------------------
#: the invariant products' row counts (a prefill's R x W rows) and batch
#: counts: each row must be the same bits at every one; the attention's
#: products at these positions a row (up to MAX_LEN) and PROBE_ROWS rows
GEMM_MS = (1, 16, 17, 100, 128, 4000)
GEMM_BATCHES = (1, 3)
#: row offsets of a 128-row window against M 4000's rows: a row at another
#: place of its tile, warpgroup and 64-row wgmma fragment
GEMM_SHIFTS = (1, 7, 64, 100)
#: the timed product: Yi-9B's widest (the MLP's gate, d 4096 -> d_ff 11008)
GEMM_TIMED = "yi gate"


@contextlib.contextmanager
def chain_products(on: bool):
    """While ``on``, the paged prefill's products (``cm.INVARIANT``) take the
    float32 SIMT route for bf16 operands too (the operands cast to float32,
    exactly: the bits of the SIMT chain, the products' former arithmetic), for a run whose
    tokens are reported against the tensor-core route's."""
    import torch

    from repro_torch.kernels import gemm as GM
    from repro_torch.models import common as cm

    if not on:
        yield
        return
    saved = cm.INVARIANT

    def mm(a, b, out_dtype=None):
        return GM.matmul(a.float(), b.float(), out_dtype or torch.result_type(a, b))

    def es(eq, a, b):
        return GM.einsum(eq, a.float(), b.float()).to(torch.result_type(a, b))

    cm.INVARIANT = cm.Products(mm, es, lambda table, x: mm(x, table.t(), torch.float32))
    try:
        yield
    finally:
        cm.INVARIANT = saved


def gemm_cases(ycfg, dcfg):
    """The paged prefill's products at Yi-9B's and DeepSeek-V2-Lite's (MLA)
    widths. Row products: name -> (K, N, the weight read as the transpose
    of an (N, K) table, out dtype or None). The attention's: name ->
    (einsum, the query side's shape at (R rows, W positions), the other
    operand's at R, the query side's W dim, the output's W dim), at
    MAX_LEN's table width."""
    import torch

    m = dcfg.mla
    d, hd, H, KH = ycfg.d_model, ycfg.head_dim, ycfg.num_heads, ycfg.num_kv_heads
    G, T = H // KH, MAX_LEN
    dd, dH = dcfg.d_model, dcfg.num_heads
    qk = m.qk_nope_dim + m.qk_rope_dim
    rows = {
        "yi wq": (d, H * hd, False, None), "yi wk": (d, KH * hd, False, None),
        "yi wo": (H * hd, d, False, None), "yi gate": (d, ycfg.d_ff, False, None),
        "yi down": (ycfg.d_ff, d, False, None),
        # the logits against a 4096-row slice of the vocabulary, float32
        "yi logits": (d, 4096, True, torch.float32),
        "mla wq": (dd, dH * qk, False, None),
        "mla wkv_a": (dd, m.kv_lora_rank + m.qk_rope_dim, False, None),
        "mla decompress": (m.kv_lora_rank, dH * (m.qk_nope_dim + m.v_dim), False, None),
        "mla wo": (dH * m.v_dim, dd, False, None),
    }
    attn = {
        "yi _scores": ("bqhgd,bkhd->bhgqk", lambda R, W: (R, W, KH, G, hd),
                       lambda R: (R, T, KH, hd), 1, 3),
        "yi _pv": ("bhgqk,bkhd->bqhgd", lambda R, W: (R, KH, G, W, T),
                   lambda R: (R, T, KH, hd), 3, 1),
        "mla _scores": ("bqhgd,bkhd->bhgqk", lambda R, W: (R, W, dH, 1, qk),
                        lambda R: (R, T, dH, qk), 1, 3),
        "mla _pv": ("bhgqk,bkhd->bqhgd", lambda R, W: (R, dH, 1, W, T),
                    lambda R: (R, T, dH, m.v_dim), 3, 1),
    }
    return rows, attn


def gemm_records(torch, records, ycfg, dcfg):
    """The invariant products (kernels/gemm.py) at the paged prefill's
    shapes, on both routes. The tensor-core route (``gemm_tc``: every row
    product of ``gemm_cases``, bf16 operands): each row the same bits at
    every row count of GEMM_MS and batch count and shifted by each of
    GEMM_SHIFTS rows (so a row sits at other places of a tile, a warpgroup
    and a 64-row fragment), M 4000's rows the reference; a K tail equal to
    its zero padding; every element of M 4000 within ``tc_gamma``'s bound of
    a float64 product, and within that bound plus the chain's of the plain
    version (at M 128); the max |difference| against the SIMT chain of the
    same operands reported, not gated. The SIMT route (``gemm``, float32
    operands): the attention's products at 1 and PROBE_ROWS rows and
    GEMM_MS positions up to MAX_LEN, and a float32 row product, each
    bit-equal to the plain version and across rows. Then the timed product
    at M 128 and 4000 on both routes beside torch.matmul (library_ms) and
    its bound, the larger of the operations over the peak of their type
    (bf16 tensor cores, float32 outside them) and the bytes over HBM's
    rate. Fills records["gemm_tc"] and records["gemm"] (M 4000)."""
    from repro_torch.kernels import gemm as GM

    c = kcost()
    gen = torch.Generator(device=DEV).manual_seed(17)
    rows, attn = gemm_cases(ycfg, dcfg)
    M_max = max(GEMM_MS)
    err, n_checked, tc_err = [0.0], [0], dict(ratio=0.0, plain=0.0, simt=0.0)

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=DEV) * scale).to(torch.bfloat16)

    def same(x, y, what):
        n_checked[0] += 1
        check(torch.equal(x, y), f"gemm {what}: not bit-equal")

    def plain_same(x, y, what):
        err[0] = max(err[0], float((x.float() - y.float()).abs().max()))
        same(x, y, what)

    t0 = [time.perf_counter()]
    for name, (K, N, transposed, out_dtype) in rows.items():
        a = rnd(M_max, K)
        w = rnd(N, K, scale=K ** -0.5).t() if transposed else rnd(K, N, scale=K ** -0.5)
        if name == GEMM_TIMED:
            timed = (a, w)
        full = GM.matmul(a, w, out_dtype)
        for M in GEMM_MS:
            same(GM.matmul(a[:M], w, out_dtype), full[:M], f"{name} M {M}: rows against M {M_max}'s")
        for sh in GEMM_SHIFTS:
            same(GM.matmul(a[sh:sh + GEMM_MS[-2]], w, out_dtype), full[sh:sh + GEMM_MS[-2]],
                 f"{name} rows shifted by {sh}")
        for nb in GEMM_BATCHES[1:]:
            M = min(GEMM_MS[-2], M_max // nb)
            got = GM.gemm(a[:nb * M].view(nb, M, K), w[None].expand(nb, K, N), out_dtype)
            same(got.reshape(nb * M, N), full[:nb * M], f"{name} batch {nb} x M {M}")
        odt = out_dtype or torch.bfloat16
        ref, bound = GM.gemm_bound(a[None], w[None], GM.tc_gamma(K, odt))
        e = (full.double() - ref[0]).abs()
        tc_err["ratio"] = max(tc_err["ratio"], float((e / bound[0]).max()))
        check(bool((e <= bound[0]).all()), f"gemm_tc {name}: beyond tc_gamma's bound of float64 "
              f"(max |c - c64| / bound {float((e / bound[0]).max())})")
        del ref, e
        m = GEMM_MS[-2]
        plain = GM.matmul_plain(a[:m], w, out_dtype)
        d = (full[:m].double() - plain.double()).abs()
        chain = GM.chain_gamma(K, odt) * bound[0, :m] / GM.tc_gamma(K, odt)
        check(bool((d <= bound[0, :m] + chain).all()),
              f"gemm_tc {name}: beyond the bounds' sum of the plain version")
        tc_err["plain"] = max(tc_err["plain"], float(d.max()))
        del bound, chain, d
        simt = GM.matmul(a.float(), w.float(), odt)
        tc_err["simt"] = max(tc_err["simt"], float((full.float() - simt.float()).abs().max()))
        if name == GEMM_TIMED:                # the K tail against its zero padding
            kt = K - K % 64 - 32
            pa = torch.zeros(M_max, kt + 32, dtype=a.dtype, device=DEV)
            pa[:, :kt] = a[:, :kt]
            pw = torch.zeros(kt + 32, N, dtype=w.dtype, device=DEV)
            pw[:kt] = w[:kt]
            same(GM.matmul(a[:, :kt], w[:kt]), GM.matmul(pa, pw),
                 f"{name} K {kt}: against its zero padding to {kt + 32}")
        if DEV == "cuda":
            torch.cuda.synchronize()
    log(f"[kernels] gemm_tc: max |c - c64| / (tc_gamma sum|ab|) {tc_err['ratio']:.3e}; "
        f"max |tc - plain chain| {tc_err['plain']:.3e} (M {GEMM_MS[-2]}), against the "
        f"SIMT chain {tc_err['simt']:.3e} (M {M_max}; reported, not gated)")
    sub_phase("gemm_tc: the row products at every M, place and batch, their bound", t0)
    K, N = ycfg.d_model, ycfg.num_kv_heads * ycfg.head_dim       # yi wk in float32
    a32 = torch.randn(GEMM_MS[-2], K, generator=gen, device=DEV)
    w32 = torch.randn(K, N, generator=gen, device=DEV) * K ** -0.5
    full = GM.matmul(a32, w32)
    for M in [m for m in GEMM_MS if m <= GEMM_MS[-2]]:
        got = GM.matmul(a32[:M], w32)
        same(got, full[:M], f"float32 yi wk M {M}: rows against M {GEMM_MS[-2]}'s")
        plain_same(got, GM.matmul_plain(a32[:M], w32), f"float32 yi wk M {M} against plain")
    for name, (eq, qshape, kshape, qdim, odim) in attn.items():
        R, W = PROBE_ROWS, MAX_LEN
        if "_pv" in name:                     # probabilities: float32 lanes
            q = torch.rand(qshape(R, W), generator=gen, device=DEV)
        else:
            q = rnd(*qshape(R, W)).float()
        other = rnd(*kshape(R)).float()
        full = GM.einsum(eq, q, other)
        for r in (1, R):
            for w in [m for m in GEMM_MS if m <= W]:
                qs = q[:r].narrow(qdim, 0, w)
                got = GM.einsum(eq, qs, other[:r])
                same(got, full[:r].narrow(odim, 0, w),
                     f"{name} R {r} W {w}: rows against R {R} W {W}'s")
                plain_same(got, GM.einsum_plain(eq, qs, other[:r]),
                           f"{name} R {r} W {w} against plain")
        if DEV == "cuda":
            torch.cuda.synchronize()
    sub_phase("gemm: the float32 products at every row count and width", t0)

    a, w = timed
    K, N = w.shape
    recs = {}
    for M in (GEMM_MS[-2], M_max):
        x = a[:M]
        xf, wf = x.float(), w.float()
        flops = 2 * M * N * K
        _, (plain_ms, _) = plain_call(torch, lambda: GM.matmul_plain(x, w))
        for route, args, peak, kname in (
                ("gemm_tc", (x, w), c.BF16_FLOP_S, "tc_gemm_kernel"),
                ("gemm", (xf, wf), c.FP32_FLOP_S, "gemm_kernel")):
            nbytes = sum(t.numel() * t.element_size() for t in args) + M * N * 2
            tb = {"bytes": nbytes / c.HBM_BYTES_S, "operations": flops / peak}
            by = max(tb, key=tb.get)
            ms, host = times(torch, lambda: GM.matmul(*args, torch.bfloat16), kernel=kname)
            lib_ms, _ = times(torch, lambda: torch.matmul(*args))
            recs[route, M] = dict(
                max_abs_err=tc_err["plain"] if route == "gemm_tc" else err[0], ms=ms,
                plain_ms=plain_ms, bound_ms=tb[by] * 1e3, bound_by=by, library_ms=lib_ms)
            log(f"[kernels] {route} {GEMM_TIMED} M {M} K {K} N {N} "
                f"{'bf16' if route == 'gemm_tc' else 'float32'} operands: {ms:.4f} ms "
                f"({flops / ms / 1e9:.2f} TFLOP/s), host {host:.4f} ms; plain "
                f"{plain_ms:.2f} ms (one check call); torch.matmul {lib_ms:.4f} ms; bound "
                f"{tb[by] * 1e3:.5f} ms ({by}); {ms / lib_ms:.2f}x the library's")
    records["gemm_tc"] = recs["gemm_tc", M_max]
    records["gemm"] = recs["gemm", M_max]
    log(f"[kernels] gemm: {n_checked[0]} checks bit-equal (rows across M, place and batch, "
        f"the K tail, the float32 route against plain), max |SIMT - plain| {err[0]}")
    sub_phase("gemm: times", t0)


#: ROADMAP B.10's probe: a PROBE_SEG-token segment prefilled alone (one
#: row of width PROBE_SEG), inside rows of each PROBE_WIDE width, and as row
#: 1 of a PROBE_ROWS-row dispatch; the gathered table's width
PROBE_SEG, PROBE_WIDE, PROBE_ROWS, PROBE_T = 16, (128, 4000), 4, 4096
#: the products the probe runs: torch's, then the paged prefill's
PROBE_IMPLS = ("library", "invariant")


def invariant_phase(torch, records, ycfg, dcfg):
    """Phase (3d): the invariant product against its plain version
    (``gemm_records``), then the probe under torch's products and under the
    paged prefill's; under the latter no operation may move. Returns the
    probe's readings by impl (chiprun_out/prefill_probe.json too)."""
    gemm_records(torch, records, ycfg, dcfg)
    probes = {impl: prefill_probe(torch, impl == "invariant") for impl in PROBE_IMPLS}
    (OUT / "prefill_probe.json").write_text(json.dumps(probes, indent=1))
    moved = sorted(op for op, by in probes["library"].items() if any(by.values()))
    log(f"[probe] under torch's products these move with the row count or "
        f"width: {moved}")
    for op, by in probes["invariant"].items():
        check(not any(by.values()), f"the paged prefill's {op} moves: {by}")
    if DEV == "cuda":
        torch.cuda.empty_cache()
    return probes


def prefill_probe(torch, invariant: bool):
    """Each operation of one Yi-9B prefill layer at full width (bf16,
    cordic_pallas), then the final norm and the logits, on one segment:
    alone, inside wider rows and as one row of a multi-row dispatch. Each
    operation takes the same bits for the segment's rows in every setup
    (the other rows random), so a difference is that operation's own.
    ``invariant`` runs the paged prefill's products (``cm.INVARIANT``),
    else torch's (``cm.LIBRARY``); the norms are torch's in both. Returns {op: {setup:
    max |difference| over the segment's outputs against alone}} (0.0:
    bit-equal) and logs one line an op."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.kernels import ops as kops
    from repro_torch.models import attention as attn
    from repro_torch.models import common as cm
    from repro_torch.models import transformer as tf

    ops = cm.INVARIANT if invariant else cm.LIBRARY
    base = configs.get_config("yi-9b", act_impl="cordic_pallas")
    cfg = dataclasses.replace(base, softmax_impl="cordic_pallas", num_layers=1,
                              block_pattern=base.block_pattern[:1])
    model = tf.init(cfg, seed=0, device=DEV)
    blk = model.blocks[0]
    H, KH = attn.padded_heads(cfg)
    G, hd, S, T = H // KH, cfg.head_dim, PROBE_SEG, PROBE_T
    gen = torch.Generator(device=DEV).manual_seed(11)
    setups = {"alone": (1, S, 0), **{f"W{w}": (1, w, 0) for w in PROBE_WIDE},
              f"R{PROBE_ROWS}": (PROBE_ROWS, S, 1)}

    def into(seg, R, W, row, axis):
        """A random (R, ...) tensor holding ``seg`` at [row], its ``axis``
        (of seg) widened to W with seg at [:S] (None: seg whole)."""
        shape = list(seg.shape)
        if axis is not None:
            shape[axis] = W
        full = torch.randn([R] + shape, generator=gen, device=DEV).to(seg.dtype)
        idx = [row] + [slice(None)] * len(shape)
        if axis is not None:
            idx[1 + axis] = slice(0, S)
        full[tuple(idx)] = seg
        return full

    def positions(R, W):
        return torch.arange(W, device=DEV)[None, :].expand(R, W)

    def masked_softmax(impl):
        def f(s, R, W):
            k_pos = torch.arange(T, device=DEV)
            q_pos = positions(R, W)
            mask = (k_pos[None, None, :] < W) & (k_pos[None, None, :] <= q_pos[:, :, None])
            s = torch.where(mask[:, None, None], s, torch.full_like(s, attn.NEG_INF))
            return attn._softmax_fn(impl)(s, axis=-1)
        return f

    def pool_round_trip(k, R, W):
        nb = R * T // BLOCK_LEN + 1
        pool = torch.zeros((nb, BLOCK_LEN) + tuple(k.shape[2:]), device=DEV)
        tables = (1 + torch.arange(R * T // BLOCK_LEN, device=DEV, dtype=torch.int32)
                  ).view(R, -1)
        attn._pool_write(pool, tables, torch.zeros(R, dtype=torch.int32, device=DEV), k)
        return attn._pool_gather(pool, tables)

    # the segment's own chain, alone: each op's segment input
    x0 = torch.randn((S, cfg.d_model), generator=gen, device=DEV).to(torch.bfloat16)
    scale = 1.0 / math.sqrt(hd)
    h = cm.rmsnorm(blk.ln1, x0[None], cfg.norm_eps)[0]
    q = attn._project(h[None], blk.attn.wq, ops)[0]
    k = attn._project(h[None], blk.attn.wk, ops)[0]
    v = attn._project(h[None], blk.attn.wv, ops)[0]
    qr = cm.apply_rope(q[None], positions(1, S), cfg.rope_theta)[0]
    kr = cm.apply_rope(k[None], positions(1, S), cfg.rope_theta)[0]
    k_tab = torch.zeros((T, KH, hd), device=DEV, dtype=torch.bfloat16)
    v_tab = torch.zeros_like(k_tab)
    k_tab[:S], v_tab[:S] = kr, v
    qg = qr.reshape(S, KH, G, hd)
    s = attn._scores(qg[None], k_tab[None], scale, cfg.score_dtype, ops)[0]
    p = masked_softmax(cfg.softmax_impl)(s[None], 1, S)[0]
    o = attn._pv(p[None], v_tab[None], cfg.score_dtype, ops)[0].to(torch.bfloat16)
    o = o.reshape(S, H, hd)
    x1 = x0 + attn._out_project(o[None], blk.attn.wo, ops)[0]
    h2 = cm.rmsnorm(blk.ln2, x1[None], cfg.norm_eps)[0]
    g = ops.matmul(h2, blk.mlp.w_gate.to(h2.dtype))
    u = ops.matmul(h2, blk.mlp.w_up.to(h2.dtype))
    hm = kops.silu_mul(g, u)
    x2 = x1 + ops.matmul(hm, blk.mlp.w_down.to(hm.dtype))

    # (name, f(*args, R, W), [(segment arg, its axis widened to W, or
    # None)], the segment's part of the output)
    def seg_rows(y, row):
        return y[row, :S]

    cases = [
        ("rmsnorm", lambda x, R, W: cm.rmsnorm(blk.ln1, x, cfg.norm_eps),
         [(x0, 0)], seg_rows),
        ("_project wq", lambda x, R, W: attn._project(x, blk.attn.wq, ops),
         [(h, 0)], seg_rows),
        ("_project wk", lambda x, R, W: attn._project(x, blk.attn.wk, ops),
         [(h, 0)], seg_rows),
        ("apply_rope", lambda x, R, W: cm.apply_rope(x, positions(R, W), cfg.rope_theta),
         [(q, 0)], seg_rows),
        ("pool write+gather", lambda x, R, W: pool_round_trip(x, R, W),
         [(kr, 0)], seg_rows),
        ("_scores", lambda q_, k_, R, W: attn._scores(q_, k_, scale, cfg.score_dtype, ops),
         [(qg, 0), (k_tab, None)], lambda y, row: y[row, :, :, :S, :S]),
        ("softmax cordic_pallas", masked_softmax("cordic_pallas"),
         [(s, 2)], lambda y, row: y[row, :, :, :S]),
        ("softmax exact", masked_softmax("exact"),
         [(s, 2)], lambda y, row: y[row, :, :, :S]),
        ("_pv", lambda p_, v_, R, W: attn._pv(p_, v_, cfg.score_dtype, ops),
         [(p, 2), (v_tab, None)], seg_rows),
        ("_out_project", lambda o_, R, W: attn._out_project(o_, blk.attn.wo, ops),
         [(o, 0)], seg_rows),
        ("mlp gate", lambda x, R, W: ops.matmul(x, blk.mlp.w_gate.to(x.dtype)),
         [(h2, 0)], seg_rows),
        ("silu_mul", lambda g_, u_, R, W: kops.silu_mul(g_, u_),
         [(g, 0), (u, 0)], seg_rows),
        ("mlp down", lambda x, R, W: ops.matmul(x, blk.mlp.w_down.to(x.dtype)),
         [(hm, 0)], seg_rows),
        ("final rmsnorm", lambda x, R, W: cm.rmsnorm(model.final_norm, x, cfg.norm_eps),
         [(x2, 0)], seg_rows),
        ("logits", lambda x, R, W: ops.unembed(model.lm_head, x),
         [(x2, 0)], seg_rows),
    ]
    moved = {}
    for name, f, args, take in cases:
        outs = {}
        for setup, (R, W, row) in setups.items():
            ins = [into(seg, R, W, row, ax) for seg, ax in args]
            outs[setup] = take(f(*ins, R, W), row).float()
            del ins
        ref = outs.pop("alone")
        moved[name] = {k: (0.0 if torch.equal(ref, y) else
                           float((ref - y).abs().nan_to_num(0.0).max()))
                       for k, y in outs.items()}
        log(f"[probe {'invariant' if invariant else 'library'}] {name}: " + ", ".join(
            f"{k} {'bit-equal' if e == 0.0 else f'moves (max |diff| {e:.3g})'}"
            for k, e in moved[name].items()))
        del outs, ref
        if DEV == "cuda":
            torch.cuda.empty_cache()
    del model
    return moved


KERNELS = {
    # name: (route, source, replaces)
    "act_2d": ("cuda", "src/repro_torch/kernels/csrc/act.cu",
               "src/repro/kernels/cordic_act.py:368"),
    "silu_mul_2d": ("cuda", "src/repro_torch/kernels/csrc/act.cu",
                    "src/repro/kernels/cordic_act.py:401"),
    "softmax_2d": ("cuda", "src/repro_torch/kernels/csrc/softmax.cu",
                   "src/repro/kernels/softmax_cordic.py:161"),
    "log_softmax_2d": ("cuda", "src/repro_torch/kernels/csrc/softmax.cu",
                       "src/repro/kernels/softmax_cordic.py:171"),
    "gqa_decode": ("cuda", "src/repro_torch/kernels/csrc/paged_decode.cu",
                   "src/repro/kernels/paged_attention.py:291"),
    "act_q_2d": ("cuda", "src/repro_torch/kernels/csrc/act.cu",
                 "src/repro/kernels/cordic_act.py:385"),
    "mla_decode": ("cuda", "src/repro_torch/kernels/csrc/paged_decode.cu",
                   "src/repro/kernels/paged_attention.py:421"),
    # port-only: the paged prefill's row-count-invariant products (ROADMAP
    # B.10), where the JAX package leaves its dots to XLA (e.g. the
    # projections of src/repro/models/attention.py:476)
    "gemm": ("cuda", "src/repro_torch/kernels/csrc/gemm.cu",
             "none: port-only, no Pallas counterpart (XLA's dots, "
             "src/repro/models/attention.py:476)"),
    # its bf16 route on the tensor cores (ROADMAP B.12)
    "gemm_tc": ("cuda", "src/repro_torch/kernels/csrc/gemm_tc.cu",
                "none: port-only, no Pallas counterpart (XLA's dots, "
                "src/repro/models/attention.py:476)"),
    # softmax_2d's split form (kv_shard="seq_model"): its three launches
    **{n: ("cuda", "src/repro_torch/kernels/csrc/softmax.cu",
           "src/repro/kernels/softmax_cordic.py:161") for n in SPLIT_LAUNCHES},
    # the branches ported after their kernels, each on its own path
    "act_2d[gelu_erf]": ("cuda", "src/repro_torch/kernels/csrc/act.cu",
                         "src/repro/kernels/cordic_act.py:368"),
    "gqa_decode[cordic_fixed]": ("cuda",
                                 "src/repro_torch/kernels/csrc/paged_decode.cu",
                                 "src/repro/kernels/paged_attention.py:291"),
    "mla_decode[cordic_fixed]": ("cuda",
                                 "src/repro_torch/kernels/csrc/paged_decode.cu",
                                 "src/repro/kernels/paged_attention.py:421"),
    # gqa_decode's kv_quant branch (_gqa_kernel :260-275)
    "gqa_decode[int8]": ("cuda", "src/repro_torch/kernels/csrc/paged_decode.cu",
                         "src/repro/kernels/paged_attention.py:291"),
    "gqa_decode[q2_14]": ("cuda", "src/repro_torch/kernels/csrc/paged_decode.cu",
                          "src/repro/kernels/paged_attention.py:291"),
}
# the query-head groups of the attention archs' decode shapes
# (attention_archs_path): qwen2.5-32b's 5, musicgen-large's 1 (MHA, hd 64)
# and internvl2-1b's 7 (hd 64)
for _g in GROUP_RECORDS.values():
    KERNELS[f"gqa_decode[{_g}]"] = KERNELS["gqa_decode"]
# the loss's log-softmax at each trained arch's vocabulary (vocab_log_softmax)
for _v in sorted(set(TRAIN_VOCABS.values())):
    KERNELS[f"log_softmax_2d[V{_v}]"] = KERNELS["log_softmax_2d"]
# the decode kernels at the long-context shape (long_decode_kernels)
for _name in ("gqa_decode[long]", "gqa_decode[cordic_fixed,long]",
              "gqa_decode[int8,long]", "gqa_decode[q2_14,long]"):
    KERNELS[_name] = KERNELS["gqa_decode"]
for _name in ("mla_decode[long]", "mla_decode[cordic_fixed,long]"):
    KERNELS[_name] = KERNELS["mla_decode"]


#: --row-kernels: each row kernel's output by record name (--save)
ROW_OUTPUTS = {}


def row_kernels(torch, card, records, ycfg, dcfg, ops):
    """--row-kernels: act_2d (each op at its main paths' shapes),
    silu_mul_2d, softmax_2d, log_softmax_2d and act_q_2d against their plain
    versions, device ms beside one PyTorch call's where there is one;
    inputs from their own generator (seed 0), so any tree sees the same
    ones. Only the wrappers every tree has are called, with the arguments
    every tree takes; a kernel is picked out of the profiler by a part of
    its name that every tree's kernel has. Each output's SHA-256 goes into
    its record, and outputs of up to 2^20 elements into ROW_OUTPUTS
    (--save)."""
    from repro_torch.kernels import cordic_act as K
    from repro_torch.kernels import softmax_cordic as SM

    dev = torch.device(DEV)
    gen = torch.Generator(device=dev).manual_seed(0)
    big = torch.randn(ycfg.d_model, ycfg.d_ff, generator=gen, device=dev) * 3
    train = torch.randn(TRAIN_BATCH * TRAIN_SEQ, ycfg.d_ff, generator=gen, device=dev) * 3
    moe = (torch.randn(SLOTS, dcfg.moe.num_experts, 4, dcfg.moe.d_ff_expert,
                       generator=gen, device=dev) * 3).bfloat16()
    gelu = lambda x: torch.nn.functional.gelu(x, approximate="none")  # noqa: E731
    acts = (("sigmoid", big, torch.sigmoid), ("gelu_erf", big, gelu),
            ("sigmoid_wide", (train / 10).bfloat16(), torch.sigmoid),
            ("sigmoid_wide", moe, torch.sigmoid), ("sigmoid", train[:, :1024].contiguous(), torch.sigmoid),
            ("exp", train, torch.exp), ("softplus", train, torch.nn.functional.softplus),
            ("elu", train, torch.nn.functional.elu), ("log", train.abs(), torch.log))
    for op, x, lib in acts:
        name = f"act_2d[{op},{'x'.join(map(str, x.shape))},{str(x.dtype)[6:]}]"
        a = K.act_2d(x, op)
        check(torch.equal(a, K.act_2d_plain(x, op)), f"{name} differs from its plain version")
        records[name] = dict(
            numel=x.numel(), sha256=keep_output(torch, name, a),
            ms=device_ms(torch, lambda: K.act_2d(x, op), kernel="act_kernel"),
            library_ms=device_ms(torch, lambda: lib(x)))
        log(f"[rows] {name}: {records[name]}")
    S, T = BLOCK_LEN, MAX_LEN
    s = torch.randn(ycfg.num_heads, S, T, generator=gen, device=dev) * 4
    qpos = torch.arange(S, device=dev)[:, None]
    kpos = torch.arange(T, device=dev)[None, :]
    s = torch.where((kpos <= qpos) & (kpos < 11), s, torch.full_like(s, -1e30))
    st = torch.randn(TRAIN_BATCH * ycfg.num_heads * TRAIN_SEQ, TRAIN_SEQ,
                     generator=gen, device=dev) * 4
    causal = torch.ones(TRAIN_SEQ, TRAIN_SEQ, dtype=torch.bool, device=dev).tril()
    st = torch.where(causal.repeat(st.shape[0] // TRAIN_SEQ, 1), st,
                     torch.full_like(st, -1e30))
    for x in (s.reshape(-1, T).contiguous(), st.contiguous(), long_softmax_rows(torch, gen)):
        name = f"softmax_2d[{'x'.join(map(str, x.shape))}]"
        a = SM.softmax_2d(x)
        check(torch.equal(a, SM.softmax_2d_plain(x)), f"{name} differs from its plain version")
        records[name] = dict(
            numel=x.numel(), sha256=keep_output(torch, name, a),
            ms=device_ms(torch, lambda: SM.softmax_2d(x), kernel="softmax_kernel"),
            library_ms=device_ms(torch, lambda: torch.softmax(x, dim=-1)))
        log(f"[rows] {name}: {records[name]}")
    z = torch.randn(TRAIN_BATCH * TRAIN_SEQ, ycfg.vocab_size, generator=gen, device=dev) * 3
    z[:8, -1000:] = -1e30
    z[8] = -1e30
    name = f"log_softmax_2d[{'x'.join(map(str, z.shape))}]"
    a = SM.log_softmax_2d(z)
    check(torch.equal(a, SM.log_softmax_2d_plain(z)), f"{name} differs from plain")
    records[name] = dict(
        numel=z.numel(), sha256=keep_output(torch, name, a),
        ms=device_ms(torch, lambda: SM.log_softmax_2d(z), kernel="log_softmax_"),
        library_ms=device_ms(torch, lambda: torch.log_softmax(z, dim=-1)))
    log(f"[rows] {name}: {records[name]}")
    # silu_mul_2d (the SwiGLU epilogue): Yi's decode, prefill and eval-step
    # rows and DeepSeek's dense FFN at decode, bfloat16
    for rows, F in ((SLOTS, ycfg.d_ff), (BLOCK_LEN, ycfg.d_ff),
                    (TRAIN_BATCH * TRAIN_SEQ, ycfg.d_ff), (SLOTS, dcfg.d_ff_dense)):
        g = (torch.randn(rows, F, generator=gen, device=dev) * 3).bfloat16()
        u = torch.randn(rows, F, generator=gen, device=dev).bfloat16()
        name = f"silu_mul_2d[{rows}x{F},bfloat16]"
        a = K.silu_mul_2d(g, u)
        check(torch.equal(a, K.silu_mul_2d_plain(g, u)), f"{name} differs from its plain version")
        records[name] = dict(
            numel=g.numel(), sha256=keep_output(torch, name, a),
            ms=device_ms(torch, lambda: K.silu_mul_2d(g, u), kernel="silu_mul_kernel"),
            library_ms=None)
        log(f"[rows] {name}: {records[name]}")
    # act_q_2d (the paper's integer datapath) on the sigmoid path's code map,
    # int16 and int32
    xq = sigmoid_q_map(torch, ycfg)
    for x in (xq, xq.to(torch.int32)):
        name = f"act_q_2d[{'x'.join(map(str, x.shape))},{str(x.dtype)[6:]}]"
        a = K.act_q_2d(x)
        check(torch.equal(a, K.act_q_2d_plain(x)), f"{name} differs from its plain version")
        records[name] = dict(
            numel=x.numel(), sha256=keep_output(torch, name, a),
            ms=device_ms(torch, lambda: K.act_q_2d(x), kernel="act_q_kernel"),
            library_ms=None)
        log(f"[rows] {name}: {records[name]}")


def keep_output(torch, name, t) -> str:
    """The SHA-256 of a kernel output's bytes; the output itself into
    ROW_OUTPUTS when it has at most 2^20 elements (--save stays small)."""
    import hashlib

    cpu = t.cpu().contiguous()
    if cpu.numel() <= 1 << 20:
        ROW_OUTPUTS[name] = cpu
    return hashlib.sha256(cpu.view(-1).view(torch.uint8).numpy()).hexdigest()


def tree_main(args) -> int:
    """--decode-kernels or --row-kernels: those kernels of the tree under
    ``args.src`` against their plain versions, timed; one JSON line to
    ``args.out``, the outputs to ``args.save``."""
    import torch

    src = Path(args.src).resolve()
    if not torch.cuda.is_available() or not (src / "repro_torch").is_dir():
        print(f"chip_smoke.py: no CUDA device, or no repro_torch under {src}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    from repro_torch import configs
    from repro_torch.cordic_engine.schedule import PAPER_SCHEDULE
    from repro_torch.kernels import build

    what = "decode_kernels" if args.decode_kernels else "row_kernels"
    OUT.mkdir(exist_ok=True)
    LOG_FILE.append(open(OUT / f"{what}_{args.label}.log", "w"))
    card_line = smi("name,power.limit")
    log(f"{card_line}; {what.replace('_', ' ')} of {src} ({args.label})")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = Card(torch)
    t0 = time.perf_counter()
    build.build_all()
    log(f"[build] {time.perf_counter() - t0:.1f} s")
    records = {}
    run, outputs = ((decode_kernels, DECODE_OUTPUTS) if args.decode_kernels
                    else (row_kernels, ROW_OUTPUTS))
    run(torch, card, records,
        configs.get_config("yi-9b", act_impl="cordic_pallas"),
        configs.get_config(DEEPSEEK, act_impl="cordic_pallas"),
        pipeline_ops(PAPER_SCHEDULE))
    line = json.dumps(dict(label=args.label, card=card_line, src=str(src),
                           records=records))
    log(line)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    if args.save:
        torch.save(outputs, args.save)
    return 0


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Drive the PyTorch/CUDA port on one GPU.")
    ap.add_argument("--decode-kernels", action="store_true",
                    help="only the decode kernels' checks and times")
    ap.add_argument("--row-kernels", action="store_true",
                    help="only act_2d's, silu_mul_2d's, softmax_2d's, "
                    "log_softmax_2d's and act_q_2d's checks and times")
    ap.add_argument("--archs", action="store_true",
                    help="only the build, the recurrent and attention archs' "
                    "paths and the train archs' (4j-4l), and their train identities")
    ap.add_argument("--tp", action="store_true",
                    help="only the build, Yi-9B's serve run with its profile and "
                    "cost line, and the tensor-parallel runs but DeepSeek's (4m)")
    ap.add_argument("--mesh-train", action="store_true",
                    help="only the build and the train step on a mesh (4n)")
    ap.add_argument("--mesh-train-witness", action="store_true",
                    help="only the build and the recurrent pair's mesh runs in "
                    "bfloat16, gates logged, with one rank's bfloat16 gradients "
                    "against float32's (the reading behind MESH_TRAIN_F32)")
    ap.add_argument("--c7", action="store_true",
                    help="only the build and xLSTM's and Zamba2's tp 2 runs in "
                    "bfloat16 and in float32 compute, each against its tp 1 "
                    "(ROADMAP C.7; tokens reported, not gated)")
    ap.add_argument("--prefill-probe", action="store_true",
                    help="only the build and phase (3d): the invariant product "
                    "against plain, timed, and ROADMAP B.10's probe (which "
                    "operations of a Yi-9B prefill layer change a segment's bits "
                    "with the row count and width, under torch's products and "
                    "under the paged prefill's)")
    ap.add_argument("--src", default=str(SRC),
                    help="the tree whose repro_torch --decode-kernels or "
                    "--row-kernels runs")
    ap.add_argument("--label", default="tree")
    ap.add_argument("--out", default=None, help="append the JSON line here")
    ap.add_argument("--save", default=None, help="torch.save the outputs here")
    args = ap.parse_args(argv)
    if args.decode_kernels or args.row_kernels:
        return tree_main(args)
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke.py: src/repro_torch not found next to this script; "
              "run it from a checkout of the repository", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import build

    t_start = time.perf_counter()
    OUT.mkdir(exist_ok=True)
    LOG_FILE.append(open(OUT / "chip_smoke.log", "w"))
    card_line = smi("name,power.limit")
    log(card_line)
    log(f"[device] python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[device] matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    card = Card(torch)
    c = kcost()
    log(f"[device] {card.sms} SMs x {c.INT32_LANES_PER_SM} INT32 lanes x "
        f"{card.clock_hz / 1e6:.0f} MHz = {card.int32_ops_s / 1e12:.2f} TOP/s "
        f"INT32; {c.HBM_BYTES_S / 1e12} TB/s HBM; {c.FP32_FLOP_S / 1e12} TFLOP/s FP32")

    t0 = time.perf_counter()
    build.build_all(verbose=True)
    log(f"[build] {len(build.SOURCES)} sources in {time.perf_counter() - t0:.1f} s")
    (OUT / "ptxas.log").write_text("\n".join(build.BUILD_LOG.values()))
    for name, text in build.BUILD_LOG.items():
        regs = sorted({ln.split("Used ")[1].split(" registers")[0]
                       for ln in text.splitlines() if "registers" in ln})
        log(f"[build] {name}.cu: registers per thread {regs}")

    from repro_torch import configs

    from repro_torch.cordic_engine.schedule import PAPER_SCHEDULE

    ycfg = configs.get_config("yi-9b", act_impl="cordic_pallas")
    dcfg = configs.get_config(DEEPSEEK, act_impl="cordic_pallas")
    records = {}
    phase_done("device and build")
    if args.tp:
        import dataclasses

        from repro_torch.models import transformer as tf

        cfg = dataclasses.replace(ycfg, softmax_impl="cordic_pallas")
        model = tf.init(cfg, seed=0, device=DEV)
        serve_run(torch, build, "yi-9b", cfg, model)
        del model
        torch.cuda.empty_cache()
        phase_done("path serve yi-9b (its main run)")
        tp_counts = tp_path(torch, build, {},
                            runs=[r for r in TP_RUNS if not r[0].startswith(DEEPSEEK)])
        phase_done("path tp")
        log(f"[tp] launches: {tp_counts}")
        log(f"[done] {time.perf_counter() - t_start:.1f} s")
        log(card_line)
        log(json.dumps({"archs": RESULTS}))
        return 0
    if args.c7:
        runs = [(a, 2) for a in RECURRENT_ARCHS] + list(C7_RUNS)
        tp_counts = tp_path(torch, build, {}, runs=runs)
        phase_done("path tp, C.7")
        log(f"[c7] launches: {tp_counts}")
        log(f"[done] {time.perf_counter() - t_start:.1f} s")
        log(card_line)
        log(json.dumps({"archs": RESULTS}))
        return 0
    if args.prefill_probe:
        invariant_phase(torch, records, ycfg, dcfg)
        phase_done("kernels (3d): the invariant product and the probe")
        log(f"[done] {time.perf_counter() - t_start:.1f} s")
        log(card_line)
        return 0
    if args.mesh_train_witness:
        failed = mesh_train_witness(torch, build)
        phase_done("mesh-train witness")
        log(f"[witness] {len(failed)} gates failed in bfloat16")
        log(json.dumps({"archs": RESULTS}))
        return 1 if failed else 0
    if args.mesh_train:
        mesh_counts = mesh_train_path(torch, build)
        phase_done("path mesh-train")
        log(f"[mesh-train] launches: {mesh_counts}")
        log(f"[done] {time.perf_counter() - t_start:.1f} s")
        log(card_line)
        log(json.dumps({"archs": RESULTS}))
        return 0
    if args.archs:
        rec_counts, att_counts, tr_counts = archs_paths(
            torch, build, card, records, pipeline_ops(PAPER_SCHEDULE))
        train_identity_phase(torch, TRAIN_ID_ARCHS[1:])
        phase_done("identity train archs")
        log(f"[archs] launches: recurrent {rec_counts}, attention {att_counts}, "
            f"train {tr_counts}")
        log(f"[done] {time.perf_counter() - t_start:.1f} s")
        log(card_line)
        log(json.dumps({"archs": RESULTS}))
        return 0
    kernel_phase(torch, card, records, ycfg, dcfg)
    phase_done("kernels")
    invariant_phase(torch, records, ycfg, dcfg)
    phase_done("kernels (3d): the invariant product and the probe")
    sigmoid_counts, gelu_counts = sigmoid_path(torch, build, ycfg)
    phase_done("path sigmoid")
    for k in ("act_2d", "act_q_2d"):
        check(sigmoid_counts.get(k, 0) > 0, f"the sigmoid path never launched {k}")
    check(gelu_counts.get("act_2d", 0) > 0, "the gelu_erf activation never launched act_2d")
    yi = serve_path(torch, build, "yi-9b")
    phase_done("path serve yi-9b")
    serve_counts, yi_fixed = yi["cordic_pallas"][0], yi["cordic_fixed"][0]
    for k in ("silu_mul_2d", "softmax_2d", "gqa_decode", "gemm", "gemm_tc"):
        check(serve_counts.get(k, 0) > 0, f"serving Yi-9B never launched {k}")
    for fmt in KV_FORMATS:
        for k in ("silu_mul_2d", "softmax_2d", "gqa_decode", "gemm", "gemm_tc"):
            check(yi[fmt][0].get(k, 0) > 0, f"serving Yi-9B on {fmt} pools never "
                  f"launched {k}")
    yi_chunked, yi_score = yi["chunked"]["trace 1, chunked"], yi["chunked"]["score cordic_pallas"]
    for k in ("silu_mul_2d", "softmax_2d", "gqa_decode", "gemm", "gemm_tc"):
        check(yi_chunked.get(k, 0) > 0, f"Yi-9B's chunked trace never launched {k}")
    yi_dense, yi_dense_long = yi["dense"]["launcher"], yi["dense"]["long"]
    for k in ("silu_mul_2d", "softmax_2d"):
        check(yi_dense.get(k, 0) > 0, f"Yi-9B's dense plane never launched {k}")
    for name in ("sampling", "obs"):
        for k in ("silu_mul_2d", "softmax_2d", "gqa_decode"):
            check(yi[name].get(k, 0) > 0, f"Yi-9B's {name} run never launched {k}")
    ds = serve_path(torch, build, DEEPSEEK)
    phase_done(f"path serve {DEEPSEEK}")
    ds_counts, ds_fixed = ds["cordic_pallas"][0], ds["cordic_fixed"][0]
    for k in ("mla_decode", "act_2d", "silu_mul_2d", "softmax_2d"):
        check(ds_counts.get(k, 0) > 0, f"serving DeepSeek-V2-Lite never launched {k}")
    check(ds_counts.get("gqa_decode", 0) == 0,
          "serving DeepSeek-V2-Lite launched the GQA decode kernel")
    # a MoE model's prefill keeps torch's products: its routing follows the
    # dispatch width, as in JAX
    for k in ("gemm", "gemm_tc"):
        check(ds_counts.get(k, 0) == 0, f"serving DeepSeek-V2-Lite launched {k}")
    ds_chunked = ds["chunked"]["chunked"]
    for k in ("mla_decode", "act_2d", "silu_mul_2d", "softmax_2d"):
        check(ds_chunked.get(k, 0) > 0, f"DeepSeek-V2-Lite's chunked trace never launched {k}")
    ds_dense = ds["dense"]["launcher"]
    for k in ("act_2d", "silu_mul_2d", "softmax_2d"):
        check(ds_dense.get(k, 0) > 0, f"DeepSeek-V2-Lite's dense plane never launched {k}")
    # the cordic_fixed datapath: the decode kernel's cordic_fixed branch on
    # every decode step; activations and the prefill softmax in plain torch
    check(yi_fixed.get("gqa_decode", 0) > 0, "Yi-9B cordic_fixed: no gqa_decode")
    check(ds_fixed.get("mla_decode", 0) > 0, "DeepSeek cordic_fixed: no mla_decode")
    for name, c in (("Yi-9B", yi_fixed), ("DeepSeek-V2-Lite", ds_fixed)):
        for k in ("act_2d", "silu_mul_2d", "softmax_2d"):
            check(c.get(k, 0) == 0, f"{name} cordic_fixed launched {k}")
    check(ds_fixed.get("gqa_decode", 0) == 0, "DeepSeek cordic_fixed launched gqa_decode")
    tp_counts = tp_path(torch, build, {DEEPSEEK: ds["cordic_pallas"][1]})
    for k in SPLIT_LAUNCHES:
        check(sum(c.get(k, 0) for run, ranks in tp_counts.items() if run[0].endswith(SEQ)
                  for c in ranks) > 0, f"the kv_shard=seq_model runs never launched {k}")
    phase_done("path tp")
    mesh_counts = mesh_train_path(torch, build)
    phase_done("path mesh-train")
    seq_counts = data_seq_path(torch, build)
    phase_done("path data-seq")
    rec_counts, att_counts, tr_counts = archs_paths(torch, build, card, records,
                                                    pipeline_ops(PAPER_SCHEDULE))
    train_counts, _ = train_path(torch, build)
    phase_done("path train")
    # launches of each kernel summed over the main paths' runs; a branch
    # (or qwen2.5-32b's group of 5) ported later counts on its own path
    paths = (sigmoid_counts, serve_counts, ds_counts, train_counts, yi_chunked, yi_score,
             ds_chunked, yi_dense, yi_dense_long, ds_dense,
             *(c["cordic_pallas"] for c in rec_counts.values()), *att_counts.values(),
             *tr_counts.values(), *(c for ranks in tp_counts.values() for c in ranks),
             *(c for ranks in mesh_counts.values() for c in ranks), *seq_counts)
    launches = {k: sum(c.get(k, 0) for c in paths) for k in KERNELS}
    for arch, g in GROUP_RECORDS.items():
        launches[f"gqa_decode[{g}]"] = att_counts[arch].get("gqa_decode", 0)
        launches["gqa_decode"] -= launches[f"gqa_decode[{g}]"]
    # the trained archs' loss launches, by vocabulary
    for V in set(TRAIN_VOCABS.values()):
        launches[f"log_softmax_2d[V{V}]"] = sum(
            tr_counts[a].get("log_softmax_2d", 0) for a, v in TRAIN_VOCABS.items() if v == V)
        launches["log_softmax_2d"] -= launches[f"log_softmax_2d[V{V}]"]
    launches["act_2d[gelu_erf]"] = gelu_counts.get("act_2d", 0)
    launches["gqa_decode[cordic_fixed]"] = yi_fixed.get("gqa_decode", 0)
    launches["mla_decode[cordic_fixed]"] = ds_fixed.get("mla_decode", 0)
    for fmt in KV_FORMATS:
        launches[f"gqa_decode[{fmt}]"] = yi[fmt][0].get("gqa_decode", 0)
    # long-shape entries: each from the long-context serve that runs its
    # branch at M 256 (max_len LONG_MAX_LEN)
    long_runs = {"gqa_decode[long]": (yi["long cordic_pallas"]["none"], "gqa_decode"),
                 "gqa_decode[cordic_fixed,long]": (yi["long cordic_fixed"]["none"],
                                                   "gqa_decode"),
                 "mla_decode[long]": (ds["long cordic_pallas"]["none"], "mla_decode"),
                 "mla_decode[cordic_fixed,long]": (ds["long cordic_fixed"]["none"],
                                                   "mla_decode")}
    for fmt in KV_FORMATS:
        long_runs[f"gqa_decode[{fmt},long]"] = (yi["long cordic_pallas"][fmt], "gqa_decode")
    for name, (counts, kernel) in long_runs.items():
        launches[name] = counts.get(kernel, 0)
        check(launches[name] > 0, f"the long-context serve of {name} never launched {kernel}")
    log(f"[paths] launches: sigmoid {sigmoid_counts}, gelu_erf {gelu_counts}, "
        f"serve yi-9b {serve_counts}, cordic_fixed {yi_fixed}, int8 "
        f"{yi['int8'][0]}, q2_14 {yi['q2_14'][0]}, serve {DEEPSEEK} "
        f"{ds_counts}, cordic_fixed {ds_fixed}, train loop {train_counts}, chunked "
        f"yi-9b {yi_chunked}, score {yi_score}, chunked {DEEPSEEK} {ds_chunked}, dense "
        f"yi-9b {yi_dense}, long {yi_dense_long}, dense {DEEPSEEK} {ds_dense}, sampling "
        f"yi-9b {yi['sampling']}, obs yi-9b {yi['obs']}, recurrent {rec_counts}, "
        f"attention archs {att_counts}, train archs {tr_counts}, tensor-parallel "
        f"ranks {tp_counts}, mesh-train ranks {mesh_counts}, data-seq ranks "
        f"{seq_counts}; per kernel {launches}")
    for arch in ("yi-9b", DEEPSEEK):
        for impl in ("cordic_pallas", "cordic_fixed"):
            identity_phase(torch, arch, impl)
            phase_done(f"identity {arch} {impl}")
    for fmt in KV_FORMATS:
        identity_phase(torch, "yi-9b", "cordic_pallas", kv_quant=fmt)
        phase_done(f"identity yi-9b kv_quant={fmt}")
    identity_phase(torch, "yi-9b", "cordic_pallas", kv_quant="int8", prefix_cache=True)
    phase_done("identity yi-9b int8 prefix cache")
    for arch in ("yi-9b", DEEPSEEK):
        chunked_identity_phase(torch, arch)
        phase_done(f"identity {arch} chunked")
        dense_identity_phase(torch, arch)
        phase_done(f"identity {arch} dense")
    train_identity_phase(torch)
    phase_done("identity train")

    kernels = []
    for name, (route, source, replaces) in KERNELS.items():
        r = records[name]
        kernels.append(dict(name=name, route=route, source=source,
                            replaces=replaces, launches=launches.get(name, 0),
                            max_abs_err=r["max_abs_err"], ms=r["ms"],
                            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                            bound_by=r["bound_by"], library_ms=r["library_ms"]))
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"archs": RESULTS}))
    log(card_line)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
