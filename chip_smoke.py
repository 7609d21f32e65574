#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which must pass (the script exits non-zero otherwise):

1. device   the card's name and power limit (nvidia-smi), torch / CUDA
            versions; TF32 off for float32 matrix products.
2. build    every CUDA kernel of the port from src/repro_torch/kernels/csrc,
            one nvcc per source, in parallel.
3. kernels  each kernel against its plain PyTorch version on the card, on
            the same inputs, at the shapes of the main paths: device time
            (torch.profiler) of the kernel, of the plain version, of one
            PyTorch library call that computes the same function where
            there is one, each beside its host-to-host time per call, and
            the least time the card could take (bound). The Q2.14 golden
            codes of sigmoid (float and integer paths), exp and log on the
            card.
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
            activation or softmax kernels); (d) training Yi-9B at full width cut to 4
            layers (float32 master weights, AdamW, the loop's 8 x 32-token
            batches): 8 loop steps with checkpoints, a bit-equal restore, 6
            steps on one batch (the loss must fall), an eval step. Every
            kernel of a path must have launched, and under grad the fused
            SwiGLU kernel must not (the JAX rule's primal).
5. identity the Yi and DeepSeek-V2-Lite smoke configs in float32, on both
            datapaths: tokens served on the card with the kernels equal the
            CPU's tokens with the plain versions, and 5 Yi train steps' losses on the card
            agree with the CPU's.

The line before the last holds {"kernels": [...]} (one entry per kernel:
launches on its path, max error against plain, times, bound); the last line
is {"ok": true, "device": {...}}. Without a CUDA device, or run from a
directory without the repository's src/, the script exits with an error and
prints no result.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
OUT = ROOT / "chiprun_out"

#: H100 SXM published rates (NVIDIA data sheet): HBM3 bytes/s, FP32 FLOP/s
#: outside the tensor cores. The INT32 rate is derived from the card
#: (SMs x 64 INT32 lanes x max SM clock).
HBM_BYTES_S = 3.35e12
FP32_FLOP_S = 67e12
INT32_LANES_PER_SM = 64

#: the device every phase runs on
DEV = "cuda"

#: serving shapes of the main paths (launch/serve.py traffic), both archs
SLOTS, MAX_NEW, MAX_LEN, BLOCK_LEN, REQUESTS = 4, 16, 128, 16, 8
#: the MLA/MoE arch served at full width
DEEPSEEK = "deepseek-v2-lite-16b"
#: the train path: Yi-9B widths, depth cut to fit one card with float32
#: master weights and AdamW moments (16 B per parameter); the loop's batches
TRAIN_LAYERS, TRAIN_BATCH, TRAIN_SEQ = 4, 8, 32
#: the fixed-batch descent check: steps and learning rate
DESCENT_STEPS, DESCENT_LR = 6, 1e-4


def log(msg: str) -> None:
    print(msg, flush=True)


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
# Operation counts of the integer pipeline, from the schedule: the least
# INT32 work a stage needs, one operation per shift, compare, select,
# add/sub and 16-bit wrap (a sign extension), with a conditional add or
# subtract counted as a select of the operand's sign plus an add
# ---------------------------------------------------------------------------
def pipeline_ops(sched):
    from repro_torch.kernels.cordic_act import _HYP_VEC_JS as HYP_VEC_JS

    wrap, cadd = 1, 2
    r2 = 1 + 2 + 3 * (cadd + wrap)                 # sign, xs/ys, x/y/z: 12
    r4 = 1 + 3 + 2 * (1 + 2 + cadd + wrap) + (2 + cadd + wrap)   # 21
    lvc = 1 + 1 + 2 * (cadd + wrap)                # sign, xs, y/t: 8
    rot = len(sched.r2_js) * r2 + len(sched.r4_js) * r4
    div = len(sched.lvc_js) * lvc
    boundary = 7 + 2 + 5 + 2     # quantize, input shr, 1/2 + t/2, dequantize
    exp_codes = rot + 7 + 2      # quantize r, rotation, c + s
    normalize = div + 2 + 4      # LVC divide and its boundary ops
    return {"sigmoid": rot + div + boundary,
            # act_q_2d: integer codes in and out, no quantize/dequantize
            "sigmoid_q": rot + div + 2 + 5,
            "wide": rot + div + boundary + 6 + 2,  # doubling count, 2^-k
            # log_softmax_2d: one rotation per live lane and its add into
            # the row sum; the vectoring log runs once per row
            "log_softmax_lane": exp_codes + 1,
            "log_row": len(HYP_VEC_JS) * r2 + 7 + 7 + 8,
            # softmax_2d: one rotation per lane, since the function it
            # replaces keeps each lane's e^r codes for the divide (the CUDA
            # kernel recomputes them, which is its own cost, not the work's)
            "softmax_lane": exp_codes + normalize,
            # gqa_decode / mla_decode cordic: the TPU kernels' sum and
            # normalize passes each rotate (_lane_exp, _lane_probs), since
            # the pool blocks are walked again rather than the codes kept,
            # so the work they replace rotates twice per lane
            "decode_lane": 2 * exp_codes + normalize,
            # act_2d gelu_erf: one e^r rotation with its dyadic boundary
            # (the erf prefactor, sqrt and GELU product are float work)
            "gelu_erf": exp_codes + 4}


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


def device_ms(torch, fn, iters: int = 20, warmup: int = 2,
              kernel: str | None = None) -> float:
    """Device time of one call: the summed durations of the device kernels
    that ``iters`` calls launch (torch.profiler's CUDA activity) over
    ``iters``. ``kernel`` keeps only the kernels whose name holds it (a
    wrapper's own kernel); None keeps all (a plain version, a library call).
    Host dispatch and the gaps between launches are outside it, unless the
    profiler records no device time three times running: then CUDA events
    time the calls, gaps included, and a log line says so."""
    if DEV != "cuda":                       # rehearsal on the CPU
        return host_ms(torch, fn, iters, warmup)
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    # the profiler now and then records no device activity for a window;
    # profile again, then fall back to CUDA events, which also count the
    # host's gaps between launches
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total_us = 0.0
        for ev in prof.key_averages():
            if "CUDA" not in str(getattr(ev, "device_type", "")):
                continue
            if kernel is None or kernel in ev.key:
                total_us += getattr(ev, "self_device_time_total", 0.0)
        if total_us > 0:
            return total_us / 1e3 / iters
        log(f"[timing] the profiler saw no device time for {kernel or 'fn'} "
            f"(attempt {attempt + 1} of 3)")
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / iters
    check(ms > 0, f"no device time for {kernel or 'fn'}")
    log(f"[timing] {kernel or 'fn'}: {ms:.4f} ms per call from CUDA events "
        "(host gaps between launches included)")
    return ms


def times(torch, fn, kernel=None, iters: int = 20, warmup: int = 2):
    """(device ms, host-to-host ms) of one call."""
    return (device_ms(torch, fn, iters, warmup, kernel),
            host_ms(torch, fn, iters, warmup))


class Card:
    def __init__(self, torch):
        props = torch.cuda.get_device_properties(0)
        self.sms = props.multi_processor_count
        self.clock_hz = float(smi("clocks.max.sm").split()[0]) * 1e6
        self.int32_ops_s = self.sms * INT32_LANES_PER_SM * self.clock_hz

    def bound(self, nbytes: float, int_ops: float = 0.0, flops: float = 0.0):
        times = {"bytes": nbytes / HBM_BYTES_S,
                 "operations": max(int_ops / self.int32_ops_s,
                                   flops / FP32_FLOP_S)}
        by = max(times, key=times.get)
        return times[by] * 1e3, by


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------
def kernel_phase(torch, card, records, ycfg, dcfg):
    import numpy as np

    from repro_torch.cordic_engine.schedule import PAPER_SCHEDULE
    from repro_torch.kernels import cordic_act as K
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.kernels import softmax_cordic as SM

    ops = pipeline_ops(PAPER_SCHEDULE)
    dev = torch.device(DEV)
    gen = torch.Generator(device=dev).manual_seed(0)

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
    err = float((a - b).abs().max())
    check(torch.equal(a, b), "act_2d differs from its plain version")
    n = big.numel()
    bound, by = card.bound(8 * n, ops["sigmoid"] * n)
    records["act_2d"] = timed(
        dict(shape=list(big.shape), dtype="float32", max_abs_err=err,
             bound_ms=bound, bound_by=by),
        kernel=times(torch, lambda: K.act_2d(big, "sigmoid"), "act_kernel"),
        plain=times(torch, lambda: K.act_2d_plain(big, "sigmoid"), None, 3, 1),
        library=times(torch, lambda: torch.sigmoid(big)))

    # (2) silu_mul_2d at the decode (4 x d_ff), prefill (16 x d_ff) and
    # eval-step (B*S x d_ff = 256 x d_ff) shapes, bfloat16, bit-exact
    F = ycfg.d_ff
    for name, rows in (("decode", SLOTS), ("prefill", BLOCK_LEN),
                       ("eval step", TRAIN_BATCH * TRAIN_SEQ)):
        g = (torch.randn(rows, 1, F, generator=gen, device=dev) * 3).bfloat16()
        u = torch.randn(rows, 1, F, generator=gen, device=dev).bfloat16()
        a = K.silu_mul_2d(g.view(-1), u.view(-1))
        b = K.silu_mul_2d_plain(g.view(-1), u.view(-1))
        check(torch.equal(a, b), f"silu_mul_2d ({name}) differs from plain")
        n = g.numel()
        bound, by = card.bound(6 * n, ops["wide"] * n)
        rec = timed(
            dict(shape=[rows, F], dtype="bfloat16",
                 max_abs_err=float((a.float() - b.float()).abs().max()),
                 bound_ms=bound, bound_by=by),
            kernel=times(torch, lambda: K.silu_mul_2d(g.view(-1), u.view(-1)),
                         "silu_mul_kernel"),
            plain=times(torch, lambda: K.silu_mul_2d_plain(
                g.view(-1), u.view(-1)), None, 5, 1))
        log(f"[silu_mul_2d] {name} {rec['shape']} bf16: bit-exact; "
            f"{fmt_times(rec)}")
        if name == "decode":
            records["silu_mul_2d"] = rec

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
    # stated tolerance: same left-to-right row sum on both sides, so equal;
    # at most one Q2.14 code step (3.5e-4 of the lane) is accepted
    check(bool(((a - b).abs() <= 3.5e-4 * b.abs()).all()), "softmax_2d")
    check(bool(((a == 0) == (b == 0)).all()), "softmax_2d dead lanes")
    live = int((s > -1e29).sum())
    bound, by = card.bound(8 * s.numel(), ops["softmax_lane"] * live)
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
    check(bool(((a - b).abs() <= 3.5e-4 * b.abs()).all()), "softmax_2d (train)")
    check(bool(((a == 0) == (b == 0)).all()), "softmax_2d (train) dead lanes")
    live = int((st > -1e29).sum())
    bound, by = card.bound(8 * st.numel(), ops["softmax_lane"] * live)
    rec = timed(
        dict(shape=list(st.shape), max_abs_err=float((a - b).abs().max()),
             bit_equal=bool(torch.equal(a, b)), bound_ms=bound, bound_by=by),
        kernel=times(torch, lambda: SM.softmax_2d(st), "softmax_kernel"),
        plain=times(torch, lambda: SM.softmax_2d_plain(st), None, 3, 1),
        library=times(torch, lambda: torch.softmax(st, dim=-1)))
    log(f"[softmax_2d] train attend {rec['shape']} causal: max |kernel - plain| "
        f"{rec['max_abs_err']:.3e} (bit-equal {rec['bit_equal']}); {fmt_times(rec)}")

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
    for impl in ("cordic_pallas", "exact", "cordic_fixed"):
        a = PA.gqa_decode(q, kp, vp, tables, k_len, softmax_impl=impl, **kw)
        b = PA.gqa_decode_plain(q, kp, vp, tables, k_len, softmax_impl=impl, **kw)
        err = float((a - b).abs().max())
        # stated tolerance: the reference's own ATOL 2e-5 and argmax
        # identity; cordic_fixed (one summation order, the library's lanes
        # replayed in the kernel) must be bit-equal
        check(bool(torch.isfinite(a).all()) and err < 2e-5,
              f"gqa_decode {impl}: |kernel - plain| {err} (ATOL 2e-5)")
        check(impl != "cordic_fixed" or err == 0.0,
              f"gqa_decode cordic_fixed: |kernel - plain| {err} (bit-equal)")
        check(torch.equal(a.reshape(B, -1).argmax(-1), b.reshape(B, -1).argmax(-1)),
              f"gqa_decode {impl}: argmax moved against plain")
        nbytes = (q.numel() * 2 + 2 * live_blocks * L * KH * hd * 4
                  + tables.numel() * 4 + k_len.numel() * 4 + a.numel() * 4)
        lanes = live_keys * KH * G
        int_ops = (ops["decode_lane"] if impl != "exact" else 0) * lanes
        bound, by = card.bound(nbytes, int_ops, 4 * hd * lanes)
        rec = timed(
            dict(shape=[B, KH, G, hd, L, M], impl=impl, klens=klens,
                 max_abs_err=err, bit_equal=bool(torch.equal(a, b)),
                 bound_ms=bound, bound_by=by),
            kernel=times(torch, lambda: PA.gqa_decode(
                q, kp, vp, tables, k_len, softmax_impl=impl, **kw),
                "gqa_decode_kernel"),
            plain=times(torch, lambda: PA.gqa_decode_plain(
                q, kp, vp, tables, k_len, softmax_impl=impl, **kw), None, 2, 1))
        log(f"[gqa_decode] {impl} B={B} KH={KH} G={G} hd={hd} L={L} M={M} "
            f"k_len={[max(k, 1) for k in klens]}: max |kernel - plain| {err:.3e} "
            f"(bit-equal {rec['bit_equal']}); {fmt_times(rec)}")
        if impl == "cordic_pallas":
            records["gqa_decode"] = rec
        elif impl == "cordic_fixed":
            records["gqa_decode[cordic_fixed]"] = rec
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
    live = int((z - z.amax(-1, keepdim=True) >= -20.0).sum())
    bound, by = card.bound(8 * z.numel(), ops["log_softmax_lane"] * live
                           + ops["log_row"] * rows, 3 * z.numel())
    records["log_softmax_2d"] = timed(
        dict(shape=list(z.shape), dtype="float32", max_abs_err=err,
             bound_ms=bound, bound_by=by),
        kernel=times(torch, lambda: SM.log_softmax_2d(z), "log_softmax_rows_kernel"),
        plain=times(torch, lambda: SM.log_softmax_2d_plain(z), None, 3, 1),
        library=times(torch, lambda: torch.log_softmax(z, dim=-1)))
    del z, a, b

    # (6) act_2d exp, log, softplus, elu at the train path's MLP shape
    # (B*S, d_ff) = (256, 11008), float32 and bfloat16, bit-exact
    xa = torch.randn(rows, ycfg.d_ff, generator=gen, device=dev) * 30
    xa.view(-1)[:12] = torch.tensor([0.0, -0.0, 80, -80, 85, -85, 1e-30, 1e30,
                                     3e38, 88, -103, 0.693], device=dev)
    for op in ("exp", "log", "softplus", "elu"):
        xin = xa.abs() if op == "log" else xa
        for dt in (torch.float32, torch.bfloat16):
            check(torch.equal(K.act_2d(xin.to(dt), op), K.act_2d_plain(xin.to(dt), op)),
                  f"act_2d {op} {dt} differs from its plain version")
    log(f"[act_2d] exp, log, softplus, elu at {list(xa.shape)} float32 and "
        "bfloat16: bit-exact against plain")
    # the train step's launch: sigmoid_wide of the SwiGLU gate, bfloat16
    xg = (xa / 10).bfloat16()
    check(torch.equal(K.act_2d(xg, "sigmoid_wide"), K.act_2d_plain(xg, "sigmoid_wide")),
          "act_2d sigmoid_wide differs from its plain version")
    bound, by = card.bound(4 * xg.numel(), ops["wide"] * xg.numel())
    rec = timed(dict(shape=list(xg.shape), bound_ms=bound, bound_by=by),
                kernel=times(torch, lambda: K.act_2d(xg, "sigmoid_wide"), "act_kernel"),
                plain=times(torch, lambda: K.act_2d_plain(xg, "sigmoid_wide"), None, 3, 1),
                library=times(torch, lambda: torch.sigmoid(xg)))
    log(f"[act_2d] sigmoid_wide {rec['shape']} bf16 (a train step's launch): "
        f"{fmt_times(rec)}")

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

    # (8) act_q_2d: all 2^16 Q2.14 codes, int16 and int32, against the
    # golden file and the plain version; timed on the sigmoid path's
    # (d_model, d_ff) = (4096, 11008) int16 code map
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
    xq = sigmoid_q_map(torch, ycfg)
    a, b = K.act_q_2d(xq), K.act_q_2d_plain(xq)
    check(torch.equal(a, b), "act_q_2d differs from its plain version")
    n = xq.numel()
    bound, by = card.bound(4 * n, ops["sigmoid_q"] * n)
    records["act_q_2d"] = timed(
        dict(shape=list(xq.shape), dtype="int16",
             max_abs_err=float((a.long() - b.long()).abs().max()),
             bound_ms=bound, bound_by=by),
        kernel=times(torch, lambda: K.act_q_2d(xq), "act_q_kernel"),
        plain=times(torch, lambda: K.act_q_2d_plain(xq), None, 3, 1))

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
    for impl in ("cordic_pallas", "exact", "cordic_fixed"):
        a = PA.mla_decode(*args, softmax_impl=impl, **kw)
        b = PA.mla_decode_plain(*args, softmax_impl=impl, **kw)
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
        rec = timed(
            dict(shape=[B, H, R, P, L, M], impl=impl, klens=klens,
                 max_abs_err=err, bit_equal=bool(torch.equal(a, b)),
                 bound_ms=bound, bound_by=by),
            kernel=times(torch, lambda: PA.mla_decode(*args, softmax_impl=impl, **kw),
                         "mla_decode_kernel"),
            plain=times(torch, lambda: PA.mla_decode_plain(
                *args, softmax_impl=impl, **kw), None, 2, 1))
        log(f"[mla_decode] {impl} B={B} H={H} R={R} P={P} L={L} M={M} "
            f"k_len={[max(k, 1) for k in klens]}: max |kernel - plain| {err:.3e} "
            f"(bit-equal {rec['bit_equal']}); {fmt_times(rec)}")
        if impl == "cordic_pallas":
            records["mla_decode"] = rec
        elif impl == "cordic_fixed":
            records["mla_decode[cordic_fixed]"] = rec

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
    bound, by = card.bound(4 * n, ops["wide"] * n)
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
    check(bool(((a - b).abs() <= 3.5e-4 * b.abs()).all()) and
          bool(((a == 0) == (b == 0)).all()), "softmax_2d (MLA prefill)")
    log(f"[deepseek shapes] silu_mul_2d {list(g.shape)} bf16 bit-exact; "
        f"softmax_2d {list(sd.shape)} max |kernel - plain| "
        f"{float((a - b).abs().max()):.3e} (bit-equal {bool(torch.equal(a, b))})")

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
    bound, by = card.bound(8 * n, ops["gelu_erf"] * n, 16 * n)
    records["act_2d[gelu_erf]"] = timed(
        dict(shape=list(xe.shape), dtype="float32", max_abs_err=max(errs),
             bound_ms=bound, bound_by=by),
        kernel=times(torch, lambda: K.act_2d(xe, "gelu_erf"), "act_kernel"),
        plain=times(torch, lambda: K.act_2d_plain(xe, "gelu_erf"), None, 3, 1),
        library=times(torch, lambda: torch.nn.functional.gelu(xe, approximate="none")))
    log(f"[act_2d] gelu_erf {list(xe.shape)} float32 and bfloat16: bit-exact "
        "against plain")

    for name in ("act_2d", "softmax_2d", "log_softmax_2d", "act_q_2d",
                 "act_2d[gelu_erf]"):
        r = records[name]
        log(f"[{name}] {r['shape']}: max |kernel - plain| {r['max_abs_err']:.3e}; "
            f"{fmt_times(r)}")


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
    return (f"device {r['ms']:.4f} ms per call (host-to-host {r['host_ms']:.4f} "
            f"ms); plain {r['plain_ms']:.4f} ms (host {r['plain_host_ms']:.2f})"
            f"{lib}; bound {r['bound_ms']:.5f} ms by {r['bound_by']}")


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


def serve_path(torch, build, arch):
    """An arch at full width through ServeEngine: paged KV, decode kernel,
    greedy, the launcher's traffic; served once per datapath of
    SERVE_IMPLS on one model (the weights do not depend on the datapath).
    Returns {act_impl: (launch counts, stats)}."""
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
        t0 = time.perf_counter()
        out[act_impl] = serve_run(torch, build, arch, cfg, model)
        log(f"[time] serve {arch} {act_impl}: {time.perf_counter() - t0:.1f} s "
            "(warm-up, traffic, logits check, profile)")
    del model
    torch.cuda.empty_cache()
    return out


def serve_run(torch, build, arch, cfg, model):
    """The launcher's traffic through one engine, launch counts zeroed just
    before and read just after; step times, TTFT, memory, a profile."""
    from repro_torch.launch.serve import make_requests
    from repro_torch.models import transformer as tf
    from repro_torch.serve.engine import ServeEngine

    tag = f"[path serve {arch} {cfg.act_impl}/{cfg.softmax_impl}]"
    eng = ServeEngine(cfg, model, slots=SLOTS, max_len=MAX_LEN, kv_impl="paged",
                      block_len=BLOCK_LEN, paged_attend_impl="pallas",
                      device=DEV)
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
    stats = dict(requests=len(done), tokens=n_tok, wall_s=wall,
                 tok_s=n_tok / wall, ttft_ms_p50=statistics.median(ttft),
                 ttft_ms_max=ttft[-1], step_ms_p50=statistics.median(steps) * 1e3,
                 steps=len(steps), peak_gib=peak / 2**30,
                 pool_gib=eng.kv_pool_bytes() / 2**30, launches=counts)
    log(f"{tag} {len(done)} requests, {n_tok} tokens in {wall:.3f} s: "
        f"{stats['tok_s']:.1f} tok/s; TTFT p50 {stats['ttft_ms_p50']:.1f} ms, "
        f"max {stats['ttft_ms_max']:.1f} ms; step p50 {stats['step_ms_p50']:.2f} "
        f"ms over {len(steps)} steps; peak memory {stats['peak_gib']:.2f} GiB "
        f"(pools {stats['pool_gib']:.3f} GiB); launches {counts}")
    log(f"{tag} clocks/power after serving: "
        f"{smi('clocks.sm,power.draw,power.limit,temperature.gpu')}")
    log(f"{tag} tokens " + json.dumps({r.rid: r.out for r in done}))
    # the plain datapath issues ~40,000 launches a step; the profiler's
    # bookkeeping of them is slow, so it profiles fewer steps
    t0 = time.perf_counter()
    n_prof = 6 if cfg.act_impl == "cordic_pallas" else 2
    stats["profile"] = profile_steps(torch, eng, cfg, SERVE_PROFILE[arch], n_prof)
    log(f"[time] {tag} profile of {n_prof} steps: {time.perf_counter() - t0:.1f} s")
    del eng, logits
    torch.cuda.empty_cache()
    return counts, stats


def profile_steps(torch, eng, cfg, kernels, n_steps: int = 6):
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

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
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
                               "log_softmax_rows_kernel", "gemm"))
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
# Phase 5: identity on the smoke config
# ---------------------------------------------------------------------------
def identity_phase(torch, arch, impl):
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
    out = {}
    for dev, model in (("cpu", cpu_model), (DEV, gpu_model)):
        eng = ServeEngine(cfg, model, slots=2, max_len=64, kv_impl="paged",
                          paged_attend_impl="pallas", device=dev)
        for r in make_requests(cfg, 3, 8, seed=0):
            eng.submit(r)
        out[dev] = {r.rid: r.out for r in eng.run()}
    log(f"[identity] {cfg.name} float32 {impl}, 3 requests x 8 tokens: card "
        f"(kernels) {out[DEV]} vs CPU (plain) {out['cpu']}")
    check(out[DEV] == out["cpu"], "card tokens differ from the CPU run")


#: train identity tolerance, card against CPU. The kernels equal the plain
#: versions bit for bit, so only the matmuls' summation order differs; on
#: an H100 (torch 2.11, CUDA 12.8) the losses agreed to 7.6e-8 at step 0
#: (one float32 ulp) and 1.6e-6 after. The bounds are about ten times
#: that. The recipe can amplify an ulp: JAX against itself with its
#: weights nudged one ulp spreads by up to 9e-5 (tests/test_torch_train.py)
TRAIN_ID_RTOL = (1e-6, 2e-5)          # step 0, later steps


def train_identity_phase(torch):
    """The Yi smoke config in float32, 5 steps (lr 1e-2, warmup 2, total 5,
    batch_at(0)) from the same weights: on the card with the kernels and
    on the CPU with the plain versions."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.data.pipeline import DataConfig, SyntheticLMDataset
    from repro_torch.models import transformer as tf
    from repro_torch.optim import adamw
    from repro_torch.train import loop as loop_lib
    from repro_torch.train import step as step_lib

    cfg = dataclasses.replace(configs.get_smoke("yi-9b", act_impl="cordic_pallas"),
                              softmax_impl="cordic_pallas", loss_impl="cordic_pallas")
    batch = SyntheticLMDataset(DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                          global_batch=8, seed=0)).batch_at(0)
    init = tf.init(cfg, 0, "cpu", dtype=torch.float32).state_dict()
    losses = {}
    for dev in ("cpu", DEV):
        params = tf.Transformer(cfg, device=torch.device(dev), dtype=torch.float32)
        params.load_state_dict(init)
        state = step_lib.TrainState(
            params, adamw.init(step_lib.named_params(params)), None)
        train_step = step_lib.make_train_step(
            cfg, adamw.AdamWConfig(lr=1e-2), warmup_steps=2, total_steps=5)
        b = loop_lib.to_device(batch, dev)
        losses[dev] = []
        for _ in range(5):
            state, m = train_step(state, b)
            losses[dev].append(m["loss"].item())
    rel = [abs(a - c) / abs(c) for a, c in zip(losses[DEV], losses["cpu"])]
    log(f"[identity] {cfg.name} float32 train, 5 steps: card (kernels) "
        f"{losses[DEV]} vs CPU (plain) {losses['cpu']}; relative differences "
        f"{[f'{r:.2e}' for r in rel]} (tolerance {TRAIN_ID_RTOL[0]} at step 0, "
        f"{TRAIN_ID_RTOL[1]} after)")
    check(rel[0] <= TRAIN_ID_RTOL[0] and max(rel[1:]) <= TRAIN_ID_RTOL[1],
          "card train losses differ from the CPU run")


# ---------------------------------------------------------------------------
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
    # the branches ported after their kernels, each on its own path
    "act_2d[gelu_erf]": ("cuda", "src/repro_torch/kernels/csrc/act.cu",
                         "src/repro/kernels/cordic_act.py:368"),
    "gqa_decode[cordic_fixed]": ("cuda",
                                 "src/repro_torch/kernels/csrc/paged_decode.cu",
                                 "src/repro/kernels/paged_attention.py:291"),
    "mla_decode[cordic_fixed]": ("cuda",
                                 "src/repro_torch/kernels/csrc/paged_decode.cu",
                                 "src/repro/kernels/paged_attention.py:421"),
}


def main() -> int:
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
    log(f"[device] {card.sms} SMs x {INT32_LANES_PER_SM} INT32 lanes x "
        f"{card.clock_hz / 1e6:.0f} MHz = {card.int32_ops_s / 1e12:.2f} TOP/s "
        f"INT32; {HBM_BYTES_S / 1e12} TB/s HBM; {FP32_FLOP_S / 1e12} TFLOP/s FP32")

    t0 = time.perf_counter()
    build.build_all(verbose=True)
    log(f"[build] {len(build.SOURCES)} sources in {time.perf_counter() - t0:.1f} s")
    OUT.mkdir(exist_ok=True)
    (OUT / "ptxas.log").write_text("\n".join(build.BUILD_LOG.values()))
    for name, text in build.BUILD_LOG.items():
        regs = sorted({ln.split("Used ")[1].split(" registers")[0]
                       for ln in text.splitlines() if "registers" in ln})
        log(f"[build] {name}.cu: registers per thread {regs}")

    from repro_torch import configs

    ycfg = configs.get_config("yi-9b", act_impl="cordic_pallas")
    dcfg = configs.get_config(DEEPSEEK, act_impl="cordic_pallas")
    records = {}
    phase_done("device and build")
    kernel_phase(torch, card, records, ycfg, dcfg)
    phase_done("kernels")
    sigmoid_counts, gelu_counts = sigmoid_path(torch, build, ycfg)
    phase_done("path sigmoid")
    for k in ("act_2d", "act_q_2d"):
        check(sigmoid_counts.get(k, 0) > 0, f"the sigmoid path never launched {k}")
    check(gelu_counts.get("act_2d", 0) > 0, "the gelu_erf activation never launched act_2d")
    yi = serve_path(torch, build, "yi-9b")
    phase_done("path serve yi-9b")
    serve_counts, yi_fixed = yi["cordic_pallas"][0], yi["cordic_fixed"][0]
    for k in ("silu_mul_2d", "softmax_2d", "gqa_decode"):
        check(serve_counts.get(k, 0) > 0, f"serving Yi-9B never launched {k}")
    ds = serve_path(torch, build, DEEPSEEK)
    phase_done(f"path serve {DEEPSEEK}")
    ds_counts, ds_fixed = ds["cordic_pallas"][0], ds["cordic_fixed"][0]
    for k in ("mla_decode", "act_2d", "silu_mul_2d", "softmax_2d"):
        check(ds_counts.get(k, 0) > 0, f"serving DeepSeek-V2-Lite never launched {k}")
    check(ds_counts.get("gqa_decode", 0) == 0,
          "serving DeepSeek-V2-Lite launched the GQA decode kernel")
    # the cordic_fixed datapath: the decode kernel's cordic_fixed branch on
    # every decode step; activations and the prefill softmax in plain torch
    check(yi_fixed.get("gqa_decode", 0) > 0, "Yi-9B cordic_fixed: no gqa_decode")
    check(ds_fixed.get("mla_decode", 0) > 0, "DeepSeek cordic_fixed: no mla_decode")
    for name, c in (("Yi-9B", yi_fixed), ("DeepSeek-V2-Lite", ds_fixed)):
        for k in ("act_2d", "silu_mul_2d", "softmax_2d"):
            check(c.get(k, 0) == 0, f"{name} cordic_fixed launched {k}")
    check(ds_fixed.get("gqa_decode", 0) == 0, "DeepSeek cordic_fixed launched gqa_decode")
    train_counts, _ = train_path(torch, build)
    phase_done("path train")
    # launches of each kernel summed over the main paths' runs; a branch
    # ported later counts on its own path
    paths = (sigmoid_counts, serve_counts, ds_counts, train_counts)
    launches = {k: sum(c.get(k, 0) for c in paths) for k in KERNELS}
    launches["act_2d[gelu_erf]"] = gelu_counts.get("act_2d", 0)
    launches["gqa_decode[cordic_fixed]"] = yi_fixed.get("gqa_decode", 0)
    launches["mla_decode[cordic_fixed]"] = ds_fixed.get("mla_decode", 0)
    log(f"[paths] launches: sigmoid {sigmoid_counts}, gelu_erf {gelu_counts}, "
        f"serve yi-9b {serve_counts}, cordic_fixed {yi_fixed}, serve {DEEPSEEK} "
        f"{ds_counts}, cordic_fixed {ds_fixed}, train loop {train_counts}; "
        f"per kernel {launches}")
    for arch in ("yi-9b", DEEPSEEK):
        for impl in ("cordic_pallas", "cordic_fixed"):
            identity_phase(torch, arch, impl)
            phase_done(f"identity {arch} {impl}")
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
    log(card_line)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
