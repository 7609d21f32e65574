"""Build and load the hand-written CUDA kernels (``csrc/*.cu``) for Hopper.

Each source compiles on first use with ``nvcc`` into its own shared library
with a plain ``extern "C"`` interface, loaded with ``ctypes``; all sources
build in parallel (one ``nvcc`` each). Libraries land in ``_build/`` beside
this file, named by a hash of the sources and flags, so an unchanged tree
reuses them. Nothing here runs when the module is imported: the CPU tests
import every module on a machine without ``nvcc``.

Every C entry point returns ``cudaGetLastError()`` after its launch;
``check`` raises when that is not 0, since a refused launch never runs and
a later ``synchronize`` would not report it.

``LAUNCHES`` counts kernel launches per kernel name; a wrapper adds one
where it launches, so a run can show that it went through the kernels.

The schedule ROM (atanh constants, radix-4 thresholds, x0, the
hyperbolic-vectoring stages of the log leg and the linear-rotation stages
of the KV dequant) is computed here exactly as the JAX kernel computes it
(``repro/kernels/cordic_act.py`` :88, :93, :104-107, :219, :255;
``repro/cordic_engine/schedule.py`` ``LIN_ROTATION``) and passed by pointer
in ``CordicParams``
(``csrc/cordic.cuh``), so the kernels stay parametric in ``MRSchedule`` and
``FixedConfig``.
"""
from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import math
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

import torch

from repro_torch.cordic_engine.core import FixedConfig
from repro_torch.cordic_engine.schedule import (
    HYP_VECTORING,
    LIN_ROTATION,
    MRSchedule,
    hyp_vectoring_for,
)

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = ("act", "softmax", "paged_decode", "gemm", "gemm_tc")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC")

#: kernel name -> launches since the last reset_launches()
LAUNCHES: collections.Counter = collections.Counter()

_MAX_R2, _MAX_R4, _MAX_LVC, _MAX_HV, _MAX_LIN = 32, 16, 32, 32, 32
_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
#: ptxas resource report of the last build (registers, shared memory, spills)
BUILD_LOG: Dict[str, str] = {}


def reset_launches() -> None:
    LAUNCHES.clear()


def count(name: str) -> None:
    LAUNCHES[name] += 1


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {rc}")


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


class CordicParams(ctypes.Structure):
    """Mirror of ``struct CordicParams`` in csrc/cordic.cuh."""

    _fields_ = [
        ("bits", ctypes.c_int), ("fb", ctypes.c_int), ("zbits", ctypes.c_int),
        ("zfb", ctypes.c_int), ("z_guard", ctypes.c_int), ("x0", ctypes.c_int),
        ("n_r2", ctypes.c_int),
        ("r2_j", ctypes.c_int * _MAX_R2), ("r2_a", ctypes.c_int * _MAX_R2),
        ("n_r4", ctypes.c_int),
        ("r4_j", ctypes.c_int * _MAX_R4), ("r4_t05", ctypes.c_int * _MAX_R4),
        ("r4_t15", ctypes.c_int * _MAX_R4), ("r4_a1", ctypes.c_int * _MAX_R4),
        ("r4_a2", ctypes.c_int * _MAX_R4),
        ("n_lvc", ctypes.c_int),
        ("lvc_j", ctypes.c_int * _MAX_LVC), ("lvc_step", ctypes.c_int * _MAX_LVC),
        ("max_doublings", ctypes.c_int),
        ("n_hv", ctypes.c_int),
        ("hv_j", ctypes.c_int * _MAX_HV), ("hv_a", ctypes.c_int * _MAX_HV),
        ("n_lin", ctypes.c_int), ("lin_j", ctypes.c_int * _MAX_LIN),
    ]


def log_vectoring_js(frac_bits: int) -> tuple:
    """The hyperbolic-vectoring stages of the log leg for a format: j=1..14
    with repeats for Q2.14, deeper for the wider profiles (``_log_q``)."""
    return (HYP_VECTORING.r2_js if frac_bits == 14
            else hyp_vectoring_for(frac_bits).r2_js)


@functools.lru_cache(maxsize=None)
def cordic_params(sched: MRSchedule, cfg: FixedConfig,
                  max_doublings: int = 3) -> CordicParams:
    """The schedule ROM for (sched, cfg), built as the JAX kernel builds it.
    The log leg's vectoring stages follow the format (``_log_q``); the
    linear-rotation stages are those of ``functions.multiply_float``
    (``LIN_ROTATION``), the KV dequant's multiply."""
    fb, zfb = cfg.fmt.frac_bits, cfg.zfmt.frac_bits
    hv_js = log_vectoring_js(fb)
    lin_js = LIN_ROTATION.r2_js
    if (len(sched.r2_js) > _MAX_R2 or len(sched.r4_js) > _MAX_R4
            or len(sched.lvc_js) > _MAX_LVC or len(hv_js) > _MAX_HV
            or len(lin_js) > _MAX_LIN):
        raise ValueError(f"schedule {sched} exceeds the kernel ROM size")
    p = CordicParams()
    p.bits, p.fb = cfg.fmt.total_bits, fb
    p.zbits, p.zfb, p.z_guard = cfg.zfmt.total_bits, zfb, cfg.z_guard
    p.x0 = int(round(sched.x0 * (1 << fb)))
    p.n_r2 = len(sched.r2_js)
    for i, j in enumerate(sched.r2_js):
        p.r2_j[i] = j
        p.r2_a[i] = int(round(math.atanh(2.0 ** -j) * (1 << zfb)))
    p.n_r4 = len(sched.r4_js)
    for i, j in enumerate(sched.r4_js):
        p.r4_j[i] = j
        p.r4_t05[i] = int(round(0.5 * 4.0 ** -j * (1 << zfb)))
        p.r4_t15[i] = int(round(1.5 * 4.0 ** -j * (1 << zfb)))
        p.r4_a1[i] = int(round(math.atanh(1.0 * 4.0 ** -j) * (1 << zfb)))
        p.r4_a2[i] = int(round(math.atanh(2.0 * 4.0 ** -j) * (1 << zfb)))
    p.n_lvc = len(sched.lvc_js)
    for i, j in enumerate(sched.lvc_js):
        p.lvc_j[i] = j
        p.lvc_step[i] = 1 << max(zfb - j, 0)
    p.max_doublings = max_doublings
    p.n_hv = len(hv_js)
    for i, j in enumerate(hv_js):
        p.hv_j[i] = j
        p.hv_a[i] = int(round(math.atanh(2.0 ** -j) * (1 << zfb)))
    p.n_lin = len(lin_js)
    for i, j in enumerate(lin_js):
        p.lin_j[i] = j
    return p


def params_ptr(sched: MRSchedule, cfg: FixedConfig, max_doublings: int = 3) -> int:
    """Address of the cached schedule ROM, for a ``const CordicParams*``."""
    return ctypes.addressof(cordic_params(sched, cfg, max_doublings))


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and Path(cand, "bin", "nvcc").exists():
            return str(Path(cand, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build on a "
                           "machine with the CUDA toolkit")
    return found


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for f in (CSRC / "cordic.cuh", CSRC / f"{name}.cu"):
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all(verbose: bool = False) -> Dict[str, Path]:
    """Compile every source that has no up-to-date library, all at once.

    ``verbose`` adds ``-Xptxas=-v`` (same binary) and keeps its report in
    ``BUILD_LOG``.
    Returns {source name: library path}.
    """
    extra = ("-Xptxas=-v",) if verbose else ()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: _lib_path(n) for n in SOURCES}
    procs = {}
    nvcc = _nvcc()
    for name, out in paths.items():
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, *extra, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOG[name] = log
        if proc.returncode != 0:
            failed.append(f"--- {name}.cu ---\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return paths


def library(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, building all sources first."""
    with _LOCK:
        if name not in _LIBS:
            paths = build_all()
            for n, path in paths.items():
                _LIBS[n] = _bind(n, ctypes.CDLL(str(path)))
        return _LIBS[name]


_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float
_SIGNATURES = {
    "act": {
        # (x, y, n, op, dtype, params, table, half, stream)
        "cordic_act_2d": (_P, _P, _LL, _I, _I, _P, _P, _I, _P),
        # (tables, half, params, stream)
        "cordic_code_tables": (_P, _I, _P, _P),
        # (gate, up, y, n, dtype, params, table, half, stream)
        "cordic_silu_mul_2d": (_P, _P, _P, _LL, _I, _P, _P, _I, _P),
        # (x, y, n, int dtype, params, sigmoid-code table, stream)
        "cordic_act_q_2d": (_P, _P, _LL, _I, _P, _P, _P),
        # (table, params, stream)
        "cordic_sigmoid_q_table": (_P, _P, _P),
    },
    "softmax": {
        # (x, y, rows, cols, params, table, half, stream)
        "cordic_softmax_2d": (_P, _P, _I, _I, _P, _P, _I, _P),
        # (x, y, rows, cols, cluster, windows, smem, staged, params, table,
        #  half, stream)
        "cordic_log_softmax_2d": (_P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _I, _P),
        # the split form: (x, m, rows, cols, stream); (x, m, w, rows, cols,
        # params, table, half, stream); (x, m, w, y, rows, cols, nw, params,
        # table, half, stream)
        "cordic_softmax_split_max": (_P, _P, _I, _I, _P),
        "cordic_softmax_split_windows": (_P, _P, _P, _I, _I, _P, _P, _I, _P),
        "cordic_softmax_split_probs": (_P, _P, _P, _P, _I, _I, _I, _P, _P, _I, _P),
    },
    "paged_decode": {
        # (q, q_dtype, k_pool, v_pool, pool_dtype, k_scale, v_scale,
        #  code_res, tables, k_len, out, ws, ws_floats, B, KH, G, hd, L, M,
        #  chunk, tile, order, pv_order, pv_chunk, scale, impl, kv_dtype,
        #  params, stream)
        "paged_gqa_decode": (_P, _I, _P, _P, _I, _P, _P, _F, _P, _P, _P, _P, _LL,
                             _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _I, _I, _P,
                             _P),
        # (q_eff, q_rope, q_dtype, c_pool, r_pool, tables, k_len, out, ws,
        #  ws_floats, B, H, R, P, L, M, score_heads, chunk, tile, order,
        #  pv_order, pv_chunk, scale, impl, params, stream)
        "paged_mla_decode": (_P, _P, _I, _P, _P, _P, _P, _P, _P, _LL,
                             _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _I, _P,
                             _P),
    },
    "gemm": {
        # (a, a_dtype, a strides (batch, row, k), b, b_dtype, b strides
        #  (batch, k, col), c, c_dtype, batch, M, N, K, wide, stream)
        "invariant_gemm": (_P, _I, _LL, _LL, _LL, _P, _I, _LL, _LL, _LL, _P, _I,
                           _I, _I, _I, _I, _I, _P),
    },
    "gemm_tc": {
        # (a, a strides (batch, row, k), b, b strides (batch, k, col), c,
        #  c_dtype, batch, M, N, K, stream)
        "tc_gemm": (_P, _LL, _LL, _LL, _P, _LL, _LL, _LL, _P, _I, _I, _I, _I, _I, _P),
    },
}


def _bind(name: str, lib: ctypes.CDLL) -> ctypes.CDLL:
    for fn, argtypes in _SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = list(argtypes)
        f.restype = ctypes.c_int
    return lib


#: dtype codes of the C interface
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
