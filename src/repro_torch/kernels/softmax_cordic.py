"""Whole-row CORDIC softmax: plain PyTorch version and the CUDA kernel.

Port of ``softmax_2d`` of ``repro/kernels/softmax_cordic.py``:

    u_i = x_i - max(x)                    row max
    u_i = k_i ln2 + r_i, |r_i| <= ln2/2   dyadic reduction (fused, as XLA)
    e_i = (cosh r_i + sinh r_i) * 2^k_i   Q2.14 MR-HRC rotation
    S   = sum_i e_i = m * 2^p             exponent-field frexp
    p_i = ((e_i/2) / m) * 2^(k_i - p + 1) R2-LVC division

Lanes more than e^-20 below the row max are exactly 0.

The row sum is taken in XLA:CPU's order (``_xla_row_sum``), so the plain
version, the kernel (``csrc/softmax.cu``) and the JAX kernel agree bit for
bit. Jitted XLA:CPU rewrites ``jnp.sum(axis=-1)`` into nested reduce-windows
(``window={size=1x32 stride=1x32}``, then e.g. ``pad=0_0x8_8`` and
``pad=0_0x0_1`` at 64,000 columns, jax 0.9.0): windows of 32 lanes summed
left to right, padded ``floor(p/2)`` in front and ``ceil(p/2)`` behind,
until at most 32 partials remain, which are summed left to right. The JAX
kernel sums the row padded to ``cols_p`` lanes (``_rowwise_call``), so the
replay starts from ``cols_p``: it equals jitted ``jnp.sum`` of the
zero-padded row at 32 to 64,000 columns, and not that of the unpadded row
at widths that are not a multiple of 128.

``log_softmax_2d`` (the train loss, ``loss_impl="cordic_pallas"``) is the
same exp sweep followed by the hyperbolic-vectoring log of the row sum:

    y_i = u_i - ln S,   ln S = 2 atanh((m-1)/(m+1)) + p ln2   (S = m 2^p)

Lanes masked with -1e30 keep their hugely negative u. Its sum takes the same
order, so it too equals the JAX kernel bit for bit.

In a 16-bit format the kernels read the e^r codes from the card's code
table (``code_tables.py``); ``tables`` makes the plain versions do the same.

The log-softmax kernel splits a row over a thread-block cluster whose CTAs
each hold whole 32-lane windows of it in shared memory; ``log_softmax_plan``
chooses the split, so the CPU tests reach it.

The split form (``kv_shard="seq_model"``: a row's positions cut into spans
across ranks, models/attention.py) takes the same order apart. The max is
exact in any order, so every lane's u, dyadic reduction and e^r code equal
the whole row's once the spans' maxima are reduced. The row sum's first
level is 32-lane windows of the padded row from lane 0, so a span of whole
windows sums its own windows as the whole row does. Three launches, each
with its plain version: ``softmax_split_max`` (the span's row max),
``softmax_split_windows`` (given the row max, the span's e^u window sums)
and ``softmax_split_probs`` (given every span's window sums, the later
levels of the row sum and the span's probabilities). Between them the
caller reduces the maxima and gathers the window sums; the result is bit
for bit the whole row's ``softmax_2d``.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import List, Tuple

import torch

from repro_torch.core import numerics as nx
from repro_torch.cordic_engine.core import PAPER_FIXED, FixedConfig
from repro_torch.cordic_engine.schedule import PAPER_SCHEDULE, MRSchedule
from repro_torch.kernels import build
from repro_torch.kernels import code_tables as CT
from repro_torch.kernels import cost
from repro_torch.kernels.cordic_act import (
    _I32,
    _dequantize_f,
    _exp2_i32,
    _exp_code,
    _fma_k,
    _fma_r,
    _guard_drop,
    _log_q,
    _lvc_div_q,
    _quantize_f,
    _shr,
)

#: lanes more than ~e^-20 below the row max flush to exactly zero
_DEAD_CUTOFF = -20.0
_MIN_K = -30.0


def _exp_codes(u: torch.Tensor, sched: MRSchedule, cfg: FixedConfig, tables=None):
    """Dyadic reduction + rotation: (e^r codes, exponents k, dead mask)."""
    fb, bits = cfg.fmt.frac_bits, cfg.fmt.total_bits
    dead = u < _DEAD_CUTOFF
    k = _fma_k(u).clamp_min(_MIN_K)
    r = torch.where(dead, torch.zeros_like(u), _fma_r(u, k))
    return _exp_code(_quantize_f(r, fb, bits), sched, cfg, tables), k.to(_I32), dead


def _lane_exp(u: torch.Tensor, sched: MRSchedule, cfg: FixedConfig,
              tables=None) -> torch.Tensor:
    """CORDIC e^u per lane (u <= 0), dead lanes exactly 0."""
    eq, ki, dead = _exp_codes(u, sched, cfg, tables)
    ef = _dequantize_f(eq, cfg.fmt.frac_bits) * _exp2_i32(ki)
    return torch.where(dead, torch.zeros_like(ef), ef)


def _lane_probs(u: torch.Tensor, ssum: torch.Tensor, sched: MRSchedule,
                cfg: FixedConfig, tables=None) -> torch.Tensor:
    """Normalised probability per lane given the row sum (broadcastable)."""
    fb, bits = cfg.fmt.frac_bits, cfg.fmt.total_bits
    eq, ki, dead = _exp_codes(u, sched, cfg, tables)
    p = (ssum.view(_I32) >> 23) - 127
    mq = _quantize_f(ssum * _exp2_i32(-p), fb, bits).expand_as(eq)
    t = _lvc_div_q(mq, _shr(eq, 1, bits), sched, cfg)
    out = _dequantize_f(_guard_drop(t, cfg), fb) * _exp2_i32(ki - p + 1)
    return torch.where(dead, torch.zeros_like(out), out)


def cols_padded(cols: int) -> int:
    """The row width the JAX kernel sums over (``_rowwise_call``)."""
    return max(128, -(-cols // 128) * 128)


def _xla_row_sum(x: torch.Tensor) -> torch.Tensor:
    """Row sum over the last axis (keepdim) in jitted XLA:CPU's order over
    the row zero-padded to ``cols_padded`` lanes (adding 0.0 is exact)."""
    cols = x.shape[-1]
    xp = torch.nn.functional.pad(x, (0, cols_padded(cols) - cols))
    return nx.xla_sum(xp, -1, keepdim=True)


def log_softmax_2d_plain(x: torch.Tensor, *, sched: MRSchedule = PAPER_SCHEDULE,
                         cfg: FixedConfig = PAPER_FIXED, tables=None) -> torch.Tensor:
    """Plain PyTorch version of the CORDIC log-softmax over the last axis
    of a 2D tensor; ``tables`` as in ``cordic_act.act_2d_plain``."""
    xf = x.to(torch.float32)
    u = xf - xf.amax(dim=-1, keepdim=True)
    ssum = _xla_row_sum(_lane_exp(u, sched, cfg, tables))
    return u - _log_q(ssum, cfg)


def softmax_2d_plain(x: torch.Tensor, *, sched: MRSchedule = PAPER_SCHEDULE,
                     cfg: FixedConfig = PAPER_FIXED, tables=None) -> torch.Tensor:
    """Plain PyTorch version of the CORDIC softmax over the last axis;
    ``tables`` as in ``cordic_act.act_2d_plain``."""
    xf = x.to(torch.float32)
    m = xf.amax(dim=-1, keepdim=True)
    u = xf - m
    ssum = _xla_row_sum(_lane_exp(u, sched, cfg, tables))
    return _lane_probs(u, ssum, sched, cfg, tables)


@cost.booked("softmax_2d", lambda x, sched=PAPER_SCHEDULE, cfg=PAPER_FIXED:
             cost.softmax_2d_work(x, sched, cfg))
def softmax_2d(x: torch.Tensor, *, sched: MRSchedule = PAPER_SCHEDULE,
               cfg: FixedConfig = PAPER_FIXED) -> torch.Tensor:
    """CORDIC softmax over the last axis of a (rows, cols) float32 tensor."""
    if x.dim() != 2:
        raise ValueError(f"softmax_2d takes a 2D tensor, got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return softmax_2d_plain(x, sched=sched, cfg=cfg)
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("softmax_2d: the kernel takes contiguous float32")
    rows, cols = x.shape
    y = torch.empty_like(x)
    if x.device.type == "meta":
        return y                         # the dry run: checked, not launched
    tab, half = CT.table_args(CT.EXP_ROW, sched, cfg, x.device)
    rc = build.library("softmax").cordic_softmax_2d(
        x.data_ptr(), y.data_ptr(), rows, cols, build.params_ptr(sched, cfg),
        tab, half, build.stream_ptr(x))
    build.check(rc, "softmax_2d")
    build.count("softmax_2d")
    return y


# ---------------------------------------------------------------------------
# The split form: a row cut into spans of whole windows
# ---------------------------------------------------------------------------
def check_span(span: int) -> None:
    """A span of the split softmax holds whole 32-lane windows."""
    if span % nx.SUM_WINDOW:
        raise ValueError(
            f"a CORDIC softmax row cut into spans of {span} lanes: each span must "
            f"be a multiple of {nx.SUM_WINDOW} lanes, so that its window sums are "
            "the whole row's (a cut of the positions needs max_len / tp, or / dp under "
            "the data axes' cut, to be one)")


def split_row_sum(windows: torch.Tensor, cols: int) -> torch.Tensor:
    """(rows, cols / 32) window sums of the spans, in row order -> (rows, 1)
    row sum: zero windows up to the padded row's, then the later levels in
    XLA:CPU's order, as ``_xla_row_sum`` takes them."""
    n1 = cols_padded(cols) // nx.SUM_WINDOW
    w = torch.nn.functional.pad(windows, (0, n1 - windows.shape[-1]))
    return nx.xla_sum(w, -1, keepdim=True)


def softmax_split_max_plain(x: torch.Tensor) -> torch.Tensor:
    """The span's row max: (rows, span) -> (rows,) float32."""
    return x.to(torch.float32).amax(dim=-1)


def softmax_split_windows_plain(x: torch.Tensor, m: torch.Tensor, *,
                                sched: MRSchedule = PAPER_SCHEDULE,
                                cfg: FixedConfig = PAPER_FIXED, tables=None) -> torch.Tensor:
    """The span's e^(x - m) window sums given the whole row's max ``m``
    (rows,): (rows, span) -> (rows, span / 32)."""
    check_span(x.shape[-1])
    u = x.to(torch.float32) - m[:, None]
    return nx.window_sums(_lane_exp(u, sched, cfg, tables))


def softmax_split_probs_plain(x: torch.Tensor, m: torch.Tensor, windows: torch.Tensor,
                              *, sched: MRSchedule = PAPER_SCHEDULE,
                              cfg: FixedConfig = PAPER_FIXED, tables=None) -> torch.Tensor:
    """The span's probabilities given the row max ``m`` (rows,) and every
    span's window sums ``windows`` (rows, cols / 32, spans in row order):
    (rows, span) -> (rows, span)."""
    u = x.to(torch.float32) - m[:, None]
    ssum = split_row_sum(windows, nx.SUM_WINDOW * windows.shape[-1])
    return _lane_probs(u, ssum, sched, cfg, tables)


def _split_args(x: torch.Tensor, name: str, *others) -> None:
    if x.dim() != 2:
        raise ValueError(f"{name} takes a 2D tensor, got {tuple(x.shape)}")
    for t in (x, *others):
        if t.dtype != torch.float32 or not t.is_contiguous() or t.device != x.device:
            raise ValueError(f"{name}: the kernel takes contiguous float32 on one device")


@cost.booked("softmax_split_max", lambda x: cost.row_max_work(x))
def softmax_split_max(x: torch.Tensor) -> torch.Tensor:
    """The span's row max (rows,) of a (rows, span) float32 tensor."""
    if x.device.type == "cpu":
        return softmax_split_max_plain(x)
    _split_args(x, "softmax_split_max")
    rows, cols = x.shape
    m = torch.empty((rows,), dtype=torch.float32, device=x.device)
    if x.device.type == "meta":
        return m
    rc = build.library("softmax").cordic_softmax_split_max(
        x.data_ptr(), m.data_ptr(), rows, cols, build.stream_ptr(x))
    build.check(rc, "softmax_split_max")
    build.count("softmax_split_max")
    return m


@cost.booked("softmax_split_windows",
             lambda x, m, sched=PAPER_SCHEDULE, cfg=PAPER_FIXED:
             cost.softmax_split_windows_work(x, sched, cfg))
def softmax_split_windows(x: torch.Tensor, m: torch.Tensor, *,
                          sched: MRSchedule = PAPER_SCHEDULE,
                          cfg: FixedConfig = PAPER_FIXED) -> torch.Tensor:
    """The span's e^(x - m) window sums (rows, span / 32), ``m`` the whole
    row's max (rows,)."""
    if x.device.type == "cpu":
        return softmax_split_windows_plain(x, m, sched=sched, cfg=cfg)
    _split_args(x, "softmax_split_windows", m)
    rows, cols = x.shape
    check_span(cols)
    w = torch.empty((rows, cols // nx.SUM_WINDOW), dtype=torch.float32, device=x.device)
    if x.device.type == "meta":
        return w
    tab, half = CT.table_args(CT.EXP_ROW, sched, cfg, x.device)
    rc = build.library("softmax").cordic_softmax_split_windows(
        x.data_ptr(), m.data_ptr(), w.data_ptr(), rows, cols,
        build.params_ptr(sched, cfg), tab, half, build.stream_ptr(x))
    build.check(rc, "softmax_split_windows")
    build.count("softmax_split_windows")
    return w


@cost.booked("softmax_split_probs",
             lambda x, m, windows, sched=PAPER_SCHEDULE, cfg=PAPER_FIXED:
             cost.softmax_split_probs_work(x, windows, sched, cfg))
def softmax_split_probs(x: torch.Tensor, m: torch.Tensor, windows: torch.Tensor, *,
                        sched: MRSchedule = PAPER_SCHEDULE,
                        cfg: FixedConfig = PAPER_FIXED) -> torch.Tensor:
    """The span's probabilities (rows, span) from the row max ``m`` (rows,)
    and every span's window sums ``windows`` (rows, cols / 32)."""
    if x.device.type == "cpu":
        return softmax_split_probs_plain(x, m, windows, sched=sched, cfg=cfg)
    _split_args(x, "softmax_split_probs", m, windows)
    rows, cols = x.shape
    y = torch.empty_like(x)
    if x.device.type == "meta":
        return y
    tab, half = CT.table_args(CT.EXP_ROW, sched, cfg, x.device)
    rc = build.library("softmax").cordic_softmax_split_probs(
        x.data_ptr(), m.data_ptr(), windows.data_ptr(), y.data_ptr(), rows, cols,
        windows.shape[-1], build.params_ptr(sched, cfg), tab, half, build.stream_ptr(x))
    build.check(rc, "softmax_split_probs")
    build.count("softmax_split_probs")
    return y


#: log_softmax_cluster_kernel's CTA (threads, warps), the largest portable
#: thread-block cluster, and the shared memory a CTA may use on the H100
#: (227 KB)
LS_THREADS, LS_WARPS = 256, 8
LS_MAX_CLUSTER = 8
SMEM_LIMIT = 232448


def _ls_smem(n1: int, windows: int, staged: bool) -> int:
    """Shared-memory bytes of a CTA (csrc ``ls_layout``): the slice (128
    bytes a window, staged only), the row's ``n1`` window sums, the next
    level, the warps' maxima, the CTA's max and ln S (floats). The launch
    refuses any other size."""
    return (128 * windows if staged else 0) + 4 * (n1 + n1 // 32 + 1 + LS_WARPS + 2)


@dataclasses.dataclass(frozen=True)
class LogSoftmaxPlan:
    """A row of ``cols`` lanes split over a cluster of ``cluster`` CTAs:
    CTA r takes the 32-lane windows [r W, r W + W) of the row padded to
    ``cols_padded(cols)`` (W = ``windows``; the last may hold fewer, none
    holds none); ``staged``: the CTA keeps them in shared memory, else it
    reads them from global memory in each pass. A plan that leaves a window
    out or a CTA empty, or needs more shared memory than a CTA may have,
    raises."""

    cols: int
    cluster: int
    windows: int
    staged: bool

    def __post_init__(self):
        n1 = cols_padded(self.cols) // 32
        if not 1 <= self.cluster <= LS_MAX_CLUSTER:
            raise ValueError(f"log_softmax_2d: a cluster of {self.cluster} CTAs "
                             f"(1 to {LS_MAX_CLUSTER})")
        if not (self.cluster - 1) * self.windows < n1 <= self.cluster * self.windows:
            raise ValueError(f"log_softmax_2d: {self.cluster} CTAs of {self.windows} "
                             f"windows do not split a row of {n1} windows")
        if self.smem > SMEM_LIMIT:
            raise ValueError(f"log_softmax_2d: a row of {self.cols} lanes needs "
                             f"{self.smem} bytes of shared memory a CTA, more than "
                             f"{SMEM_LIMIT}")

    @property
    def smem(self) -> int:
        """The shared-memory bytes of a CTA."""
        return _ls_smem(cols_padded(self.cols) // 32, self.windows, self.staged)

    def slices(self) -> List[Tuple[int, int]]:
        """(first window, end window) of each CTA, as the kernel takes them."""
        n1 = cols_padded(self.cols) // 32
        return [(r * self.windows, min(r * self.windows + self.windows, n1))
                for r in range(self.cluster)]


@functools.lru_cache(maxsize=64)
def log_softmax_plan(cols: int) -> LogSoftmaxPlan:
    """The split of a ``cols``-lane row: a window a thread (256 windows, 8192
    lanes a CTA) up to a cluster of 8, beyond that more windows a CTA (at
    256,000 lanes 1000: 128 KB of row); a slice that does not fit in shared
    memory (past ~360,000 lanes) is read from global memory in each pass."""
    n1 = cols_padded(cols) // 32
    cs = min(LS_MAX_CLUSTER, -(-n1 // LS_THREADS))
    wpc = -(-n1 // cs)
    return LogSoftmaxPlan(cols, cs, wpc, _ls_smem(n1, wpc, True) <= SMEM_LIMIT)


@cost.booked("log_softmax_2d", lambda x, sched=PAPER_SCHEDULE, cfg=PAPER_FIXED:
             cost.log_softmax_2d_work(x, sched, cfg))
def log_softmax_2d(x: torch.Tensor, *, sched: MRSchedule = PAPER_SCHEDULE,
                   cfg: FixedConfig = PAPER_FIXED) -> torch.Tensor:
    """CORDIC log-softmax over the last axis of a (rows, cols) float32
    tensor, a row split by ``log_softmax_plan(cols)``."""
    if x.dim() != 2:
        raise ValueError(f"log_softmax_2d takes a 2D tensor, got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return log_softmax_2d_plain(x, sched=sched, cfg=cfg)
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("log_softmax_2d: the kernel takes contiguous float32")
    rows, cols = x.shape
    plan = log_softmax_plan(cols)
    y = torch.empty_like(x)
    if x.device.type == "meta":
        return y                         # the dry run: checked, not launched
    tab, half = CT.table_args(CT.EXP_ROW, sched, cfg, x.device)
    rc = build.library("softmax").cordic_log_softmax_2d(
        x.data_ptr(), y.data_ptr(), rows, cols, plan.cluster, plan.windows,
        plan.smem, int(plan.staged), build.params_ptr(sched, cfg), tab, half,
        build.stream_ptr(x))
    build.check(rc, "log_softmax_2d")
    build.count("log_softmax_2d")
    return y
