"""Code tables of the CORDIC stages a 16-bit format can look up.

In a 16-bit format each of the two stages that cost the CORDIC kernels
their operations is a function of one code from a small range:

* the tanh stage (``cordic_tanh_q``: the radix-2 and radix-4 rotation and
  the LVC divide) takes ``z = xq >> 1`` of a code ``xq`` of [-1, 1] (the
  sigmoid family) or the code of [-0.5, 0.5] (the tanh op): |z| <= 2^(fb-1);
* the e^r stage (``wrap(c + s)`` of ``coshsinh_q``) takes the code of
  r = u - k ln2, |r| <= ln2/2 plus an ulp (|z| <= 5680 in Q2.14), in
  ``exp_q`` (exp, softplus, elu, gelu_erf) and in every softmax lane.

So one table per stage over the codes [-2^(fb-1), 2^(fb-1)] (16,385 entries
in Q2.14, 32 KB as int16) holds that stage's answer for every code a
kernel can see. The card builds them at first use by running the pipeline's
own device functions over every code (``cordic_code_tables``,
``csrc/act.cu``), so the table route's output is the pipeline's bit for
bit; the float boundary ops around the stages are unchanged. Formats wider
than 16 bits (Q2.20, Q2.29) keep the pipeline: the route is chosen from
the format alone.

A third table serves the integer datapath (``act_q_2d``): its sigmoid code
``wrap(2^(fb-1) + wrap((t + 1) >> 1))``, t the tanh code of ``z =
wrap16(x >> 1)``, is a function of z alone. int16 codes reach z in
[-16384, 16383]; int32 codes are not clamped, so bits 1-16 of the code
decide and z takes all 65,536 values, beyond the tanh table's
[-2^(fb-1), 2^(fb-1)]. So the sigmoid-code table holds every z: 65,536
int16 entries (128 KB), entry ``z + 32768``, which int16 inputs touch only
in its contiguous middle half. The card builds it with the pipeline's own
``cordic_sigmoid_q`` (``cordic_sigmoid_q_table``, ``csrc/act.cu``).

The tables are cached per (schedule, format, device). A CUDA stream capture
cannot build them: build them first (``code_tables`` and ``sigmoid_q_table``
before the capture).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from repro_torch.cordic_engine.core import FixedConfig
from repro_torch.cordic_engine.schedule import MRSchedule
from repro_torch.kernels import build


#: rows of ``CodeTables.codes``
TANH_ROW, EXP_ROW = 0, 1


def table_route(cfg: FixedConfig) -> bool:
    """Whether the kernels take the two stages from tables in this format."""
    return cfg.fmt.total_bits == 16


def table_half(cfg: FixedConfig) -> int:
    """The table covers the codes [-half, half]."""
    return 1 << (cfg.fmt.frac_bits - 1)


@dataclasses.dataclass(frozen=True, eq=False)
class CodeTables:
    """``codes[0]`` holds the tanh codes, ``codes[1]`` the e^r codes; entry
    ``i`` is the stage's answer for the code ``i - half``."""

    codes: torch.Tensor          # (2, 2 * half + 1) int16
    half: int

    def tanh_code(self, z: torch.Tensor) -> torch.Tensor:
        return self._look(TANH_ROW, z)

    def exp_code(self, z: torch.Tensor) -> torch.Tensor:
        return self._look(EXP_ROW, z)

    def _look(self, row: int, z: torch.Tensor) -> torch.Tensor:
        if bool(((z < -self.half) | (z > self.half)).any()):
            raise IndexError(f"a code outside the table's [-{self.half}, {self.half}]")
        return self.codes[row][(z + self.half).long()].to(torch.int32)


def _codes(cfg: FixedConfig) -> torch.Tensor:
    h = table_half(cfg)
    return torch.arange(-h, h + 1, dtype=torch.int32)


def tanh_code_table_plain(sched: MRSchedule, cfg: FixedConfig) -> torch.Tensor:
    """tanh codes of every code in [-half, half], by the plain stage."""
    from repro_torch.kernels import cordic_act as K   # it imports this module

    return K._cordic_tanh_q(_codes(cfg), sched, cfg).to(torch.int16)


def exp_code_table_plain(sched: MRSchedule, cfg: FixedConfig) -> torch.Tensor:
    """e^r codes wrap(cosh + sinh) of every code in [-half, half]."""
    from repro_torch.kernels import cordic_act as K

    return K._exp_code(_codes(cfg), sched, cfg).to(torch.int16)


#: entries of the sigmoid-code table: every 16-bit z
SIGMOID_Q_ENTRIES = 1 << 16


def sigmoid_q_index(x_q: torch.Tensor) -> torch.Tensor:
    """Entry of the sigmoid-code table for int16 or int32 codes:
    wrap16(x >> 1) + 32768, as ``((x >> 1) & 0xFFFF) ^ 0x8000``."""
    return ((x_q.to(torch.int32) >> 1) & 0xFFFF) ^ 0x8000


def sigmoid_q_table_plain(sched: MRSchedule, cfg: FixedConfig) -> torch.Tensor:
    """Sigmoid codes of every z in [-32768, 32767] by the plain stages, fed
    the code 2z (whose halving is z)."""
    from repro_torch.kernels import cordic_act as K

    z = torch.arange(-(SIGMOID_Q_ENTRIES // 2), SIGMOID_Q_ENTRIES // 2,
                     dtype=torch.int32)
    return K._cordic_sigmoid_q(2 * z, sched, cfg).to(torch.int16)


_CACHE: Dict[Tuple[MRSchedule, FixedConfig, torch.device], CodeTables] = {}
_SIGMOID_Q_CACHE: Dict[Tuple[MRSchedule, FixedConfig, torch.device], torch.Tensor] = {}


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _no_capture(what: str) -> None:
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError(f"{what}: build the tables before a CUDA stream "
                           "capture")


def code_tables(sched: MRSchedule, cfg: FixedConfig, device) -> CodeTables:
    """The code tables of (sched, cfg) on ``device``, built at first use: on
    the card by its own CORDIC stages, on the CPU by the plain ones."""
    if not table_route(cfg):
        raise ValueError(f"no code tables for a {cfg.fmt.total_bits}-bit format")
    dev = _device(device)
    key = (sched, cfg, dev)
    tabs = _CACHE.get(key)
    if tabs is not None:
        return tabs
    h = table_half(cfg)
    if dev.type == "cpu":
        codes = torch.stack([tanh_code_table_plain(sched, cfg),
                             exp_code_table_plain(sched, cfg)])
    else:
        _no_capture("code_tables")
        codes = torch.empty(2, 2 * h + 1, dtype=torch.int16, device=dev)
        rc = build.library("act").cordic_code_tables(
            codes.data_ptr(), h, build.params_ptr(sched, cfg), build.stream_ptr(codes))
        build.check(rc, "code_tables")
        build.count("code_tables")
        # other streams may read them next: finish the build here, once
        torch.cuda.current_stream(dev).synchronize()
    tabs = _CACHE[key] = CodeTables(codes, h)
    return tabs


def table_args(row, sched: MRSchedule, cfg: FixedConfig, device):
    """(address, half) of code table ``row`` for a kernel, or (None, 0) on
    the pipeline route: a format wider than 16 bits, or no row (a stage no
    table holds)."""
    if row is None or not table_route(cfg):
        return None, 0
    tabs = code_tables(sched, cfg, device)
    return tabs.codes[row].data_ptr(), tabs.half


def sigmoid_q_table(sched: MRSchedule, cfg: FixedConfig, device) -> torch.Tensor:
    """The (65,536,) int16 sigmoid-code table of (sched, cfg) on ``device``,
    built at first use: on the card by ``cordic_sigmoid_q``, on the CPU by
    the plain stages."""
    if not table_route(cfg):
        raise ValueError(f"no sigmoid-code table for a {cfg.fmt.total_bits}-bit "
                         "format")
    dev = _device(device)
    key = (sched, cfg, dev)
    tab = _SIGMOID_Q_CACHE.get(key)
    if tab is not None:
        return tab
    if dev.type == "cpu":
        tab = sigmoid_q_table_plain(sched, cfg)
    else:
        _no_capture("sigmoid_q_table")
        tab = torch.empty(SIGMOID_Q_ENTRIES, dtype=torch.int16, device=dev)
        rc = build.library("act").cordic_sigmoid_q_table(
            tab.data_ptr(), build.params_ptr(sched, cfg), build.stream_ptr(tab))
        build.check(rc, "sigmoid_q_table")
        build.count("sigmoid_q_table")
        torch.cuda.current_stream(dev).synchronize()
    _SIGMOID_Q_CACHE[key] = tab
    return tab
