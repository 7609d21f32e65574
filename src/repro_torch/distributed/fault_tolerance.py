"""Fault-tolerance runtime pieces: straggler detection, heartbeats, and a
failure-injection harness used by tests and the training loop (a copy of
``repro/distributed/fault_tolerance.py``, pure Python).

On a real cluster these hooks drive actuation (reassigning a slice,
re-sharding around a dead host, triggering elastic restart); in this
container the detection logic, the restart-from-checkpoint path, and the
elastic re-shard are all exercised for real, while actuation is logged.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, Deque, Dict, List, Optional


@dataclasses.dataclass
class StragglerDetector:
    """EWMA step-time monitor with z-score flagging.

    A step is a straggler candidate if it exceeds mean + threshold*std of
    the exponentially-weighted history (warmup-protected).
    """

    alpha: float = 0.1
    threshold: float = 3.0
    warmup: int = 10
    min_rel_excess: float = 0.5   # must also exceed mean by 50% (guards std~0)
    _mean: float = 0.0
    _m2: float = 0.0              # Welford M2 during warmup
    _var: float = 0.0             # EWMA variance after warmup
    _n: int = 0
    events: List[dict] = dataclasses.field(default_factory=list)

    def observe(self, step: int, dt: float) -> bool:
        self._n += 1
        if self._n <= self.warmup:
            # prime the statistics (Welford)
            d = dt - self._mean
            self._mean += d / self._n
            self._m2 += d * (dt - self._mean)
            if self._n == self.warmup:
                self._var = self._m2 / max(self.warmup - 1, 1)
            return False
        std = max(self._var ** 0.5, 1e-9)
        is_straggler = (dt > self._mean + self.threshold * std
                        and dt > self._mean * (1 + self.min_rel_excess))
        if is_straggler:
            self.events.append({"step": step, "dt": dt, "mean": self._mean,
                                "std": std, "time": time.time()})
        else:
            # EWMA update (straggler samples excluded so they don't poison it)
            self._mean = (1 - self.alpha) * self._mean + self.alpha * dt
            self._var = (1 - self.alpha) * self._var \
                + self.alpha * (dt - self._mean) ** 2
        return is_straggler


class HeartbeatMonitor:
    """Tracks per-host heartbeats; hosts silent for > timeout are dead.

    The trainer calls `beat(host)` every step (in a multi-process runtime
    each host beats for itself via the coordination service); `dead()`
    feeds the recovery policy (restore-from-checkpoint on a shrunk mesh).
    """

    def __init__(self, timeout_s: float = 60.0, clock: Callable[[], float] = time.monotonic):
        self.timeout = timeout_s
        self.clock = clock
        self.last: Dict[str, float] = {}

    def beat(self, host: str) -> None:
        self.last[host] = self.clock()

    def dead(self) -> List[str]:
        now = self.clock()
        return [h for h, t in self.last.items() if now - t > self.timeout]


class FailureInjector:
    """Deterministic fault injection for tests/examples: raises
    `InjectedFailure` when the trainer reaches a scheduled step."""

    class InjectedFailure(RuntimeError):
        pass

    def __init__(self, fail_at_steps=()):
        self.fail_at = set(fail_at_steps)
        self.fired = set()

    def maybe_fail(self, step: int) -> None:
        if step in self.fail_at and step not in self.fired:
            self.fired.add(step)
            raise self.InjectedFailure(f"injected failure at step {step}")
