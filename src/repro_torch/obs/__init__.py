"""Serving observability: metrics registry, request-lifecycle tracing, and
fixed-point saturation accounting — all host-side, all off by default
(port of ``repro/obs/__init__.py``).

``Observability`` is the handle an engine (or benchmark) is constructed
with. It bundles

* ``metrics`` — a :class:`repro_torch.obs.metrics.MetricsRegistry` of
  counters / gauges / log-bucketed histograms with p50/p90/p99 readout and
  JSON snapshot export;
* ``trace`` — an optional :class:`repro_torch.obs.trace.TraceRecorder`
  emitting Chrome-trace (Perfetto-loadable) request-lifecycle and
  engine-phase events against the same monotonic clock;
* ``phase(name)`` — a context manager timing one engine phase into both
  (histogram ``engine.phase.<name>_ms`` + an "X" span on the engine
  track).

``NULL`` is the disabled singleton: identical surface, no clock reads, no
allocation — instrumented code writes through it unconditionally, which
keeps observability off-by-default-cheap and the emitted tokens equal with
observability on or off (nothing here touches a tensor).

The spans time the host. On the card a launch returns once it is queued,
so a span around one times its enqueue; the device's time shows up in the
span that waits for it (the engine's ``host_sync``, the copy of a step's
tokens to the host).

Saturation accounting: :func:`observe_saturation` hooks
``core.fixed_point.set_saturation_observer``, so every plain ``quantize``
inside the scope feeds its clip count into the registry (on the card that
reads the count back to the host: one sync a call, and only inside the
scope); :func:`saturation_audit` sweeps named tensors across the
``FORMAT_PROFILES`` ladder and reports would-clip counts per format.
"""
from __future__ import annotations

import contextlib
import time
from typing import Any, Dict, Optional

from repro_torch.obs.metrics import (Counter, Gauge, Histogram,
                                     MetricsRegistry, NULL_REGISTRY)
from repro_torch.obs.trace import TraceRecorder, validate_chrome_trace

__all__ = [
    "Observability", "NULL", "Counter", "Gauge", "Histogram",
    "MetricsRegistry", "NULL_REGISTRY", "TraceRecorder",
    "validate_chrome_trace", "observe_saturation", "saturation_audit",
]


class _PhaseSpan:
    """Times one engine phase into a histogram and (optionally) the trace."""

    __slots__ = ("_obs", "_name", "_hist", "_t0")

    def __init__(self, obs: "Observability", name: str, hist):
        self._obs = obs
        self._name = name
        self._hist = hist

    def __enter__(self):
        self._t0 = self._obs.now()
        return self

    def __exit__(self, exc_type, exc, tb):
        t1 = self._obs.now()
        dt = t1 - self._t0
        self._hist.observe(dt * 1e3)
        if self._obs.trace is not None:
            self._obs.trace.complete(self._name, self._t0 * 1e6, dt * 1e6)
        return False


class Observability:
    """Live observability handle: a metrics registry + optional tracer
    sharing one clock origin (``now()`` is seconds since construction)."""

    enabled = True

    def __init__(self, *, trace: bool = False,
                 process_name: str = "serve-engine"):
        self._clock = time.perf_counter
        self._t0 = self._clock()
        self.metrics = MetricsRegistry()
        self.trace: Optional[TraceRecorder] = (
            TraceRecorder(process_name) if trace else None)

    @property
    def epoch(self) -> float:
        """Absolute ``time.perf_counter()`` value of this handle's clock
        origin; ``t_abs - epoch`` puts an engine time stamp on this
        handle's trace timeline."""
        return self._t0

    def now(self) -> float:
        """Seconds since this handle was constructed (monotonic)."""
        return self._clock() - self._t0

    def now_us(self) -> float:
        return self.now() * 1e6

    def phase(self, name: str) -> _PhaseSpan:
        """``with obs.phase("dispatch"): ...`` — records the wall time into
        histogram ``engine.phase.<name>_ms`` and an engine-track span."""
        return _PhaseSpan(
            self, name,
            self.metrics.histogram(f"engine.phase.{name}_ms", unit="ms"))

    def request_event(self, stage: str, rid: int,
                      args: Optional[dict] = None) -> None:
        """Lifecycle instant on the request's own trace track."""
        if self.trace is not None:
            self.trace.instant(stage, self.now_us(), track=f"req {rid}",
                               args=args)

    def request_span(self, stage: str, rid: int, t0_s: float,
                     args: Optional[dict] = None) -> None:
        """Lifecycle span [t0_s, now] on the request's trace track."""
        if self.trace is not None:
            self.trace.complete(stage, t0_s * 1e6,
                                (self.now() - t0_s) * 1e6,
                                track=f"req {rid}", args=args)


class _NullPhase:
    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


_NULL_PHASE = _NullPhase()


class _NullObservability:
    """Disabled observability: same surface, zero work. ``metrics`` is the
    shared null registry, ``trace`` is None, clocks read 0.0."""

    enabled = False
    metrics = NULL_REGISTRY
    trace = None
    epoch = 0.0

    def now(self) -> float:
        return 0.0

    def now_us(self) -> float:
        return 0.0

    def phase(self, name: str) -> _NullPhase:
        return _NULL_PHASE

    def request_event(self, stage: str, rid: int,
                      args: Optional[dict] = None) -> None:
        pass

    def request_span(self, stage: str, rid: int, t0_s: float,
                     args: Optional[dict] = None) -> None:
        pass


#: Shared disabled handle; ``ServeEngine(obs=None)`` resolves to this.
NULL = _NullObservability()


# --------------------------------------------------------------------------
# Fixed-point saturation accounting
# --------------------------------------------------------------------------
def _count_clips(registry, fmt: str, clipped: int, total: int) -> None:
    registry.counter(f"fixed_point.saturation.clips{{fmt={fmt}}}",
                     unit="elements").inc(clipped)
    registry.counter(f"fixed_point.saturation.elements{{fmt={fmt}}}",
                     unit="elements").inc(total)


@contextlib.contextmanager
def observe_saturation(registry: MetricsRegistry):
    """While active, every ``fixed_point.quantize`` call feeds its clip
    count into ``registry``:

        fixed_point.saturation.clips{fmt=Q2.14}     (clipped elements)
        fixed_point.saturation.elements{fmt=Q2.14}  (elements quantized)

    Only the plain versions quantize through it; a kernel's saturation is
    not seen. The previous observer is restored on exit (scopes nest)."""
    from repro_torch.core import fixed_point as fp

    def _observer(fmt: str, clipped: int, total: int) -> None:
        _count_clips(registry, fmt, clipped, total)

    prev = fp.set_saturation_observer(_observer)
    try:
        yield registry
    finally:
        fp.set_saturation_observer(prev)


def saturation_audit(tensors: Dict[str, Any],
                     registry: Optional[MetricsRegistry] = None,
                     profiles: Optional[Dict[str, Any]] = None) -> dict:
    """Would-this-clip sweep: quantize every named tensor (or array) into
    every format profile's storage format, on the host, and report

        {profile: {tensor: {"clipped": int, "total": int, "frac": float}}}

    Counts are also fed into ``registry`` when one is given."""
    import numpy as np
    import torch

    if profiles is None:
        from repro_torch.cordic_engine.functions import FORMAT_PROFILES
        profiles = FORMAT_PROFILES

    def host(a):
        if torch.is_tensor(a):
            a = a.detach().to("cpu", torch.float64).numpy()
        return np.asarray(a, np.float64).ravel()

    arrays = {name: host(a) for name, a in tensors.items()}
    out: Dict[str, Dict[str, dict]] = {}
    for pname, prof in sorted(profiles.items()):
        fmt = prof.cfg.fmt
        per = out[pname] = {}
        for tname, x in sorted(arrays.items()):
            scaled = np.round(x * float(fmt.scale))
            clipped = int(np.sum((scaled > fmt.max_int)
                                 | (scaled < fmt.min_int)))
            total = int(x.size)
            per[tname] = {"clipped": clipped, "total": total,
                          "frac": clipped / total if total else 0.0}
            if registry is not None:
                _count_clips(registry, str(fmt), clipped, total)
    return out
