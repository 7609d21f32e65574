"""Host-side metrics registry: counters, gauges, log-bucketed histograms
(port of ``repro/obs/metrics.py``).

Everything here is plain-Python host state — no tensors, no device
transfers. Metric objects are created lazily through a
``MetricsRegistry`` (get-or-create by name, type-checked) and read back as
a JSON-serializable snapshot, so a serving process can expose its whole
observability surface with one ``registry.snapshot()`` call.

``Histogram`` is log-bucketed: observations land in geometric buckets
``(lo*g^(k-1), lo*g^k]`` with growth factor ``g`` (default 1.07), so a
quantile readout is accurate to ~``sqrt(g)-1`` (≈3.5%) relative error at
O(1) memory per decade regardless of sample count — the standard latency-
histogram trade (HdrHistogram / Prometheus style). Count/sum/min/max are
tracked exactly; ``quantile(q)`` walks the cumulative bucket counts and
returns the geometric midpoint of the target bucket, clamped to the exact
observed [min, max].

The ``NULL_REGISTRY`` singleton implements the same surface as no-ops, so
instrumented code paths can write ``registry.counter(name).inc()``
unconditionally and stay off-by-default-cheap (one attribute call, no
branching, no clock reads) when observability is disabled.
"""
from __future__ import annotations

import json
import math
import threading
from typing import Dict, List, Optional, Tuple


class Counter:
    """Monotonically increasing count (events, tokens, clipped elements)."""

    def __init__(self, name: str, unit: str = ""):
        self.name = name
        self.unit = unit
        self.value = 0

    def inc(self, n: int = 1) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name} cannot decrease (n={n})")
        self.value += n

    def snapshot(self) -> dict:
        return {"type": "counter", "unit": self.unit, "value": self.value}


class Gauge:
    """Point-in-time level (queue depth, pool occupancy); tracks the
    high-water mark since construction alongside the last set value."""

    def __init__(self, name: str, unit: str = ""):
        self.name = name
        self.unit = unit
        self.last: float = 0.0
        self.peak: float = float("-inf")
        self._sum = 0.0
        self._n = 0

    def set(self, v: float) -> None:
        v = float(v)
        self.last = v
        if v > self.peak:
            self.peak = v
        self._sum += v
        self._n += 1

    @property
    def mean(self) -> float:
        """Mean over every set() call (an *event*-weighted mean, not a
        time-weighted one — callers that set once per engine step get a
        per-step mean)."""
        return self._sum / self._n if self._n else 0.0

    def snapshot(self) -> dict:
        return {"type": "gauge", "unit": self.unit, "last": self.last,
                "peak": self.peak if self._n else 0.0,
                "mean": self.mean, "sets": self._n}


class Histogram:
    """Log-bucketed distribution with quantile readout.

    ``lo`` is the resolution floor: every observation <= lo (including 0
    and any stray negative) lands in bucket 0, so the default 1e-3 keeps
    sub-microsecond jitter from minting thousands of useless buckets when
    observing milliseconds.
    """

    #: quantiles included in snapshot()
    SNAPSHOT_QS = (0.50, 0.90, 0.99)

    def __init__(self, name: str, unit: str = "", growth: float = 1.07,
                 lo: float = 1e-3):
        if growth <= 1.0:
            raise ValueError(f"growth must be > 1, got {growth}")
        if lo <= 0.0:
            raise ValueError(f"lo must be positive, got {lo}")
        self.name = name
        self.unit = unit
        self.growth = growth
        self.lo = lo
        self._lg = math.log(growth)
        self._buckets: Dict[int, int] = {}
        self.count = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = float("-inf")

    def _index(self, v: float) -> int:
        if v <= self.lo:
            return 0
        # bucket k covers (lo * g^(k-1), lo * g^k]
        return max(1, math.ceil(math.log(v / self.lo) / self._lg - 1e-12))

    def _midpoint(self, idx: int) -> float:
        if idx == 0:
            return self.lo
        return self.lo * self.growth ** (idx - 0.5)

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v
        idx = self._index(v)
        self._buckets[idx] = self._buckets.get(idx, 0) + 1

    def quantile(self, q: float) -> float:
        """Value at quantile ``q`` in [0, 1]: cumulative walk over the
        sorted buckets, geometric bucket midpoint, clamped to the exactly
        tracked [min, max]. NaN when empty."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        if self.count == 0:
            return float("nan")
        if q <= 0.0:
            return self.min
        if q >= 1.0:
            return self.max
        target = q * self.count
        seen = 0
        for idx in sorted(self._buckets):
            seen += self._buckets[idx]
            if seen >= target:
                if idx == 0:
                    # the underflow bucket spans (-inf, lo]; min is the
                    # only exact statistic available for it
                    return self.min
                return min(max(self._midpoint(idx), self.min), self.max)
        return self.max

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else float("nan")

    def snapshot(self) -> dict:
        out = {"type": "histogram", "unit": self.unit, "count": self.count,
               "sum": self.sum,
               "min": self.min if self.count else None,
               "max": self.max if self.count else None,
               "mean": self.mean if self.count else None}
        for q in self.SNAPSHOT_QS:
            out[f"p{int(q * 100)}"] = (self.quantile(q) if self.count
                                       else None)
        return out


class MetricsRegistry:
    """Get-or-create registry of named metrics.

    Re-requesting a name returns the existing instance; requesting it as a
    different type raises (a silently shadowed metric is a lost metric).
    Thread-safe at registration granularity — individual metric updates are
    plain attribute writes under the GIL, which is the precision host-side
    serving telemetry needs.
    """

    enabled = True

    def __init__(self):
        self._metrics: Dict[str, object] = {}
        self._lock = threading.Lock()

    def _get(self, name: str, cls, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, **kw)
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}, requested {cls.__name__}")
            return m

    def counter(self, name: str, unit: str = "") -> Counter:
        return self._get(name, Counter, unit=unit)

    def gauge(self, name: str, unit: str = "") -> Gauge:
        return self._get(name, Gauge, unit=unit)

    def histogram(self, name: str, unit: str = "", growth: float = 1.07,
                  lo: float = 1e-3) -> Histogram:
        return self._get(name, Histogram, unit=unit, growth=growth, lo=lo)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._metrics)

    def get(self, name: str):
        """The registered metric, or None (read-only lookup)."""
        return self._metrics.get(name)

    def snapshot(self) -> dict:
        """JSON-serializable view of every registered metric."""
        with self._lock:
            items = sorted(self._metrics.items())
        return {name: m.snapshot() for name, m in items}

    def to_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({"metrics": self.snapshot()}, f, indent=2,
                      sort_keys=True)


# --------------------------------------------------------------------------
# Null (disabled) implementations — the off-by-default path. One shared
# instance per type: no allocation, no clock reads, no dict lookups on the
# hot path beyond the registry call itself.
# --------------------------------------------------------------------------
class _NullCounter:
    name = unit = ""
    value = 0

    def inc(self, n: int = 1) -> None:
        pass

    def snapshot(self) -> dict:
        return {}


class _NullGauge:
    name = unit = ""
    last = peak = mean = 0.0

    def set(self, v: float) -> None:
        pass

    def snapshot(self) -> dict:
        return {}


class _NullHistogram:
    name = unit = ""
    count = 0
    sum = 0.0
    min = max = mean = float("nan")

    def observe(self, v: float) -> None:
        pass

    def quantile(self, q: float) -> float:
        return float("nan")

    def snapshot(self) -> dict:
        return {}


class _NullRegistry:
    enabled = False
    _COUNTER = _NullCounter()
    _GAUGE = _NullGauge()
    _HISTOGRAM = _NullHistogram()

    def counter(self, name: str, unit: str = "") -> _NullCounter:
        return self._COUNTER

    def gauge(self, name: str, unit: str = "") -> _NullGauge:
        return self._GAUGE

    def histogram(self, name: str, unit: str = "", growth: float = 1.07,
                  lo: float = 1e-3) -> _NullHistogram:
        return self._HISTOGRAM

    def names(self) -> List[str]:
        return []

    def get(self, name: str):
        return None

    def snapshot(self) -> dict:
        return {}

    def to_json(self, path: str) -> None:
        raise RuntimeError("cannot export the null registry; construct a "
                           "real Observability/MetricsRegistry first")


#: Shared disabled registry — what un-instrumented engines write into.
NULL_REGISTRY = _NullRegistry()
