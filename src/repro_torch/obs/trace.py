"""Chrome-trace (Perfetto-loadable) event recorder for the serving path
(port of ``repro/obs/trace.py``).

Records two families of events against one monotonic clock:

* **request lifecycle** — per-request instants/spans on a per-request
  track: ``enqueue`` → ``admit`` → ``prefill`` (span) → ``first_token`` →
  one ``token`` instant per decode step → ``finish``;
* **engine phases** — per-``step()`` spans on the shared engine track:
  ``admit`` / ``dispatch`` / ``host_sync`` / ``sample_copy``, plus
  ``compile`` instants and ``queue_depth`` / ``batch_occupancy`` counter
  tracks.

Export follows the Trace Event Format JSON-object flavor
(``{"traceEvents": [...], "displayTimeUnit": "ms"}``) with ``ph`` in
{"X" complete, "i" instant, "C" counter, "M" metadata}: timestamps are
microseconds, every logical track gets an integer ``tid`` plus a
``thread_name`` metadata record, so ``ui.perfetto.dev`` (or
``chrome://tracing``) loads the file directly and shows one lane per
request under the engine lanes.

Recording is append-to-a-Python-list cheap and entirely host-side; the
recorder never touches a tensor. Construct it through
``repro_torch.obs.Observability(trace=True)`` so all timestamps share the
observability clock origin.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional

#: the single process id all serve-engine tracks live under
_PID = 1
#: ph values this recorder emits (the schema tests pin this set)
PHASES = ("X", "i", "C", "M")


class TraceRecorder:
    """Append-only Chrome-trace event buffer with named logical tracks."""

    def __init__(self, process_name: str = "serve-engine"):
        self.events: List[dict] = []
        self._tids: Dict[str, int] = {}
        self.events.append({
            "name": "process_name", "ph": "M", "pid": _PID, "tid": 0,
            "ts": 0.0, "args": {"name": process_name},
        })

    def _tid(self, track: str) -> int:
        tid = self._tids.get(track)
        if tid is None:
            tid = self._tids[track] = len(self._tids)
            self.events.append({
                "name": "thread_name", "ph": "M", "pid": _PID, "tid": tid,
                "ts": 0.0, "args": {"name": track},
            })
        return tid

    # -- event emitters -----------------------------------------------------
    def complete(self, name: str, ts_us: float, dur_us: float,
                 track: str = "engine",
                 args: Optional[dict] = None) -> None:
        """A span: ``ph="X"`` with explicit duration (both microseconds)."""
        ev = {"name": name, "ph": "X", "pid": _PID, "tid": self._tid(track),
              "ts": float(ts_us), "dur": max(0.0, float(dur_us))}
        if args:
            ev["args"] = args
        self.events.append(ev)

    def instant(self, name: str, ts_us: float, track: str = "engine",
                args: Optional[dict] = None) -> None:
        ev = {"name": name, "ph": "i", "pid": _PID,
              "tid": self._tid(track), "ts": float(ts_us), "s": "t"}
        if args:
            ev["args"] = args
        self.events.append(ev)

    def counter(self, name: str, ts_us: float, values: Dict[str, float],
                track: str = "engine") -> None:
        """A counter-track sample (``ph="C"``): Perfetto renders one
        stacked area lane per key in ``values``."""
        self.events.append({
            "name": name, "ph": "C", "pid": _PID, "tid": self._tid(track),
            "ts": float(ts_us),
            "args": {k: float(v) for k, v in values.items()},
        })

    # -- export -------------------------------------------------------------
    def to_dict(self) -> dict:
        return {"traceEvents": list(self.events), "displayTimeUnit": "ms"}

    def export(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f)

    # -- readback (tests / analysis) ----------------------------------------
    def track_events(self, track: str) -> List[dict]:
        """Non-metadata events on one named track, in recording order."""
        tid = self._tids.get(track)
        if tid is None:
            return []
        return [e for e in self.events
                if e["tid"] == tid and e["ph"] != "M"]


def validate_chrome_trace(doc: dict) -> None:
    """Raise ValueError unless ``doc`` is a well-formed JSON-object-flavor
    Chrome trace as this module emits it (the schema the tests and the CI
    artifact gate rely on): a ``traceEvents`` list whose entries carry
    name/ph/ts/pid/tid, ``ph`` drawn from the emitted set, non-negative
    ``dur`` on complete events, and JSON-serializable throughout."""
    if not isinstance(doc, dict) or "traceEvents" not in doc:
        raise ValueError("trace must be a dict with a 'traceEvents' list")
    evs = doc["traceEvents"]
    if not isinstance(evs, list):
        raise ValueError("'traceEvents' must be a list")
    for i, ev in enumerate(evs):
        for key in ("name", "ph", "ts", "pid", "tid"):
            if key not in ev:
                raise ValueError(f"event {i} missing {key!r}: {ev}")
        if ev["ph"] not in PHASES:
            raise ValueError(f"event {i} has unknown ph {ev['ph']!r}")
        if not isinstance(ev["ts"], (int, float)) or ev["ts"] < 0:
            raise ValueError(f"event {i} ts must be a non-negative number")
        if ev["ph"] == "X" and (not isinstance(ev.get("dur"), (int, float))
                                or ev["dur"] < 0):
            raise ValueError(f"complete event {i} needs non-negative dur")
        if ev["ph"] == "C" and not isinstance(ev.get("args"), dict):
            raise ValueError(f"counter event {i} needs an args dict")
    json.dumps(doc)  # serializability is part of the contract
