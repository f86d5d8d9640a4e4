"""Tracing pillar of ``repro.obs``: span records and Chrome-trace export.

A *span* is one timed stage — (name, start, duration, track, attrs) —
and an *event* is an instant marker.  The :class:`Collector` accumulates
them and exports the Chrome Trace Event format (the JSON Perfetto and
``chrome://tracing`` load natively), with one *thread* track per worker
and one for the service/scheduler, so a ``serve.py --trace out.json``
run renders the whole pump — admission, queue wait, dispatch, device
solve, host splice, epoch prepare/commit — as parallel per-worker
timelines.

Track mapping (shared with the flight recorder): a record whose attrs
carry ``worker=wid`` lands on tid ``1 + wid``; anything else lands on
the ambient tid (0 = service, or whatever the innermost
``obs.worker_scope(wid)`` set — how backend solve spans, emitted deep
below ``Worker.execute``, inherit the right worker lane without
threading wid through every call).

Timestamps are ``time.perf_counter`` seconds (``obs.clock``), converted
to the format's microseconds at export; everything is sorted by start
time, so per-tid timestamps are monotone in the file.
"""

from __future__ import annotations

import json
import time
from typing import NamedTuple

from .metrics import jsonable
from .recorder import FlightRecorder, track_name

__all__ = ["Record", "Collector"]


class Record(NamedTuple):
    """One completed span ("span") or instant event ("event")."""

    kind: str
    name: str
    ts: float  # perf_counter seconds (absolute)
    dur: float  # seconds; 0.0 for events
    tid: int  # 0 = service track, 1 + wid = worker wid
    attrs: dict


class Collector:
    """Accumulates records; exports Chrome-trace JSON + flight dumps.

    ``trace=True`` keeps every record for export (unbounded — a capture
    tool, not an always-on mode); ``trace=False`` is flight-recorder-
    only: records land in the bounded per-track rings and nothing else,
    so memory stays O(capacity × tracks) over an arbitrarily long run.
    """

    def __init__(self, *, trace: bool = True, ring_capacity: int = 512,
                 t0: float | None = None):
        self.t0 = time.perf_counter() if t0 is None else float(t0)
        self.trace = bool(trace)
        self.events: list[Record] = []
        self.recorder = FlightRecorder(ring_capacity)

    def record(self, kind: str, name: str, ts: float, dur: float,
               tid: int, attrs: dict) -> None:
        """Append one record to the trace (if on) and the flight ring."""
        rec = Record(kind, name, ts, dur, tid, attrs)
        if self.trace:
            self.events.append(rec)
        self.recorder.record(rec)

    def __len__(self) -> int:
        return len(self.events)

    def spans(self, name: str | None = None) -> list[Record]:
        """Collected span records, optionally filtered by name."""
        return [r for r in self.events
                if r.kind == "span" and (name is None or r.name == name)]

    # ------------------------------------------------------------- export
    def chrome_events(self) -> list[dict]:
        """The Chrome Trace Event list: thread-name metadata first, then
        every record as a complete-span ``ph="X"`` (with ``dur``) or
        instant ``ph="i"`` dict, sorted by start time so ``ts`` is
        monotone per tid."""
        tids = sorted({r.tid for r in self.events} | {0})
        out: list[dict] = [
            {"ph": "M", "name": "process_name", "pid": 1, "tid": 0,
             "args": {"name": "ksp-service"}},
        ]
        for tid in tids:
            out.append({
                "ph": "M", "name": "thread_name", "pid": 1, "tid": tid,
                "args": {"name": track_name(tid)},
            })
            # sort_index pins the service track above the worker lanes
            out.append({
                "ph": "M", "name": "thread_sort_index", "pid": 1,
                "tid": tid, "args": {"sort_index": tid},
            })
        for r in sorted(self.events, key=lambda r: (r.ts, r.tid)):
            ev = {
                "ph": "X" if r.kind == "span" else "i",
                "name": r.name,
                "pid": 1,
                "tid": r.tid,
                "ts": (r.ts - self.t0) * 1e6,  # format wants microseconds
                "args": jsonable(r.attrs),
            }
            if r.kind == "span":
                ev["dur"] = r.dur * 1e6
            else:
                ev["s"] = "t"  # instant scope: thread
            out.append(ev)
        return out

    def export_chrome(self, path: str) -> int:
        """Write the trace to ``path`` (Perfetto/chrome://tracing JSON);
        returns the number of non-metadata events written."""
        events = self.chrome_events()
        with open(path, "w") as f:
            json.dump(
                {"traceEvents": events, "displayTimeUnit": "ms"}, f
            )
        return sum(1 for e in events if e["ph"] != "M")

    def flight_dump(self, reason: str) -> dict:
        """The flight recorder's recent window, timeline-aligned."""
        return self.recorder.dump(reason, t0=self.t0)
