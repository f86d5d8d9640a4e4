"""repro_torch.obs — tracing, metrics, and a flight recorder for the
serving stack.

Three pillars, one import, no dependency on the rest of ``repro_torch``
(so every layer — core stepper, engine backends, cluster, scheduler,
service — can instrument itself without cycles):

* **Tracing** (:mod:`repro_torch.obs.trace`): ``obs.span_at(name, t0,
  dur, ...)`` records a stage the caller timed on ``obs.clock()``.
  Where a stats counter wants the duration anyway (the scheduler's
  ``working_s``, ``worker_busy_s``), the SAME two clock reads feed the
  counter and the trace, one source of truth with no drift; where none
  does (the KSP-DG stepper's spans, ``collect_round``), the caller reads
  the clock only when :func:`enabled`.  The collector exports
  Chrome-trace/Perfetto JSON (``obs.export(path)``) with one timeline
  per worker.
* **Metrics** (:mod:`repro_torch.obs.metrics`): counters / gauges /
  fixed-bucket mergeable histograms behind a :class:`MetricsRegistry`
  — always on (it replaces accounting the stack already did);
  ``KSPService.snapshot()`` is the one consumer-facing schema.
* **Flight recorder** (:mod:`repro_torch.obs.recorder`): bounded
  per-track rings of recent records, dumped by the service on
  exceptions and deadline-rejection storms for post-mortem diagnosis of
  stalls that a full trace re-run may never reproduce.

**The disabled path is a single branch** on the module-level
``_STATE.enabled`` flag: ``span_at`` checks it and returns
immediately, so an untraced service pays one flag test per
instrumentation site.  What that costs end to end is measured by the
benchmark (``kspbench``): the city-open cell's untraced run, against
the same run of the parent commit.  ``obs.clock`` is
``time.perf_counter`` and always works; timing-derived *stats* never
turn off, only record *collection* does.

State is process-global and single-threaded by design (the runtime is
an in-process cluster; the scheduler pump is one thread).  Enable modes:

    obs.enable(trace=True)     # full capture: export + flight recorder
    obs.enable(trace=False)    # flight-recorder only: bounded memory
    obs.disable()              # default: nothing is recorded

or set ``REPRO_OBS=flight`` / ``REPRO_OBS=trace`` in the environment to
enable at import (how CI keeps post-mortem rings live without code
changes).
"""

from __future__ import annotations

import os
import time
from types import SimpleNamespace

from .metrics import (  # noqa: F401
    LATENCY_MS_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    jsonable,
)
from .recorder import FlightRecorder, track_name  # noqa: F401
from .trace import Collector, Record  # noqa: F401

__all__ = [
    "clock",
    "enabled",
    "enable",
    "disable",
    "get_collector",
    "span_at",
    "worker_scope",
    "export",
    "flight_dump",
    "Collector",
    "Record",
    "FlightRecorder",
    "MetricsRegistry",
    "Counter",
    "Gauge",
    "Histogram",
    "LATENCY_MS_BUCKETS",
    "jsonable",
    "track_name",
]

#: THE timing source for the serving stack — every stats counter and
#: every trace record reads this one clock, so they can never drift.
clock = time.perf_counter

# module-level switchboard: `enabled` is the single branch every
# disabled-path call takes; `tid` is the ambient track for records with
# no explicit worker attr (0 = service; worker_scope() overrides)
_STATE = SimpleNamespace(enabled=False, collector=None, tid=0)


def enabled() -> bool:
    """True when a collector is recording (trace or flight-only mode)."""
    return _STATE.enabled


def enable(*, trace: bool = True, ring_capacity: int = 512) -> Collector:
    """Start recording into a fresh :class:`Collector` and return it.

    ``trace=True`` keeps every record for :func:`export`;
    ``trace=False`` keeps only the flight recorder's bounded rings.
    """
    _STATE.collector = Collector(trace=trace, ring_capacity=ring_capacity)
    _STATE.enabled = True
    _STATE.tid = 0
    return _STATE.collector


def disable() -> None:
    """Stop recording and drop the collector (the default state)."""
    _STATE.enabled = False
    _STATE.collector = None
    _STATE.tid = 0


def get_collector() -> Collector | None:
    """The live collector, or None when disabled."""
    return _STATE.collector if _STATE.enabled else None


def _tid(attrs: dict) -> int:
    wid = attrs.get("worker")
    return _STATE.tid if wid is None else int(wid) + 1


def span_at(name: str, t0: float, dur: float, **attrs) -> None:
    """Record one ALREADY-TIMED stage as a completed span.

    The caller read ``obs.clock()`` before and after the stage and
    hands both in; where its stats wanted the duration anyway, the
    trace shows exactly the interval the stats counted.  One branch
    when disabled.
    """
    if _STATE.enabled:
        _STATE.collector.record("span", name, t0, dur, _tid(attrs), attrs)


class worker_scope:
    """Route records without an explicit ``worker=`` attr to a worker's
    timeline while the scope is open.

    ``Worker.execute`` wraps its solve in ``with
    obs.worker_scope(wid):`` so spans emitted far below it — the engine
    backend's ``solve_grouped``, which has no idea which worker is
    calling — inherit the right track instead of cluttering the
    service lane.  Nestable; cheap enough to run unconditionally (two
    attribute writes)."""

    __slots__ = ("tid", "_prev")

    def __init__(self, wid: int):
        self.tid = int(wid) + 1
        self._prev = 0

    def __enter__(self):
        self._prev = _STATE.tid
        _STATE.tid = self.tid
        return self

    def __exit__(self, *exc):
        _STATE.tid = self._prev
        return False


def export(path: str) -> int:
    """Write the collected trace as Chrome-trace JSON; returns the event
    count.  Raises when tracing was never enabled."""
    if _STATE.collector is None:
        raise RuntimeError("obs.export: tracing is not enabled")
    return _STATE.collector.export_chrome(path)


def flight_dump(reason: str) -> dict | None:
    """The flight recorder's recent window, or None when disabled."""
    if not _STATE.enabled:
        return None
    return _STATE.collector.flight_dump(reason)


# import-time opt-in: REPRO_OBS=flight keeps bounded post-mortem rings
# live (CI's stall-diagnosis mode); REPRO_OBS=trace captures everything
_env = os.environ.get("REPRO_OBS", "").strip().lower()
if _env in ("trace",):
    enable(trace=True)
elif _env in ("1", "true", "flight", "on"):
    enable(trace=False)
del _env
