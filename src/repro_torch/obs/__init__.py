"""repro.obs — tracing, metrics, and a flight recorder for the serving
stack.

Three pillars, one import, no dependency on the rest of ``repro`` (so
every layer — core stepper, engine backends, cluster, scheduler,
service — can instrument itself without cycles):

* **Tracing** (:mod:`repro.obs.trace`): near-zero-overhead spans.
  ``obs.span("solve", worker=wid)`` is the context-manager form,
  ``@obs.traced("stage")`` the decorator form, and ``obs.span_at(name,
  t0, dur, ...)`` records a stage the caller already timed — the form
  the scheduler/cluster hot paths use so the SAME two ``obs.clock()``
  reads feed both the stats counters (``working_s``,
  ``worker_busy_s``) and the trace, one source of truth with no
  drift.  The collector exports Chrome-trace/Perfetto JSON
  (``obs.export(path)``) with one timeline per worker.
* **Metrics** (:mod:`repro.obs.metrics`): counters / gauges /
  fixed-bucket mergeable histograms behind a :class:`MetricsRegistry`
  — always on (it replaces accounting the stack already did);
  ``KSPService.snapshot()`` is the one consumer-facing schema.
* **Flight recorder** (:mod:`repro.obs.recorder`): bounded per-track
  rings of recent records, dumped by the service on exceptions and
  deadline-rejection storms for post-mortem diagnosis of stalls that
  a full trace re-run may never reproduce.

**The disabled path is a single branch** on the module-level
``_STATE.enabled`` flag: every recording entry point
(``span_at``/``event``/``span``) checks it and returns immediately —
``span`` hands back the no-op singleton — so an untraced service pays
one flag test per instrumentation site (gated ≤ 2% end-to-end by
``benchmarks/bench_obs.py``).  ``obs.clock`` is ``time.perf_counter``
and always works; timing-derived *stats* never turn off, only record
*collection* does.

State is process-global and single-threaded by design (the runtime is
an in-process cluster; the scheduler pump is one thread).  Enable modes:

    obs.enable(trace=True)     # full capture: export + flight recorder
    obs.enable(trace=False)    # flight-recorder only: bounded memory
    obs.disable()              # default: no-op singleton everywhere

or set ``REPRO_OBS=flight`` / ``REPRO_OBS=trace`` in the environment to
enable at import (how CI keeps post-mortem rings live without code
changes).
"""

from __future__ import annotations

import functools
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
    "span",
    "span_at",
    "event",
    "traced",
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

    The hot-path form: the caller read ``obs.clock()`` before and after
    the stage (because its stats wanted the duration anyway) and hands
    both in — no extra clock reads, and the trace shows exactly the
    interval the stats counted.  One branch when disabled.
    """
    if _STATE.enabled:
        _STATE.collector.record("span", name, t0, dur, _tid(attrs), attrs)


def event(name: str, **attrs) -> None:
    """Record one instant event.  One branch when disabled."""
    if _STATE.enabled:
        _STATE.collector.record(
            "event", name, clock(), 0.0, _tid(attrs), attrs
        )


class _NoopSpan:
    """The do-nothing span singleton ``span()`` returns when disabled."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        return self


NOOP_SPAN = _NoopSpan()


class _Span:
    """A live span: times ``__enter__`` → ``__exit__`` on ``obs.clock``
    and records on exit.  ``set(**attrs)`` adds attributes mid-flight
    (e.g. a result count known only at the end of the stage)."""

    __slots__ = ("name", "attrs", "_t0")

    def __init__(self, name: str, attrs: dict):
        self.name = name
        self.attrs = attrs
        self._t0 = 0.0

    def __enter__(self):
        self._t0 = clock()
        return self

    def set(self, **attrs):
        self.attrs.update(attrs)
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None:
            self.attrs.setdefault("error", exc_type.__name__)
        # re-check: disable() may have raced the span's lifetime
        if _STATE.enabled:
            _STATE.collector.record(
                "span", self.name, self._t0, clock() - self._t0,
                _tid(self.attrs), self.attrs,
            )
        return False


def span(name: str, **attrs):
    """Context-manager span: ``with obs.span("splice", qid=7): ...``.

    Returns the no-op singleton when disabled (one branch, zero
    allocation); a record with a ``worker=wid`` attr lands on that
    worker's timeline, anything else on the ambient track (see
    :func:`worker_scope`).
    """
    if not _STATE.enabled:
        return NOOP_SPAN
    return _Span(name, attrs)


def traced(name: str | None = None, **attrs):
    """Decorator span form: ``@obs.traced("rebaseline")``.

    Late-binding: the flag is checked at each CALL, so functions
    decorated while tracing is off still trace once it turns on (a
    decoration-time check would freeze the import-order state in).
    """

    def deco(fn):
        span_name = fn.__qualname__ if name is None else name

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            if not _STATE.enabled:
                return fn(*args, **kwargs)
            with span(span_name, **attrs):
                return fn(*args, **kwargs)

        return wrapped

    return deco


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
