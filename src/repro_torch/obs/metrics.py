"""Metrics pillar of ``repro.obs``: counters, gauges, fixed-bucket
histograms, and the registry the serving stack's Stats objects surface
through.

The four serving-stack stats dataclasses (``ServiceStats``,
``BatchStats``, ``WorkerStats``, ``QueryStats``) each grew their own
ad-hoc accounting over PRs 2-7; the registry gives them one export
surface instead.  A dataclass registers as a *provider* — a callable
returning a JSON-serializable mapping — and live measurements
(latencies, lags, depths) go through :class:`Histogram`/:class:`Gauge`
instances created on the same registry.  ``MetricsRegistry.snapshot()``
is then THE one schema every consumer reads: ``KSPService.snapshot()``
returns it, ``benchmarks/common.service_row`` flattens it into bench
rows, and the flight recorder attaches it to post-mortem dumps.

Unlike tracing (``repro.obs.trace``), metrics are always on: they
replace accounting the stack already did, so there is no flag to gate
— the cost is an attribute increment, not a record allocation.

All three metric types are **mergeable** (``a.merge(b)`` folds b's
observations into a), so per-worker instances can be aggregated into a
fleet view without losing histogram resolution — the property a real
multi-host port needs to ship metrics home.
"""

from __future__ import annotations

import bisect
import dataclasses

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "LATENCY_MS_BUCKETS",
    "jsonable",
]

# default histogram geometry for millisecond latencies: ~geometric
# spacing from sub-ms dispatch costs to multi-second barrier drains
LATENCY_MS_BUCKETS = (
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0,
    250.0, 500.0, 1_000.0, 2_500.0, 5_000.0, 10_000.0, 30_000.0,
)


def jsonable(obj):
    """Recursively coerce ``obj`` into JSON-serializable primitives.

    Numpy scalars become Python numbers, arrays/tuples become lists,
    dataclasses become dicts, and mapping keys become strings — the
    sanitizer every obs export path (snapshot, trace args, flight
    dumps) runs values through, so one ``json.dump`` never trips over
    an ``np.int64`` that leaked out of a stats field.
    """
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return jsonable(dataclasses.asdict(obj))
    if isinstance(obj, dict):
        return {str(k): jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple, set, frozenset)):
        return [jsonable(v) for v in obj]
    item = getattr(obj, "item", None)  # numpy scalars
    if callable(item):
        try:
            return jsonable(item())
        except (TypeError, ValueError):
            pass
    tolist = getattr(obj, "tolist", None)  # numpy arrays
    if callable(tolist):
        return jsonable(tolist())
    return str(obj)


class Counter:
    """A monotone count.  ``inc`` to bump, ``merge`` to aggregate.

    >>> c = Counter("served")
    >>> c.inc(); c.inc(2)
    >>> c.value
    3
    """

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n

    def merge(self, other: "Counter") -> None:
        self.value += other.value

    def snapshot(self):
        return self.value


class Gauge:
    """A point-in-time value; ``peak`` tracks the run maximum.

    >>> g = Gauge("queue_depth")
    >>> g.set(4.0); g.set(2.0)
    >>> (g.value, g.peak)
    (2.0, 4.0)
    """

    __slots__ = ("name", "value", "peak")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0
        self.peak = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)
        if v > self.peak:
            self.peak = float(v)

    def merge(self, other: "Gauge") -> None:
        # gauges aggregate by max: "deepest queue anywhere" semantics
        self.value = max(self.value, other.value)
        self.peak = max(self.peak, other.peak)

    def snapshot(self):
        return {"value": self.value, "peak": self.peak}


class Histogram:
    """Fixed-bucket histogram: cheap to observe, lossless to merge.

    ``bounds`` are the ascending upper edges; observations land in the
    first bucket whose edge is ≥ the value, with one implicit overflow
    bucket past the last edge.  Two histograms over the SAME bounds
    merge by adding counts — the property that lets per-worker
    histograms aggregate into a fleet histogram without resampling.

    >>> h = Histogram("lat_ms", bounds=(1.0, 10.0, 100.0))
    >>> for v in (0.2, 3.0, 250.0): h.observe(v)
    >>> (h.count, h.percentile(50))
    (3, 10.0)
    """

    __slots__ = ("name", "bounds", "counts", "count", "total", "vmin",
                 "vmax")

    def __init__(self, name: str, bounds=LATENCY_MS_BUCKETS):
        self.name = name
        self.bounds = tuple(float(b) for b in bounds)
        if list(self.bounds) != sorted(set(self.bounds)):
            raise ValueError("histogram bounds must be ascending, unique")
        self.counts = [0] * (len(self.bounds) + 1)
        self.count = 0
        self.total = 0.0
        self.vmin = float("inf")
        self.vmax = float("-inf")

    def observe(self, v: float) -> None:
        v = float(v)
        self.counts[bisect.bisect_left(self.bounds, v)] += 1
        self.count += 1
        self.total += v
        if v < self.vmin:
            self.vmin = v
        if v > self.vmax:
            self.vmax = v

    def merge(self, other: "Histogram") -> None:
        if other.bounds != self.bounds:
            raise ValueError(
                f"cannot merge histogram {other.name!r} "
                f"(bounds differ from {self.name!r})"
            )
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.count += other.count
        self.total += other.total
        self.vmin = min(self.vmin, other.vmin)
        self.vmax = max(self.vmax, other.vmax)

    def percentile(self, q: float) -> float:
        """Approximate q-th percentile (bucket upper edge), q in [0, 100].
        The overflow bucket reports the observed maximum."""
        if self.count == 0:
            return 0.0
        target = max(1, int(round(self.count * q / 100.0)))
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= target:
                return self.bounds[i] if i < len(self.bounds) else self.vmax
        return self.vmax

    def snapshot(self):
        return {
            "bounds": list(self.bounds),
            "counts": list(self.counts),
            "count": self.count,
            "sum": self.total,
            "min": (self.vmin if self.count else 0.0),
            "max": (self.vmax if self.count else 0.0),
        }

    def load(self, snap: dict) -> None:
        """Restore :meth:`snapshot` output — the checkpoint round-trip.
        Bounds must match (this histogram keeps its own geometry)."""
        if tuple(float(b) for b in snap["bounds"]) != self.bounds:
            raise ValueError(
                f"cannot load histogram {self.name!r}: bounds differ"
            )
        self.counts = [int(c) for c in snap["counts"]]
        self.count = int(snap["count"])
        self.total = float(snap["sum"])
        if self.count:
            self.vmin = float(snap["min"])
            self.vmax = float(snap["max"])


_METRIC_TYPES = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class MetricsRegistry:
    """Named metrics + stats providers behind one ``snapshot()``.

    * ``counter/gauge/histogram(name)`` — get-or-create a live metric.
    * ``provider(name, fn)`` — register a callable returning a mapping
      (typically ``dataclasses.asdict`` of an existing Stats object);
      its output appears under ``name`` in the snapshot, sanitized.
    * ``snapshot()`` — one JSON-serializable dict: every provider's
      current mapping plus a ``"metrics"`` group with every live
      metric's state.
    * ``merge(other)`` — fold another registry's live metrics in
      (same-name metrics must be same-typed); providers don't merge —
      they are views of caller-owned state.
    """

    def __init__(self):
        self._metrics: dict[str, object] = {}
        self._kinds: dict[str, str] = {}
        self._providers: dict[str, object] = {}

    def _get(self, kind: str, name: str, *args):
        m = self._metrics.get(name)
        if m is None:
            m = _METRIC_TYPES[kind](name, *args)
            self._metrics[name] = m
            self._kinds[name] = kind
        elif self._kinds[name] != kind:
            raise ValueError(
                f"metric {name!r} already registered as {self._kinds[name]}"
            )
        return m

    def counter(self, name: str) -> Counter:
        """Get-or-create the named :class:`Counter`."""
        return self._get("counter", name)

    def gauge(self, name: str) -> Gauge:
        """Get-or-create the named :class:`Gauge`."""
        return self._get("gauge", name)

    def histogram(self, name: str, bounds=LATENCY_MS_BUCKETS) -> Histogram:
        """Get-or-create the named :class:`Histogram` over ``bounds``."""
        return self._get("histogram", name, bounds)

    def provider(self, name: str, fn) -> None:
        """Register a callable whose result embeds in ``snapshot()``."""
        self._providers[name] = fn

    def merge(self, other: "MetricsRegistry") -> None:
        """Fold another registry in: same-name metrics merge pairwise."""
        for name, m in other._metrics.items():
            kind = other._kinds[name]
            args = (m.bounds,) if kind == "histogram" else ()
            self._get(kind, name, *args).merge(m)

    def snapshot(self) -> dict:
        """One JSON-able dict: provider sections plus every metric."""
        out = {name: jsonable(fn()) for name, fn in self._providers.items()}
        out["metrics"] = {
            name: jsonable(m.snapshot())
            for name, m in sorted(self._metrics.items())
        }
        return out
