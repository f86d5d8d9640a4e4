"""Helpers the metric readers share: one run's record, reduced.

A record is what ``cell.run_cell`` returns: per-query dicts (``s``,
``t``, ``due``, ``latency`` in seconds, +inf for a failed query,
``done``, ``failed``, ``iterations``), update batches (due, sent,
visible), the window's ``seconds``, the scheduler's, the workers' and
the slab layout's counter deltas, and in a traced run the program's
spans by name (host-clock intervals), the recorded kernel calls and the
device trace (``devtrace.read``).
"""

from __future__ import annotations

import math


def percentile(values, q: float) -> float:
    """Nearest-rank percentile: the smallest value with at least q% of
    the values at or below it (+inf where that rank is a failure)."""
    if not values:
        return math.inf
    v = sorted(values)
    return v[max(0, math.ceil(q / 100 * len(v)) - 1)]


def answered(rec) -> list:
    """Queries answered (not failed), in the window and the drain."""
    return [q for q in rec["queries"] if q["failed"] is None]


def latencies_ms(rec) -> list:
    """Latency of every query due in the window, +inf where it failed."""
    return [q["latency"] * 1e3 for q in rec["queries"]]


def span_s(rec, name: str) -> float | None:
    """Seconds in the program's spans of ``name`` (None when the run
    recorded no span of that name)."""
    spans = rec.get("spans", {}).get(name)
    if not spans:
        return None
    return sum(e - s for s, e in spans)


def per_answered(rec, total):
    """``total`` over the answered queries (None when nothing to read)."""
    n = len(answered(rec))
    if total is None or n == 0:
        return None
    return total / n
