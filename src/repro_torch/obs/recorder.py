"""Flight recorder pillar of ``repro.obs``: bounded per-track rings of
the most recent span/event records, for post-mortem dumps.

Tracing answers "show me the whole run"; the flight recorder answers
"what were the last things each worker did before it went wrong" — the
question a stall seen ONCE in CI forces, where re-running with a full
trace may never reproduce it.  Every record the collector sees is also
appended to a ``deque(maxlen=capacity)`` keyed by its track (the same
pid/tid mapping the Chrome export uses: track 0 is the service/
scheduler, track ``1 + wid`` is worker ``wid``), so memory stays
bounded no matter how long the service runs, and ``dump()`` serializes
exactly the recent window — eviction order is strict FIFO per track.

``KSPService`` triggers dumps on unhandled exceptions inside ``tick``
(``StaleReplicaError`` included), and on deadline-rejection storms;
the dump carries the trigger reason and the service's metrics snapshot
so the numbers and the timeline arrive together.
"""

from __future__ import annotations

from collections import deque

from .metrics import jsonable

__all__ = ["FlightRecorder", "track_name"]


def track_name(tid: int) -> str:
    """Human name of a trace track: 0 = service, 1+wid = worker wid."""
    return "service" if tid == 0 else f"worker-{tid - 1}"


class FlightRecorder:
    """Per-track bounded rings of recent records (strict FIFO eviction)."""

    __slots__ = ("capacity", "rings", "recorded")

    def __init__(self, capacity: int = 512):
        self.capacity = max(1, int(capacity))
        self.rings: dict[int, deque] = {}
        self.recorded = 0  # total records seen (evicted ones included)

    def record(self, rec) -> None:
        """Append one :class:`repro.obs.trace.Record` to its track's ring."""
        ring = self.rings.get(rec.tid)
        if ring is None:
            ring = self.rings[rec.tid] = deque(maxlen=self.capacity)
        ring.append(rec)
        self.recorded += 1

    def dump(self, reason: str, *, t0: float = 0.0) -> dict:
        """JSON-serializable post-mortem: every track's recent window.

        ``t0`` is the collector's time origin; record timestamps are
        reported relative to it (seconds), matching the trace export's
        timeline so a dump can be read against a captured trace.
        """
        return {
            "reason": str(reason),
            "capacity": self.capacity,
            "recorded": self.recorded,
            "tracks": {
                track_name(tid): [
                    {
                        "kind": r.kind,
                        "name": r.name,
                        "t": round(r.ts - t0, 6),
                        "dur": round(r.dur, 6),
                        "attrs": jsonable(r.attrs),
                    }
                    for r in ring
                ]
                for tid, ring in sorted(self.rings.items())
            },
        }
