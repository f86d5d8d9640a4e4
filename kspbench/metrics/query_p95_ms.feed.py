"""The feed cell's reading of ``query_p95_ms.open``: 95th-percentile
query latency (ms, host clock, nearest rank; a failed query +inf).  The
twin's reader serves here unchanged; the entry of this name lists only
the feed cell."""

from kspbench import cell

_TWIN = cell.load_module(
    cell.ROOT / "metrics" / "query_p95_ms.open.py")
UNIT = _TWIN.UNIT
read = _TWIN.read
