"""The feed cell's reading of ``join_ms_per_query.open``: host
milliseconds per answered query in ``join`` spans.  The twin's reader
serves here unchanged; the entry of this name lists only the feed cell."""

from kspbench import cell

_TWIN = cell.load_module(
    cell.ROOT / "metrics" / "join_ms_per_query.open.py")
UNIT = _TWIN.UNIT
read = _TWIN.read
