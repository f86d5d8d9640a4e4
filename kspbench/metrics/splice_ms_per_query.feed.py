"""The feed cell's reading of ``splice_ms_per_query.open``: host
milliseconds per answered query in ``splice`` spans.  The twin's reader
serves here unchanged; the entry of this name lists only the feed cell."""

from kspbench import cell

_TWIN = cell.load_module(
    cell.ROOT / "metrics" / "splice_ms_per_query.open.py")
UNIT = _TWIN.UNIT
read = _TWIN.read
