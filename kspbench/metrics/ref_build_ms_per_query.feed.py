"""The feed cell's reading of ``ref_build_ms_per_query.open``: host
milliseconds per answered query in ``ref_build`` spans.  The twin's
reader serves here unchanged; the entry of this name lists only the feed
cell."""

from kspbench import cell

_TWIN = cell.load_module(
    cell.ROOT / "metrics" / "ref_build_ms_per_query.open.py")
UNIT = _TWIN.UNIT
read = _TWIN.read
