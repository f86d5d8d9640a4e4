"""The feed cell's reading of ``refine_rounds_per_query.open``: grouped-
Yen rounds packed from device-resident slabs per answered query.  The
twin's reader serves here unchanged; the entry of this name lists only
the feed cell."""

from kspbench import cell

_TWIN = cell.load_module(
    cell.ROOT / "metrics" / "refine_rounds_per_query.open.py")
UNIT = _TWIN.UNIT
read = _TWIN.read
