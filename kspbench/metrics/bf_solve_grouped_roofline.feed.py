"""The feed cell's reading of ``bf_solve_grouped_roofline.open``:
``bf_solve_grouped``'s share of its roofline (%, device trace).  The
twin's reader serves here unchanged; the entry of this name lists only
the feed cell."""

from kspbench import cell

_TWIN = cell.load_module(
    cell.ROOT / "metrics" / "bf_solve_grouped_roofline.open.py")
UNIT = _TWIN.UNIT
DEVICE = _TWIN.DEVICE
read = _TWIN.read
