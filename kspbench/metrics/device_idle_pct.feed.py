"""The feed cell's reading of ``device_idle_pct.open``: the share of the
window in which the card ran nothing (%, device trace).  The twin's
reader serves here unchanged; the entry of this name lists only the feed
cell."""

from kspbench import cell

_TWIN = cell.load_module(
    cell.ROOT / "metrics" / "device_idle_pct.open.py")
UNIT = _TWIN.UNIT
DEVICE = _TWIN.DEVICE
read = _TWIN.read
