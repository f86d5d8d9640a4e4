"""The feed cell's reading of ``queue_wait_share.open``: the share of
query latency spent waiting for admission (%, ``queue_wait`` spans).  The
twin's reader serves here unchanged; the entry of this name lists only
the feed cell."""

from kspbench import cell

_TWIN = cell.load_module(
    cell.ROOT / "metrics" / "queue_wait_share.open.py")
UNIT = _TWIN.UNIT
read = _TWIN.read
