"""The feed cell's reading of ``dtlp_bounding_s``: seconds of the run's
own DTLP build spent on the bounding paths.  The twin's reader serves
here unchanged; the entry of this name lists only the feed cell."""

from kspbench import cell

_TWIN = cell.load_module(
    cell.ROOT / "metrics" / "dtlp_bounding_s.py")
UNIT = _TWIN.UNIT
read = _TWIN.read
