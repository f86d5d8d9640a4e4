"""The feed cell's reading of ``ksp_iterations_per_query.open``: mean
KSP-DG iterations per answered query; under the feed, how tight the
maintained lower bounds are.  The twin's reader serves here unchanged;
the entry of this name lists only the feed cell."""

from kspbench import cell

_TWIN = cell.load_module(
    cell.ROOT / "metrics" / "ksp_iterations_per_query.open.py")
UNIT = _TWIN.UNIT
read = _TWIN.read
