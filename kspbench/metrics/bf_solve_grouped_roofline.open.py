"""Kernel layer: ``bf_solve_grouped``'s share of its roofline (%): the
summed least time of the window's calls (bytes counted from each call's
shapes by ``kspbench/roofline.py``, at the table's HBM rate) over the
summed device time of the profiler's ``bf_solve_grouped`` kernels in the
window.  Nothing to read without a device trace or calls."""

UNIT = "%"
DEVICE = True


def read(rec):
    dev = rec.get("device_trace")
    bounds = rec.get("roofline_bound_s") or []
    if dev is None or not bounds or any(b is None for b in bounds):
        return None
    t = sum(s for name, (s, _) in dev["kernels"].items()
            if "bf_solve_grouped" in name)
    if t <= 0:
        return None
    return 100.0 * sum(bounds) / t
