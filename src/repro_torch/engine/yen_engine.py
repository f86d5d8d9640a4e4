"""Engine-level KSP pieces shared by the grouped Yen driver.

The host drives Yen's deviation paradigm; every round's spur searches
become ONE masked grouped Bellman–Ford call (``dist.grouped_yen``).
This module holds the plain grouped solve and the path extraction from
its parent field.  (``engine_ksp``, the single-slab driver, is not
ported yet; see ROADMAP.md.)
"""

from __future__ import annotations

from .dense import bf_parents_grouped, bf_solve_grouped


def _extract(parent_row, src, dst):
    path = [dst]
    v = dst
    hops = 0
    while v != src:
        v = int(parent_row[v])
        if v < 0 or hops > parent_row.shape[0]:
            return None
        path.append(v)
        hops += 1
    return path[::-1]


def grouped_solver(adj, init, bv, so, bn, cap):
    """The plain grouped (solve + parents) over the owner-aligned
    [S, J, z] slab layout: J spur problems per subgraph relaxed against
    adj [S, z, z] with zero gather.  Any device; returns device tensors
    without waiting on them."""
    dist, _ = bf_solve_grouped(adj, init, bv, so, bn, cap=cap)
    return dist, bf_parents_grouped(adj, dist, so, bn)
