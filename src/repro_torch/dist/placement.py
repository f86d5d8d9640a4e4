"""Owner-aligned subgraph placement (Section 6.1's SubgraphBolt layout).

Every subgraph gets a *primary* worker (LPT bin-packing on a per-subgraph
cost proxy) and a *replica* worker on a different machine whenever the
cluster has more than one worker — the replica serves refine tasks when
the primary is dead or straggling (Section 6.3's re-issue path).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Placement:
    """primary/replica worker of every subgraph + per-worker primary load."""

    primary: np.ndarray  # int64[n_subgraphs]
    replica: np.ndarray  # int64[n_subgraphs]
    load: np.ndarray  # float64[n_workers] — primary load per worker
    n_workers: int

    def owned_by(self, wid: int) -> np.ndarray:
        """Subgraph gids worker ``wid`` must hold (primary ∪ replica)."""
        return np.nonzero((self.primary == wid) | (self.replica == wid))[0]


def subgraph_cost(sg) -> float:
    """One subgraph's refine-cost proxy: nv² · avg-degree.

    One grouped dense BF relaxation over a subgraph costs ~nv² work per
    problem and the number of spur problems scales with path length
    (~average degree of the slab).  THE shared cost model: the LPT
    packer balances it and the straggler detector normalizes observed
    worker latency by it — keep them the same formula or placement
    balance and straggler detection silently de-sync.
    """
    return max(1.0, sg.nv ** 2 * (2.0 * sg.ne / max(1, sg.nv)))


def subgraph_loads(dtlp) -> np.ndarray:
    """Per-subgraph refine-cost proxy vector (see :func:`subgraph_cost`)."""
    return np.array(
        [subgraph_cost(sg) for sg in dtlp.partition.subgraphs],
        dtype=np.float64,
    )


def place(loads: np.ndarray, n_workers: int) -> Placement:
    """LPT bin-packing of subgraphs onto workers, plus replica assignment.

    LPT (longest processing time first: sort descending, assign to the
    least-loaded bin) guarantees max-bin ≤ average + largest item.
    Replicas are packed by a second LPT pass over the combined
    primary+replica load, constrained to a worker different from the
    primary whenever ``n_workers > 1``.
    """
    loads = np.asarray(loads, dtype=np.float64)
    n_sub = loads.shape[0]
    n_workers = int(n_workers)
    if n_workers < 1:
        raise ValueError("n_workers must be ≥ 1")
    primary = np.zeros(n_sub, dtype=np.int64)
    replica = np.zeros(n_sub, dtype=np.int64)
    load = np.zeros(n_workers, dtype=np.float64)

    order = np.argsort(-loads, kind="stable")
    for gid in order:
        w = int(np.argmin(load))
        primary[gid] = w
        load[w] += loads[gid]

    if n_workers == 1:
        return Placement(primary, replica, load, n_workers)

    combined = load.copy()
    for gid in order:
        masked = combined.copy()
        masked[primary[gid]] = np.inf  # replica must live elsewhere
        w = int(np.argmin(masked))
        replica[gid] = w
        combined[w] += loads[gid]
    return Placement(primary, replica, load, n_workers)
