"""Synthetic road-network generators + the dynamic weight model.

DIMACS road networks (NY/COL/FLA/CUSA) are not available in this offline
container; these generators produce road-like graphs: grid lattices with
knocked-out edges (rivers/parks), diagonal shortcuts (highways) and
integer travel-time weights.  ``data/dimacs.py`` can load the real files
when present.

The dynamic model follows the paper's use of [32] (time-varying travel
times): at each snapshot a fraction α of edges change weight by a factor
drawn uniformly from [1-τ, 1+τ], clamped positive.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.graph import Graph


def grid_road_network(
    rows: int,
    cols: int,
    *,
    knockout: float = 0.08,
    shortcut_frac: float = 0.03,
    w_low: int = 1,
    w_high: int = 20,
    directed: bool = False,
    seed: int = 0,
) -> Graph:
    """A rows×cols lattice with random knockouts and diagonal shortcuts."""
    rng = np.random.default_rng(seed)
    n = rows * cols
    us, vs = [], []
    for r in range(rows):
        for c in range(cols):
            v = r * cols + c
            if c + 1 < cols:
                us.append(v)
                vs.append(v + 1)
            if r + 1 < rows:
                us.append(v)
                vs.append(v + cols)
    us = np.array(us, dtype=np.int64)
    vs = np.array(vs, dtype=np.int64)
    keep = rng.random(us.shape[0]) >= knockout
    us, vs = us[keep], vs[keep]

    n_short = int(shortcut_frac * us.shape[0])
    if n_short:
        su = rng.integers(0, n, n_short)
        # short-range diagonal shortcuts
        dr = rng.integers(1, 4, n_short)
        dc = rng.integers(1, 4, n_short)
        sv = np.minimum(n - 1, su + dr * cols + dc)
        ok = sv != su
        us = np.concatenate([us, su[ok]])
        vs = np.concatenate([vs, sv[ok]])

    # dedupe parallel edges
    lo = np.minimum(us, vs)
    hi = np.maximum(us, vs)
    key = lo * n + hi
    _, idx = np.unique(key, return_index=True)
    us, vs = us[idx], vs[idx]

    w0 = rng.integers(w_low, w_high + 1, us.shape[0]).astype(np.float64)
    g = Graph(n, us, vs, w0, directed=directed)
    return _largest_component(g)


def corridor_tie_network(
    width: int = 4,
    length: int = 10,
    *,
    w_corridor: float = 1.0,
    w_spur: float = 0.45,
    spurs: int = 1,
    directed: bool = False,
) -> Graph:
    """A geodesic corridor that stalls the Yen reference stream.

    Deterministic ``width × length`` lattice whose edges all weigh
    ``w_corridor`` — so skeleton reference paths tie in combinatorially
    large cohorts — with ``spurs`` dangling spur vertices per lattice
    vertex attached at ``w_spur`` < ``w_corridor``.  The spurs carry no
    routes, but their cheap unit weights dilute every subgraph's sorted
    unit-weight profile, pulling the bound distances (and hence the
    skeleton's lower-bound edge weights) strictly below the actual
    corridor distances (``w_spur`` must sit below ``w_corridor/2`` for
    even the shortest boundary pairs to go loose; build the DTLP with a
    small ``xi`` — e.g. ``z=12, xi=2`` at the default size — or the
    deeper bound levels re-tighten the pairs).  Theorem 3's stop rule
    then has to climb through several *massively tied* reference weight
    levels before it can fire: the Yen stream pays one deviation round
    per tied reference and the ``max_iterations`` guard truncates, while
    the lazy deviation-walk stream consumes whole tied cohorts per
    iteration and completes (``tests/test_refstream.py`` and
    ``bench_query --stream`` pin this split).
    """
    n_lattice = width * length
    us, vs, ws = [], [], []
    for r in range(width):
        for c in range(length):
            v = r * length + c
            if c + 1 < length:
                us.append(v)
                vs.append(v + 1)
                ws.append(w_corridor)
            if r + 1 < width:
                us.append(v)
                vs.append(v + length)
                ws.append(w_corridor)
    nxt = n_lattice
    for v in range(n_lattice):
        for _ in range(max(0, int(spurs))):
            us.append(v)
            vs.append(nxt)
            ws.append(w_spur)
            nxt += 1
    return Graph(
        nxt,
        np.array(us, dtype=np.int64),
        np.array(vs, dtype=np.int64),
        np.array(ws, dtype=np.float64),
        directed=directed,
    )


def _largest_component(g: Graph) -> Graph:
    """Restrict to the largest (weakly) connected component."""
    import collections

    comp = np.full(g.n, -1, dtype=np.int64)
    cid = 0
    for s in range(g.n):
        if comp[s] >= 0:
            continue
        q = collections.deque([s])
        comp[s] = cid
        while q:
            u = q.popleft()
            nbrs, _ = g.neighbors(u)
            for v in nbrs:
                if comp[v] < 0:
                    comp[v] = cid
                    q.append(v)
        cid += 1
    if cid == 1:
        return g
    sizes = np.bincount(comp)
    big = int(np.argmax(sizes))
    keep_v = np.nonzero(comp == big)[0]
    remap = np.full(g.n, -1, dtype=np.int64)
    remap[keep_v] = np.arange(keep_v.shape[0])
    mask = (comp[g.edge_u] == big) & (comp[g.edge_v] == big)
    return Graph(
        keep_v.shape[0],
        remap[g.edge_u[mask]],
        remap[g.edge_v[mask]],
        g.w0[mask],
        directed=g.directed,
    )


class WeightUpdateStream:
    """The [32]-style time-varying travel-time stream.

    Each ``next_batch()`` returns (eids, new_w): α·m random edges whose
    weights move by a multiplicative factor in [1-τ, 1+τ] relative to the
    *initial* weight (so weights stay road-like instead of drifting).
    """

    def __init__(self, graph: Graph, alpha: float = 0.5, tau: float = 0.5, seed: int = 0):
        self.graph = graph
        self.alpha = float(alpha)
        self.tau = float(tau)
        self.rng = np.random.default_rng(seed)

    def next_batch(self) -> tuple[np.ndarray, np.ndarray]:
        m = self.graph.m
        k = max(1, int(self.alpha * m))
        eids = self.rng.choice(m, size=k, replace=False)
        factor = 1.0 + self.rng.uniform(-self.tau, self.tau, size=k)
        new_w = np.maximum(0.25, self.graph.w0[eids] * factor)
        return eids, new_w
