"""The benchmark's road networks, weight feed and trips: frozen copies.

These are copies of ``repro_torch.data.roadnet``'s ``grid_road_network``,
``_largest_component`` and ``WeightUpdateStream`` and of the serving
smoke's ``local_trips``, kept here so that a change to the program cannot
change the yardstick.  They work on plain arrays (:class:`RoadNet`) and
import nothing of the program: the harness builds the program's graph
from these arrays and hands the same arrays and update batches to the
plain reference (``kspbench/reference.py``).
``kspbench/tests/test_kspbench_roadgen.py`` holds each copy to the
original on fixed seeds.
"""

from __future__ import annotations

import collections
import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class RoadNet:
    """A road network as arrays: ``n`` vertices, one logical edge
    (``edge_u[e]``, ``edge_v[e]``) of initial weight ``w0[e]`` each, and
    the CSR adjacency over both directions of an undirected edge (the
    program's ``core.graph.Graph`` layout: stable sort by source)."""

    n: int
    edge_u: np.ndarray
    edge_v: np.ndarray
    w0: np.ndarray
    directed: bool
    csr_indptr: np.ndarray
    csr_dst: np.ndarray
    csr_eid: np.ndarray

    @classmethod
    def from_edges(cls, n, edge_u, edge_v, w0, directed=False) -> "RoadNet":
        edge_u = np.asarray(edge_u, dtype=np.int64)
        edge_v = np.asarray(edge_v, dtype=np.int64)
        w0 = np.asarray(w0, dtype=np.float64)
        m = edge_u.shape[0]
        if directed:
            h_src, h_dst = edge_u, edge_v
            h_eid = np.arange(m, dtype=np.int64)
        else:
            h_src = np.concatenate([edge_u, edge_v])
            h_dst = np.concatenate([edge_v, edge_u])
            h_eid = np.concatenate([np.arange(m, dtype=np.int64)] * 2)
        order = np.argsort(h_src, kind="stable")
        indptr = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(np.bincount(h_src, minlength=n), out=indptr[1:])
        return cls(int(n), edge_u, edge_v, w0, bool(directed), indptr,
                   h_dst[order], h_eid[order])

    @property
    def m(self) -> int:
        return int(self.edge_u.shape[0])

    def neighbors(self, v: int) -> np.ndarray:
        return self.csr_dst[self.csr_indptr[v]:self.csr_indptr[v + 1]]


def grid_road_network(rows: int, cols: int, *, knockout: float = 0.08,
                      shortcut_frac: float = 0.03, w_low: int = 1,
                      w_high: int = 20, directed: bool = False,
                      seed: int = 0) -> RoadNet:
    """A rows x cols lattice with random knockouts and diagonal shortcuts,
    integer weights in [w_low, w_high], restricted to its largest
    component."""
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
        dr = rng.integers(1, 4, n_short)
        dc = rng.integers(1, 4, n_short)
        sv = np.minimum(n - 1, su + dr * cols + dc)
        ok = sv != su
        us = np.concatenate([us, su[ok]])
        vs = np.concatenate([vs, sv[ok]])

    lo = np.minimum(us, vs)
    hi = np.maximum(us, vs)
    _, idx = np.unique(lo * n + hi, return_index=True)
    us, vs = us[idx], vs[idx]

    w0 = rng.integers(w_low, w_high + 1, us.shape[0]).astype(np.float64)
    return _largest_component(RoadNet.from_edges(n, us, vs, w0, directed))


def _largest_component(g: RoadNet) -> RoadNet:
    """Restrict to the largest (weakly) connected component."""
    comp = np.full(g.n, -1, dtype=np.int64)
    cid = 0
    for s in range(g.n):
        if comp[s] >= 0:
            continue
        q = collections.deque([s])
        comp[s] = cid
        while q:
            u = q.popleft()
            for v in g.neighbors(u):
                if comp[v] < 0:
                    comp[v] = cid
                    q.append(v)
        cid += 1
    if cid == 1:
        return g
    big = int(np.argmax(np.bincount(comp)))
    keep_v = np.nonzero(comp == big)[0]
    remap = np.full(g.n, -1, dtype=np.int64)
    remap[keep_v] = np.arange(keep_v.shape[0])
    mask = (comp[g.edge_u] == big) & (comp[g.edge_v] == big)
    return RoadNet.from_edges(keep_v.shape[0], remap[g.edge_u[mask]],
                              remap[g.edge_v[mask]], g.w0[mask], g.directed)


class WeightUpdateStream:
    """The time-varying travel-time stream: each ``next_batch()`` moves
    alpha*m random edges to their *initial* weight times a factor drawn
    uniformly from [1-tau, 1+tau], clamped at 0.25."""

    def __init__(self, net: RoadNet, alpha: float = 0.5, tau: float = 0.5,
                 seed: int = 0):
        self.net = net
        self.alpha = float(alpha)
        self.tau = float(tau)
        self.rng = np.random.default_rng(seed)

    def next_batch(self) -> tuple[np.ndarray, np.ndarray]:
        m = self.net.m
        k = max(1, int(self.alpha * m))
        eids = self.rng.choice(m, size=k, replace=False)
        factor = 1.0 + self.rng.uniform(-self.tau, self.tau, size=k)
        new_w = np.maximum(0.25, self.net.w0[eids] * factor)
        return eids, new_w


def hop_counts(net: RoadNet, s: int, hi: int) -> np.ndarray:
    """Hops from ``s`` to every vertex within ``hi`` hops (-1 beyond)."""
    hops = np.full(net.n, -1)
    hops[s] = 0
    frontier = [s]
    for h in range(1, hi + 1):
        nxt = []
        for u in frontier:
            for v in net.neighbors(u):
                if hops[v] < 0:
                    hops[v] = h
                    nxt.append(int(v))
        frontier = nxt
    return hops


def local_trips(net: RoadNet, n: int, rng, lo: int = 8,
                hi: int = 16) -> list[tuple[int, int]]:
    """``n`` (s, t) pairs, t drawn among the vertices ``lo``..``hi`` hops
    from a random s (city-scale trips)."""
    out = []
    while len(out) < n:
        s = int(rng.integers(net.n))
        hops = hop_counts(net, s, hi)
        cand = np.nonzero((hops >= lo) & (hops <= hi))[0]
        if cand.size:
            out.append((s, int(rng.choice(cand))))
    return out
