"""Host-side single-source shortest path machinery.

Everything in the paper's control plane that needs an SSSP runs through
``dijkstra`` below.  It supports the residual-graph features Yen/PYen
need (banned vertices / banned directed edges), PYen's reuse
(A_D/A_P incumbent completion) and early termination (distance cap), and
FindKSP's A* heuristic.  The TPU data plane replaces this routine with
batched dense Bellman–Ford (see ``repro/engine``); this is the exact
reference.

A call in its plain form (no destination, bans, cap, heuristic or reuse:
the reverse shortest-path trees and the splice searches) runs a native
copy of the loop, ``csrc/sssp_host.cpp``, where its library builds on
this host; it returns the loop's ``dist`` and ``parent`` bit for bit.
Every other call, and every call on a host without the library, runs the
Python loop.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import heapq
import threading

import numpy as np

INF = float("inf")

#: plain-form ``dijkstra`` calls by route: "native" (``csrc/sssp_host.cpp``)
#: or "python" (the loop, where the library is missing or refuses the view)
ROUTE_CALLS = {"native": 0, "python": 0}
_ROUTE_LOCK = threading.Lock()


@dataclasses.dataclass
class CSRView:
    """A CSR adjacency with per-half-edge weights."""

    n: int
    indptr: np.ndarray
    nbr: np.ndarray
    hw: np.ndarray  # half-edge weights aligned with nbr

    def reversed(self) -> "CSRView":
        """Reverse all half edges (for reverse SPTs on directed graphs)."""
        src = np.repeat(np.arange(self.n), np.diff(self.indptr))
        order = np.argsort(self.nbr, kind="stable")
        r_src = self.nbr[order]
        counts = np.bincount(r_src, minlength=self.n)
        indptr = np.zeros(self.n + 1, dtype=np.int64)
        np.cumsum(counts, out=indptr[1:])
        return CSRView(self.n, indptr, src[order], self.hw[order])


def subgraph_view(sg, w: np.ndarray) -> CSRView:
    return CSRView(sg.nv, sg.indptr, sg.nbr, w[sg.eid])


def graph_view(graph) -> CSRView:
    return CSRView(graph.n, graph.csr_indptr, graph.csr_dst, graph.w[graph.csr_eid])


def dijkstra(
    view: CSRView,
    src: int,
    dst: int | None = None,
    banned_vertices=None,
    banned_edges=None,
    cap: float = INF,
    heuristic=None,
    reuse=None,
):
    """Dijkstra / A* with Yen-style bans, cap pruning and path reuse.

    banned_vertices : bool ndarray or set — vertices that may not appear.
    banned_edges    : set[(u, v)] directed half-edge bans.
    cap             : prune states with f ≥ cap (PYen early termination).
    heuristic       : admissible h(v) (FindKSP A*); None = Dijkstra.
    reuse           : (A_D, A_P, valid_fn) — cached dist/next-hop to ``dst``;
                      when popping h with A_D[h] < inf and valid_fn(path) the
                      completion d[h]+A_D[h] becomes an incumbent upper
                      bound; search exits once heap-top ≥ incumbent.

    Returns (dist ndarray, parent ndarray, best) where ``best`` is the
    destination distance (inf if unreachable / pruned).  When reuse closes
    the search, parents along the cached suffix are patched so path
    reconstruction works.
    """
    if (dst is None and banned_vertices is None and banned_edges is None
            and cap == INF and heuristic is None and reuse is None):
        native = _native_dijkstra(view, src)
        with _ROUTE_LOCK:
            ROUTE_CALLS["python" if native is None else "native"] += 1
        if native is not None:
            return native[0], native[1], INF
    n = view.n
    dist = np.full(n, INF)
    parent = np.full(n, -1, dtype=np.int64)
    if banned_vertices is not None and not isinstance(banned_vertices, np.ndarray):
        bv = np.zeros(n, dtype=bool)
        for v in banned_vertices:
            bv[v] = True
        banned_vertices = bv
    if banned_vertices is not None and banned_vertices[src]:
        return dist, parent, INF
    h0 = heuristic(src) if heuristic else 0.0
    dist[src] = 0.0
    heap = [(h0, src)]
    incumbent = INF
    incumbent_from = -1
    while heap:
        f, u = heapq.heappop(heap)
        if f >= min(cap, incumbent):
            break
        du = dist[u]
        if f > du + (heuristic(u) if heuristic else 0.0) + 1e-12:
            continue  # stale entry
        if dst is not None and u == dst:
            break
        if reuse is not None and dst is not None:
            a_d, a_p, valid_fn = reuse
            if a_d[u] < INF and du + a_d[u] < incumbent:
                # the in-progress tree path src→u (the cached suffix must
                # not revisit it, or the combined path would contain a loop)
                tree_set = set()
                x = u
                while x >= 0:
                    tree_set.add(int(x))
                    x = parent[x] if x != src else -1
                if valid_fn(u, tree_set):
                    incumbent = du + a_d[u]
                    incumbent_from = u
        lo, hi = view.indptr[u], view.indptr[u + 1]
        for p in range(lo, hi):
            v = int(view.nbr[p])
            if banned_vertices is not None and banned_vertices[v]:
                continue
            if banned_edges and (u, v) in banned_edges:
                continue
            nd = du + float(view.hw[p])
            if nd < dist[v] - 1e-15:
                dist[v] = nd
                parent[v] = u
                fv = nd + (heuristic(v) if heuristic else 0.0)
                if fv < min(cap, incumbent):
                    heapq.heappush(heap, (fv, v))
    best = INF if dst is None else dist[dst]
    if dst is not None and incumbent < best:
        # patch parents along the cached suffix incumbent_from → dst
        a_d, a_p, _ = reuse
        u = incumbent_from
        d_here = dist[u]
        while u != dst:
            v = int(a_p[u])
            d_here = d_here + (a_d[u] - a_d[v])
            if d_here < dist[v]:
                dist[v] = d_here
                parent[v] = u
            u = v
        best = dist[dst]
    return dist, parent, best


@functools.cache
def _native_fn():
    """``sssp_dijkstra`` of ``csrc/sssp_host.cpp``, built at first use;
    None where the host cannot build or load it."""
    from ..kernels import _build

    lib = _build.host_library("sssp_host")
    if lib is None:
        return None
    fn = lib.sssp_dijkstra
    i64, f64 = ctypes.c_int64, ctypes.c_double
    fn.argtypes = [i64, i64, ctypes.POINTER(i64), ctypes.POINTER(i64),
                   ctypes.POINTER(f64), i64, ctypes.POINTER(f64),
                   ctypes.POINTER(i64)]
    fn.restype = ctypes.c_int
    return fn


def _as_array(a, dtype, kinds: str):
    """``a`` as a contiguous 1-D ``dtype`` array (no copy where it is one
    already), or None unless its dtype is of ``kinds``: integers and
    floats widen exactly to int64 and float64."""
    a = np.asarray(a)
    if a.ndim != 1 or a.dtype.kind not in kinds:
        return None
    return np.ascontiguousarray(a, dtype=dtype)


def _native_dijkstra(view: CSRView, src):
    """The plain form's (dist, parent) from the native loop, or None where
    the library is missing or the view is not one it takes (the Python
    loop then runs, and raises where it would have raised)."""
    fn = _native_fn()
    if fn is None or not isinstance(src, (int, np.integer)):
        return None
    n, src = int(view.n), int(src)
    indptr = _as_array(view.indptr, np.int64, "iu")
    nbr = _as_array(view.nbr, np.int64, "iu")
    hw = _as_array(view.hw, np.float64, "iuf")
    if (indptr is None or nbr is None or hw is None
            or indptr.shape[0] != n + 1 or hw.shape != nbr.shape
            or not 0 <= src < n):
        return None
    dist = np.empty(n, dtype=np.float64)
    parent = np.empty(n, dtype=np.int64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    f64p = ctypes.POINTER(ctypes.c_double)
    err = fn(n, nbr.shape[0], indptr.ctypes.data_as(i64p),
             nbr.ctypes.data_as(i64p), hw.ctypes.data_as(f64p), src,
             dist.ctypes.data_as(f64p), parent.ctypes.data_as(i64p))
    return None if err else (dist, parent)


def extract_path(parent: np.ndarray, src: int, dst: int) -> list[int] | None:
    path = [dst]
    v = dst
    guard = parent.shape[0] + 1
    while v != src:
        v = int(parent[v])
        if v < 0 or len(path) > guard:
            return None
        path.append(v)
    return path[::-1]


def reverse_spt(view: CSRView, dst: int, directed: bool):
    """Shortest distance + next-hop from every vertex TO ``dst``.

    Returns (A_D, A_P): A_D[v] = dist(v→dst), A_P[v] = next vertex after v
    on a shortest v→dst path (the paper's PYen arrays, Section 5.3.2).
    """
    rview = view.reversed() if directed else view
    dist, parent, _ = dijkstra(rview, dst)
    a_p = parent  # parent in the reverse tree IS the next hop toward dst
    return dist, a_p
