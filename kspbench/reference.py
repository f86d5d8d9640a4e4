"""The plain reference and the comparison that decides ``correct``.

The reference is Yen's k shortest simple paths, in plain Python and
NumPy, on the weights of the epoch an answer is stamped with.  It takes
the network as the arrays of ``kspbench/roadgen.py`` and replays the
traffic's update batches itself; it imports nothing of the program and
takes nothing the program built.

Each spur search is an A* search whose heuristic is the exact distance
to the target on the unmasked graph (one reverse Dijkstra per target and
epoch): removing edges and vertices only lengthens distances, so the
heuristic stays admissible and consistent and every spur path found is
a shortest one.

The comparison (:func:`judge`) holds each answer to the configuration's
guarantee: the answer's paths are the k shortest simple s-t paths under
the weights of the epoch stamped on it, and that epoch lies between the
service's epoch when the query was submitted and when it was answered.
It yields the numbers that ``correct`` compares, each against a limit:

* ``wrong_answers``: answers with a path that is not a simple s-t path
  of the graph, a repeated path, fewer paths than the reference finds,
  or an epoch stamp outside that range (limit 0);
* ``dist_gap``: the widest relative gap between a served length and the
  reference's length of the same rank, or between a served length and
  the served path's own length under the stamped epoch's weights;
* ``unanswered``: queries due in the window that never got an answer
  (limit 0).

:func:`k_shortest_walks` is the control: the same search with the
simple-path guarantee dropped (loops allowed), the shortcut a walk-based
reference stream invites.
"""

from __future__ import annotations

import heapq
import math

import numpy as np

INF = math.inf


class Adjacency:
    """Out- and in-neighbour lists ``[(v, eid), ...]`` of a network given
    as ``n``, ``edge_u``, ``edge_v`` (undirected unless ``directed``)."""

    def __init__(self, n, edge_u, edge_v, directed=False):
        self.n = int(n)
        self.out = [[] for _ in range(self.n)]
        self.inn = self.out if not directed else [[] for _ in range(self.n)]
        for e, (u, v) in enumerate(zip(np.asarray(edge_u).tolist(),
                                       np.asarray(edge_v).tolist())):
            self.out[u].append((v, e))
            if directed:
                self.inn[v].append((u, e))
            else:
                self.out[v].append((u, e))
        self.edge_of = {}
        for u in range(self.n):
            for v, e in self.out[u]:
                self.edge_of[(u, v)] = e


def weights_at(w0, batches, applied: int) -> np.ndarray:
    """The weights after the first ``applied`` update batches, each a
    pair (eids, new_w) applied in order, last write winning."""
    w = np.array(w0, dtype=np.float64, copy=True)
    for eids, new_w in batches[:applied]:
        w[np.asarray(eids, dtype=np.int64)] = np.asarray(new_w, np.float64)
    return w


def dist_to(adj: Adjacency, w, t: int) -> list[float]:
    """Exact distance from every vertex to ``t`` (reverse Dijkstra)."""
    dist = [INF] * adj.n
    dist[t] = 0.0
    heap = [(0.0, t)]
    while heap:
        d, u = heapq.heappop(heap)
        if d > dist[u]:
            continue
        for v, e in adj.inn[u]:
            nd = d + w[e]
            if nd < dist[v]:
                dist[v] = nd
                heapq.heappush(heap, (nd, v))
    return dist


def _astar(adj, w, h, s, t, banned_v, banned_e):
    """Shortest s-t path avoiding the vertices ``banned_v`` and the
    directed hops ``banned_e`` out of ``s``; None when there is none."""
    if h[s] == INF:
        return None
    g = {s: 0.0}
    parent = {s: None}
    heap = [(h[s], 0.0, s)]
    closed = set()
    while heap:
        _, d, u = heapq.heappop(heap)
        if u in closed:
            continue
        if u == t:
            path = [u]
            while parent[path[-1]] is not None:
                path.append(parent[path[-1]])
            return path[::-1]
        closed.add(u)
        for v, e in adj.out[u]:
            if v in banned_v or v in closed:
                continue
            if u == s and (u, v) in banned_e:
                continue
            nd = d + w[e]
            if nd < g.get(v, INF) and h[v] < INF:
                g[v] = nd
                parent[v] = u
                heapq.heappush(heap, (nd + h[v], nd, v))
    return None


def path_length(adj: Adjacency, w, path) -> float:
    """Sum of the path's edge weights, in path order (None if a hop is no
    edge of the graph)."""
    total = 0.0
    for a, b in zip(path, path[1:]):
        e = adj.edge_of.get((a, b))
        if e is None:
            return None
        total += w[e]
    return total


def ksp(adj: Adjacency, w, s: int, t: int, k: int, h=None):
    """Yen's k shortest simple s-t paths: [(length, path tuple)],
    ascending by length, at most k.  ``h`` is ``dist_to(adj, w, t)``
    when the caller already has it."""
    if h is None:
        h = dist_to(adj, w, t)
    if s == t:
        return [(0.0, (s,))]
    first = _astar(adj, w, h, s, t, set(), set())
    if first is None:
        return []
    found = [(path_length(adj, w, first), tuple(first))]
    seen = {found[0][1]}
    cand: list = []
    while len(found) < k:
        prev = found[-1][1]
        for j in range(len(prev) - 1):
            root = prev[:j + 1]
            spur = prev[j]
            banned_e = {(spur, p[j + 1]) for _, p in found
                        if len(p) > j + 1 and p[:j + 1] == root}
            tail = _astar(adj, w, h, spur, t, set(root[:-1]), banned_e)
            if tail is None:
                continue
            full = root[:-1] + tuple(tail)
            if full not in seen:
                seen.add(full)
                heapq.heappush(cand, (path_length(adj, w, full), full))
        if not cand:
            break
        found.append(heapq.heappop(cand))
    return found


def k_shortest_walks(adj: Adjacency, w, s: int, t: int, k: int, h=None):
    """The control: the k shortest s-t walks, loops allowed (each vertex
    settled at most k times, A* order on the same heuristic)."""
    if h is None:
        h = dist_to(adj, w, t)
    if h[s] == INF:
        return []
    count = [0] * adj.n
    heap = [(h[s], 0.0, (s,))]
    out = []
    while heap and len(out) < k:
        _, d, path = heapq.heappop(heap)
        u = path[-1]
        if count[u] >= k:
            continue
        count[u] += 1
        if u == t:
            out.append((d, path))
        for v, e in adj.out[u]:
            if h[v] < INF:
                nd = d + w[e]
                heapq.heappush(heap, (nd + h[v], nd, path + (v,)))
    return out


def _rel(a: float, b: float) -> float:
    if a == b:
        return 0.0
    return abs(a - b) / max(abs(b), 1e-300)


def judge(adj: Adjacency, w0, batches, answers, *,
          epoch_base: int = 0) -> dict:
    """Hold every answer to the reference; returns the compared numbers.

    ``answers``: dicts with ``s``, ``t``, ``k``, ``paths`` ([(length,
    vertex tuple)]), ``epoch`` (stamped), ``epoch_lo`` / ``epoch_hi``
    (the service's epoch at submit and at answer).  Epoch ``e`` means
    the first ``e - epoch_base`` of ``batches`` are applied to ``w0``.
    ``first_wrong`` and ``widest_gap`` in the result describe the first
    wrong answer and the answer with the widest gap."""
    wrong = 0
    gap = 0.0
    first_wrong = worst = None
    by_epoch: dict = {}
    for a in answers:
        by_epoch.setdefault(int(a["epoch"]), []).append(a)
    for epoch, group in sorted(by_epoch.items()):
        applied = epoch - epoch_base
        valid_epoch = 0 <= applied <= len(batches)
        w = weights_at(w0, batches, max(0, min(applied, len(batches))))
        wl = w.tolist()
        heur: dict = {}
        for a in group:
            s, t, k = int(a["s"]), int(a["t"]), int(a["k"])
            if t not in heur:
                heur[t] = dist_to(adj, wl, t)
            want = ksp(adj, wl, s, t, k, heur[t])
            got = [(float(d), tuple(int(v) for v in p)) for d, p in a["paths"]]
            bad = (not valid_epoch
                   or not a["epoch_lo"] <= epoch <= a["epoch_hi"]
                   or len(got) != len(want)
                   or len({p for _, p in got}) != len(got))
            for (d, p), (wd, _) in zip(sorted(got), want):
                own = (path_length(adj, wl, p)
                       if len(set(p)) == len(p) and p[0] == s and p[-1] == t
                       else None)
                if own is None:
                    bad = True
                    continue
                g = max(_rel(d, wd), _rel(d, own))
                if g > gap:
                    gap = g
                    worst = {"s": s, "t": t, "epoch": epoch, "served": d,
                             "path_length": own, "reference": wd,
                             "epoch_lo": a["epoch_lo"],
                             "epoch_hi": a["epoch_hi"]}
            if bad:
                wrong += 1
                if first_wrong is None:
                    first_wrong = {"s": s, "t": t, "epoch": epoch,
                                   "got": [d for d, _ in got],
                                   "want": [d for d, _ in want]}
    return {"wrong_answers": wrong, "dist_gap": gap,
            "checked": len(answers), "first_wrong": first_wrong,
            "widest_gap": worst}


#: the limit of each number the check compares; PERF.md gives the
#: readings of sound runs and of the control that each was set between
LIMITS = {"wrong_answers": 0, "dist_gap": 1e-4, "unanswered": 0}
