"""Dynamic weighted graph substrate (Definition 1 of the paper).

A ``Graph`` stores a static topology (vertices, edges) plus *dynamic*
edge weights.  Undirected graphs store one logical edge per vertex pair;
the CSR adjacency materializes both half-edges, each carrying the logical
edge id so a weight update touches both directions at once (the paper's
"identical changes to the weights of the two edges in opposite direction").

Weights evolve over time (Definition 1's Δw); ``snapshot()`` returns the
current-weight buffer G_curr the paper uses to give queries unambiguous
semantics.

Virtual fragments (Section 3.4): every edge e carries ``vfrag[e] =
max(1, round(w0[e]))`` fragments, fixed forever; the *unit weight* of e is
``w[e] / vfrag[e]`` and changes with the weight.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable

import numpy as np


@dataclasses.dataclass
class Snapshot:
    """An immutable weight snapshot with a timestamp (Section 2)."""

    version: int
    w: np.ndarray  # float64[E] logical-edge weights


def dedupe_updates(
    eids: np.ndarray, new_w: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Last-write-wins de-duplication of one Δw batch.

    A batch repeating an eid must behave as if only its final value were
    present: incremental maintenance computes per-edge deltas against the
    pre-batch weights, so a duplicated eid would otherwise double-count
    its delta (``DTLP.apply_updates`` feeds ``update_actual_distances``).
    Output is one entry per unique eid; order is preserved when the
    batch is already duplicate-free.
    """
    eids = np.asarray(eids, dtype=np.int64)
    new_w = np.asarray(new_w, dtype=np.float64)
    uniq, first_rev = np.unique(eids[::-1], return_index=True)
    if uniq.shape[0] == eids.shape[0]:
        return eids, new_w
    last = eids.shape[0] - 1 - first_rev  # last occurrence per unique eid
    return eids[last], new_w[last]


class Graph:
    def __init__(
        self,
        n: int,
        edge_u: np.ndarray,
        edge_v: np.ndarray,
        w0: np.ndarray,
        directed: bool = False,
    ):
        edge_u = np.asarray(edge_u, dtype=np.int64)
        edge_v = np.asarray(edge_v, dtype=np.int64)
        w0 = np.asarray(w0, dtype=np.float64)
        if not (edge_u.shape == edge_v.shape == w0.shape):
            raise ValueError("edge arrays must have identical shapes")
        if np.any(w0 <= 0):
            raise ValueError("edge weights must be positive")
        if np.any(edge_u == edge_v):
            raise ValueError("self loops are not supported")
        self.n = int(n)
        self.m = int(edge_u.shape[0])
        self.directed = bool(directed)
        self.edge_u = edge_u
        self.edge_v = edge_v
        self.w0 = w0.copy()
        self.w = w0.copy()
        self.vfrag = np.maximum(1, np.rint(w0)).astype(np.int64)
        self._version = 0
        # double-buffered epochs: the previous epoch's full weight
        # buffer, kept alive across exactly one update commit so
        # in-flight queries admitted at epoch e can still be refined
        # against e's weights while e+1 serves new admissions
        self._prev_w: np.ndarray | None = None
        self._prev_version = -1
        self._build_csr()

    # ------------------------------------------------------------------ CSR
    def _build_csr(self) -> None:
        if self.directed:
            h_src = self.edge_u
            h_dst = self.edge_v
            h_eid = np.arange(self.m, dtype=np.int64)
        else:
            h_src = np.concatenate([self.edge_u, self.edge_v])
            h_dst = np.concatenate([self.edge_v, self.edge_u])
            h_eid = np.concatenate([np.arange(self.m, dtype=np.int64)] * 2)
        order = np.argsort(h_src, kind="stable")
        self.csr_dst = h_dst[order]
        self.csr_eid = h_eid[order]
        counts = np.bincount(h_src, minlength=self.n)
        self.csr_indptr = np.zeros(self.n + 1, dtype=np.int64)
        np.cumsum(counts, out=self.csr_indptr[1:])

    def neighbors(self, v: int) -> tuple[np.ndarray, np.ndarray]:
        """(neighbor vertices, logical edge ids) of v."""
        lo, hi = self.csr_indptr[v], self.csr_indptr[v + 1]
        return self.csr_dst[lo:hi], self.csr_eid[lo:hi]

    @property
    def degree(self) -> np.ndarray:
        return np.diff(self.csr_indptr)

    # ------------------------------------------------------------ dynamics
    @property
    def unit_weight(self) -> np.ndarray:
        return self.w / self.vfrag

    def apply_updates(self, eids: np.ndarray, new_w: np.ndarray) -> None:
        """Apply a batch of weight changes (the Δw stream).

        The pre-batch weight buffer survives as the previous epoch's
        (``w_at``) until the next batch lands — the fence the streaming
        update path relies on to keep epoch-e queries refinable after
        the e+1 swap commits.
        """
        eids = np.asarray(eids, dtype=np.int64)
        new_w = np.asarray(new_w, dtype=np.float64)
        if np.any(new_w <= 0):
            raise ValueError("updated weights must stay positive")
        self._prev_w = self.w.copy()
        self._prev_version = self._version
        self.w[eids] = new_w
        self._version += 1

    def w_at(self, epoch: int) -> np.ndarray:
        """The weight buffer of ``epoch`` — current or the one epoch the
        double buffer retains.  Anything older is unreachable (raises):
        the streaming commit gate guarantees no in-flight query lags by
        more than one epoch."""
        epoch = int(epoch)
        if epoch == self._version:
            return self.w
        if epoch == self._prev_version and self._prev_w is not None:
            return self._prev_w
        raise KeyError(
            f"epoch {epoch} weights unavailable (current {self._version}, "
            f"buffered {self._prev_version})"
        )

    def snapshot(self) -> Snapshot:
        return Snapshot(version=self._version, w=self.w.copy())

    @property
    def version(self) -> int:
        return self._version

    @property
    def epoch(self) -> int:
        """Serving-stack name for the weight version: bumped once per
        applied update batch, stamped on worker slabs and query results
        so a consumer always knows which graph state answered it."""
        return self._version

    def advance_epoch_to(self, epoch: int) -> None:
        """Fast-forward the epoch counter (checkpoint restore: the
        snapshot's weights are replayed as ONE batch, but the restored
        graph must report the ORIGINAL epoch or restored results would
        disagree with pre-checkpoint ones).  Never moves backwards."""
        epoch = int(epoch)
        if epoch < self._version:
            raise ValueError(
                f"cannot rewind epoch {self._version} to {epoch}"
            )
        self._version = epoch

    # --------------------------------------------------------------- algos
    def path_distance(self, vertices: Iterable[int]) -> float:
        """Distance of a path given as a vertex sequence (Definition 3)."""
        verts = list(vertices)
        total = 0.0
        for a, b in zip(verts, verts[1:]):
            eid = self.find_edge(a, b)
            if eid < 0:
                raise ValueError(f"({a},{b}) is not an edge")
            total += float(self.w[eid])
        return total

    def find_edge(self, a: int, b: int) -> int:
        nbrs, eids = self.neighbors(a)
        hits = np.nonzero(nbrs == b)[0]
        if hits.size == 0:
            return -1
        # parallel edges: return the currently lightest one
        return int(eids[hits[np.argmin(self.w[eids[hits]])]])

    def path_edges(self, vertices: Iterable[int]) -> list[int]:
        verts = list(vertices)
        return [self.find_edge(a, b) for a, b in zip(verts, verts[1:])]

    def to_networkx(self):
        import networkx as nx

        g = nx.DiGraph() if self.directed else nx.Graph()
        g.add_nodes_from(range(self.n))
        for i in range(self.m):
            u, v = int(self.edge_u[i]), int(self.edge_v[i])
            w = float(self.w[i])
            if g.has_edge(u, v):  # keep lightest parallel edge
                w = min(w, g[u][v]["weight"])
            g.add_edge(u, v, weight=w)
        return g
