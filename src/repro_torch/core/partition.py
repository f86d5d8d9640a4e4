"""Graph partitioning and boundary vertices (Section 3.3).

The paper partitions G by BFS into subgraphs of at most ``z`` vertices.
Subgraphs may *share vertices but not edges*; shared vertices are the
boundary vertices.

Implementation: BFS over vertices assigns every vertex a home block of
size ≤ z.  Every edge is then assigned to exactly one subgraph: an edge
inside a block goes to that block's subgraph; a cross-block edge
(u ∈ B_i, v ∈ B_j) is assigned to the currently smaller subgraph, whose
vertex set adopts the foreign endpoint.  A vertex that ends up in two or
more subgraphs is a boundary vertex.  Any path crossing subgraphs must
pass through a boundary vertex: consecutive path edges share a vertex,
and if the edges live in different subgraphs that vertex is in both.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .graph import Graph


@dataclasses.dataclass
class Subgraph:
    """A subgraph with a local dense vertex numbering (Definition 2)."""

    gid: int
    vertices: np.ndarray  # global vertex ids, int64[nv]
    edges: np.ndarray  # logical edge ids, int64[ne]
    # local CSR over local vertex ids (both half edges even when the parent
    # graph is directed the CSR is direction-faithful).
    indptr: np.ndarray
    nbr: np.ndarray  # local vertex ids
    eid: np.ndarray  # logical (global) edge ids
    boundary_local: np.ndarray  # local ids of boundary vertices
    g2l: dict  # global id → local id

    @property
    def nv(self) -> int:
        return int(self.vertices.shape[0])

    @property
    def ne(self) -> int:
        return int(self.edges.shape[0])

    def local_adjacency(self, w: np.ndarray, inf: float = np.inf) -> np.ndarray:
        """Dense [nv, nv] min-plus adjacency under weights ``w``."""
        a = np.full((self.nv, self.nv), inf, dtype=np.float64)
        np.fill_diagonal(a, 0.0)
        for u in range(self.nv):
            lo, hi = self.indptr[u], self.indptr[u + 1]
            for p in range(lo, hi):
                v = self.nbr[p]
                a[u, v] = min(a[u, v], w[self.eid[p]])
        return a


@dataclasses.dataclass
class Partition:
    subgraphs: list
    home_block: np.ndarray  # int64[n] BFS home block per vertex
    owner_sets: list  # per vertex, sorted tuple of subgraph gids
    is_boundary: np.ndarray  # bool[n]

    @property
    def n_subgraphs(self) -> int:
        return len(self.subgraphs)

    def subgraphs_of_vertex(self, v: int) -> tuple:
        return self.owner_sets[v]

    def subgraphs_of_pair(self, u: int, v: int) -> list:
        su, sv = set(self.owner_sets[u]), set(self.owner_sets[v])
        return sorted(su & sv)


def _bfs_blocks(graph: Graph, z: int, seed: int = 0) -> np.ndarray:
    """Assign every vertex a home block of ≤ z vertices by BFS growth."""
    n = graph.n
    block = np.full(n, -1, dtype=np.int64)
    order = np.arange(n)
    cur_block = 0
    cur_count = 0
    from collections import deque

    queue: deque = deque()
    scan = 0
    start = min(max(seed, 0), n - 1) if n else 0
    pending = [start]
    while True:
        if not queue:
            # find next unassigned seed (continue BFS wave from `pending`)
            seed_v = -1
            while pending:
                cand = pending.pop()
                if block[cand] < 0:
                    seed_v = cand
                    break
            if seed_v < 0:
                while scan < n and block[order[scan]] >= 0:
                    scan += 1
                if scan >= n:
                    break
                seed_v = int(order[scan])
            queue.append(seed_v)
            block[seed_v] = cur_block
            cur_count += 1
            if cur_count >= z:
                cur_block += 1
                cur_count = 0
        while queue:
            u = queue.popleft()
            nbrs, _ = graph.neighbors(u)
            for v in nbrs:
                v = int(v)
                if block[v] < 0:
                    if cur_count >= z:
                        pending.append(v)
                        continue
                    block[v] = cur_block
                    cur_count += 1
                    queue.append(v)
                    if cur_count >= z:
                        cur_block += 1
                        cur_count = 0
    return block


def partition_graph(graph: Graph, z: int, seed: int = 0) -> Partition:
    block = _bfs_blocks(graph, z, seed)
    n_blocks = int(block.max()) + 1 if graph.n else 0

    bu = block[graph.edge_u]
    bv = block[graph.edge_v]
    sub_vertices: list[set] = [set() for _ in range(n_blocks)]
    for v in range(graph.n):
        sub_vertices[block[v]].add(v)
    sub_edges: list[list] = [[] for _ in range(n_blocks)]

    # intra-block edges
    intra = np.nonzero(bu == bv)[0]
    for e in intra:
        sub_edges[bu[e]].append(int(e))
    # cross-block edges: adopt the foreign endpoint into the smaller subgraph
    cross = np.nonzero(bu != bv)[0]
    sizes = np.array([len(s) for s in sub_vertices], dtype=np.int64)
    for e in cross:
        i, j = int(bu[e]), int(bv[e])
        u, v = int(graph.edge_u[e]), int(graph.edge_v[e])
        tgt, adopted = (i, v) if sizes[i] <= sizes[j] else (j, u)
        sub_edges[tgt].append(int(e))
        if adopted not in sub_vertices[tgt]:
            sub_vertices[tgt].add(adopted)
            sizes[tgt] += 1

    # drop empty blocks (can happen on disconnected tails)
    keep = [b for b in range(n_blocks) if sub_edges[b] or len(sub_vertices[b]) > 1]

    owner_sets: list[list] = [[] for _ in range(graph.n)]
    subs: list[Subgraph] = []
    for new_gid, b in enumerate(keep):
        verts = np.array(sorted(sub_vertices[b]), dtype=np.int64)
        eids = np.array(sorted(sub_edges[b]), dtype=np.int64)
        g2l = {int(g): l for l, g in enumerate(verts)}
        # local CSR
        if graph.directed:
            h_src = graph.edge_u[eids]
            h_dst = graph.edge_v[eids]
            h_eid = eids
        else:
            h_src = np.concatenate([graph.edge_u[eids], graph.edge_v[eids]])
            h_dst = np.concatenate([graph.edge_v[eids], graph.edge_u[eids]])
            h_eid = np.concatenate([eids, eids])
        l_src = np.array([g2l[int(x)] for x in h_src], dtype=np.int64)
        l_dst = np.array([g2l[int(x)] for x in h_dst], dtype=np.int64)
        order = np.argsort(l_src, kind="stable")
        nv = verts.shape[0]
        counts = np.bincount(l_src, minlength=nv)
        indptr = np.zeros(nv + 1, dtype=np.int64)
        np.cumsum(counts, out=indptr[1:])
        subs.append(
            Subgraph(
                gid=new_gid,
                vertices=verts,
                edges=eids,
                indptr=indptr,
                nbr=l_dst[order],
                eid=h_eid[order],
                boundary_local=np.empty(0, dtype=np.int64),  # filled below
                g2l=g2l,
            )
        )
        for g in verts:
            owner_sets[int(g)].append(new_gid)

    is_boundary = np.array([len(s) > 1 for s in owner_sets], dtype=bool)
    owner_tuples = [tuple(s) for s in owner_sets]
    for sg in subs:
        sg.boundary_local = np.array(
            [sg.g2l[int(g)] for g in sg.vertices if is_boundary[int(g)]],
            dtype=np.int64,
        )
    return Partition(
        subgraphs=subs,
        home_block=block,
        owner_sets=owner_tuples,
        is_boundary=is_boundary,
    )
