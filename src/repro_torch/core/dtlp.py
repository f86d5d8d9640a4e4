"""DTLP: the Distributed Two-Level Path index (Sections 3–4).

Level 1 (per subgraph): bounding paths between boundary-vertex pairs,
their vfrag counts φ, current actual distances D (maintained
incrementally through EBP-II / G-MPTree) and bound distances BD
(recomputed from the subgraph's sorted unit-weight profile).

Level 2: the skeleton graph G_λ over all boundary vertices, edge weight
= minimum lower bound distance (MBD) across the subgraphs containing
the pair.  G_λ is small and replicated in the distributed runtime.

The index keeps the paper's lower bounds (``lbd_mode``) in every
subgraph whose unit weights are all 1, as a build on integer weights
leaves them.  A subgraph with another unit weight, from a build on other
weights or after an update batch moved its weights, has each of its
bounds capped at the pair's exact distance (``core.bound_refresh``):
Theorem 1's bound is kept where it is sound and lowered where it leaks.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from repro_torch import obs

from .bound_refresh import PairDistances
from .bounding import (
    INF,
    bound_distances,
    extract_level_path,
    kdistinct_walk_dp,
    lower_bound_distances_vec,
    unit_weight_profile,
)
from .ebp import EBPII
from .graph import Graph, dedupe_updates
from .lsh import lsh_groups, minhash_signatures
from .mptree import GMPTree
from .partition import Partition, Subgraph, partition_graph
from .sssp import CSRView


@dataclasses.dataclass
class SubgraphIndex:
    """Level-1 index of one subgraph."""

    sg: Subgraph
    pairs: np.ndarray  # [n_pairs, 2] local boundary ids
    pair_ptr: np.ndarray  # CSR [n_pairs+1] into path arrays
    path_phi: np.ndarray  # int64[n_paths]
    path_D: np.ndarray  # float64[n_paths] (+inf when no representative)
    path_BD: np.ndarray  # float64[n_paths]
    path_vertices: list  # local-vertex paths or None
    path_edges: list  # global-eid arrays or None
    storage: object  # EBPII or GMPTree
    profile: object  # UnitWeightProfile
    lbd: np.ndarray  # float64[n_pairs]

    def rebuild_bounds(self, graph: Graph, mode: str,
                       exact: np.ndarray) -> int:
        """Refresh BDs (all paths) and per-pair LBDs after weight change,
        each LBD capped at the pair's ``exact`` distance; returns the
        pairs the cap lowered."""
        self.profile = unit_weight_profile(
            graph.w[self.sg.edges], graph.vfrag[self.sg.edges]
        )
        self.path_BD = bound_distances(self.profile, self.path_phi)
        self.lbd, capped = capped_bounds(lower_bound_distances_vec(
            self.pair_ptr, self.path_D, self.path_BD, mode=mode), exact)
        return capped

    def update_actual_distances(self, eids: np.ndarray, delta: np.ndarray) -> None:
        """D[p] += Δw for every path containing an updated edge (EBP-II)."""
        for e, dw in zip(eids, delta):
            pids = self.storage.paths_containing(int(e))
            if pids.shape[0]:
                self.path_D[pids] += dw


class SkeletonGraph:
    """G_λ with contribution tracking for incremental weight refresh."""

    def __init__(self, n_vertices_global: int, directed: bool):
        self.directed = directed
        self.g2s = np.full(n_vertices_global, -1, dtype=np.int64)
        self.s2g = np.empty(0, dtype=np.int64)
        self.edge_i = np.empty(0, dtype=np.int64)  # skeleton vertex ids
        self.edge_j = np.empty(0, dtype=np.int64)
        self.weight = np.empty(0, dtype=np.float64)
        # contributions: (edge idx) ← (subgraph gid, pair idx)
        self.contrib_edge: np.ndarray | None = None
        self.contrib_sub: np.ndarray | None = None
        self.contrib_pair: np.ndarray | None = None
        # delta-scoped refresh state: per-contribution LBD values as of
        # the last refresh, plus an edge → contributions CSR (built
        # lazily on first partial refresh)
        self._contrib_vals: np.ndarray | None = None
        self._edge_contrib_ptr: np.ndarray | None = None
        self._edge_contrib_idx: np.ndarray | None = None
        self._view: CSRView | None = None
        self._view_version = -1
        self._version = 0

    @property
    def n(self) -> int:
        return int(self.s2g.shape[0])

    def finalize(self, sub_indexes: list) -> None:
        """Collect contributions and compute edge weights."""
        tuples = []  # (gi, gj, sub, pair)
        for si in sub_indexes:
            verts = si.sg.vertices
            for pidx in range(si.pairs.shape[0]):
                li, lj = si.pairs[pidx]
                tuples.append((int(verts[li]), int(verts[lj]), si.sg.gid, pidx))
        if not tuples:
            return
        arr = np.array(tuples, dtype=np.int64)
        gi, gj = arr[:, 0], arr[:, 1]
        if not self.directed:
            lo = np.minimum(gi, gj)
            hi = np.maximum(gi, gj)
            gi, gj = lo, hi
        key = gi * (self.g2s.shape[0] + 1) + gj
        uniq, inv = np.unique(key, return_inverse=True)
        self.contrib_edge = inv.astype(np.int64)
        self.contrib_sub = arr[:, 2].copy()
        self.contrib_pair = arr[:, 3].copy()
        first = np.zeros(uniq.shape[0], dtype=np.int64)
        first[inv[::-1]] = np.arange(arr.shape[0])[::-1]
        self.edge_i = gi[first]
        self.edge_j = gj[first]
        # skeleton vertex numbering over all endpoint vertices
        sverts = np.unique(np.concatenate([self.edge_i, self.edge_j]))
        self.s2g = sverts
        self.g2s[sverts] = np.arange(sverts.shape[0])
        self.edge_i = self.g2s[self.edge_i]
        self.edge_j = self.g2s[self.edge_j]
        self.weight = np.full(uniq.shape[0], INF)

    def refresh_weights(self, sub_indexes: list) -> None:
        """weight(edge) = min over contributions of the subgraph-pair LBD."""
        vals = np.empty(self.contrib_edge.shape[0])
        for s, si in enumerate(sub_indexes):
            mask = self.contrib_sub == si.sg.gid
            vals[mask] = si.lbd[self.contrib_pair[mask]]
        self.weight.fill(INF)
        np.minimum.at(self.weight, self.contrib_edge, vals)
        self._contrib_vals = vals
        self._version += 1

    # ------------------------------------------------- delta-scoped refresh
    def _contrib_csr(self) -> tuple[np.ndarray, np.ndarray]:
        """Lazy edge → contribution-index CSR (topology-fixed)."""
        if self._edge_contrib_ptr is None:
            order = np.argsort(self.contrib_edge, kind="stable")
            counts = np.bincount(self.contrib_edge,
                                 minlength=self.weight.shape[0])
            ptr = np.zeros(self.weight.shape[0] + 1, dtype=np.int64)
            np.cumsum(counts, out=ptr[1:])
            self._edge_contrib_ptr = ptr
            self._edge_contrib_idx = order.astype(np.int64)
        return self._edge_contrib_ptr, self._edge_contrib_idx

    def plan_partial_refresh(self, new_lbds: dict):
        """Stage a delta-scoped weight refresh WITHOUT mutating state.

        ``new_lbds`` maps touched gid → that subgraph's post-update LBD
        array.  Only skeleton edges carrying a contribution from a
        touched subgraph are recomputed; their new value is the min over
        the edge's FULL contribution set (new LBDs for touched
        subgraphs, the stored ``_contrib_vals`` for the rest) — bitwise
        what a wholesale ``refresh_weights`` would produce, since min
        over the same float set is order-independent.

        Returns ``(affected_edges, new_edge_w, changes, touched_idx,
        touched_vals)`` where ``changes`` is ``[(u, v, old, new)]`` in
        skeleton vertex ids for edges whose weight actually moved, and
        the last two arrays are the contribution-value writes
        ``commit_partial_refresh`` applies.
        """
        if self.contrib_edge is None or self._contrib_vals is None:
            empty = np.empty(0, dtype=np.int64)
            return empty, np.empty(0), [], empty, np.empty(0)
        ptr, idx = self._contrib_csr()
        t_parts = []
        v_parts = []
        for gid, lbd in new_lbds.items():
            m = np.nonzero(self.contrib_sub == int(gid))[0]
            t_parts.append(m)
            v_parts.append(lbd[self.contrib_pair[m]])
        touched_idx = (np.concatenate(t_parts) if t_parts
                       else np.empty(0, dtype=np.int64))
        touched_vals = np.concatenate(v_parts) if v_parts else np.empty(0)
        staged = self._contrib_vals.copy()
        staged[touched_idx] = touched_vals
        # per-edge min over the full contribution set (every skeleton
        # edge has ≥ 1 contribution, so no empty reduceat segments)
        per_edge = np.minimum.reduceat(staged[idx], ptr[:-1])
        affected = np.unique(self.contrib_edge[touched_idx])
        new_edge_w = per_edge[affected]
        moved = affected[new_edge_w != self.weight[affected]]
        changes = [
            (int(self.edge_i[e]), int(self.edge_j[e]),
             float(self.weight[e]), float(per_edge[e]))
            for e in moved
        ]
        return affected, new_edge_w, changes, touched_idx, touched_vals

    def commit_partial_refresh(self, affected, new_edge_w,
                               touched_idx, touched_vals) -> None:
        """Apply a staged partial refresh: pure array writes + version
        bump (the streaming path's pointer-swap moment)."""
        self._contrib_vals[touched_idx] = touched_vals
        self.weight[affected] = new_edge_w
        self._version += 1

    def view(self) -> CSRView:
        """CSRView of G_λ (rebuilt lazily after weight refreshes)."""
        if self._view is not None and self._view_version == self._version:
            return self._view
        n = self.n
        if self.directed:
            h_src = self.edge_i
            h_dst = self.edge_j
            h_w = self.weight
        else:
            h_src = np.concatenate([self.edge_i, self.edge_j])
            h_dst = np.concatenate([self.edge_j, self.edge_i])
            h_w = np.concatenate([self.weight, self.weight])
        order = np.argsort(h_src, kind="stable")
        counts = np.bincount(h_src, minlength=n)
        indptr = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(counts, out=indptr[1:])
        self._view = CSRView(n, indptr, h_dst[order], h_w[order])
        self._view_version = self._version
        return self._view


@dataclasses.dataclass
class UpdatePlan:
    """Everything one update batch will change, staged off to the side.

    ``DTLP.prepare_updates`` computes the plan against live state
    without mutating it — queries keep serving the current epoch while
    the plan is built — and ``DTLP.commit_updates`` installs it as
    pointer swaps + a handful of array writes (the epoch handoff).
    """

    eids: np.ndarray  # deduped (last-write-wins)
    new_w: np.ndarray
    w_next: np.ndarray  # full post-commit weight buffer
    # per touched gid: (gid, path_D, path_BD, profile, lbd)
    sub_updates: list
    # staged skeleton partial refresh (plan_partial_refresh output)
    skel_affected: np.ndarray
    skel_new_w: np.ndarray
    skel_changes: list  # [(u, v, old, new)] skeleton vertex ids
    skel_touched_idx: np.ndarray
    skel_touched_vals: np.ndarray
    prepare_s: float = 0.0


@dataclasses.dataclass
class UpdateStats:
    """Counters of the index's maintenance, summed over update batches:
    ``touched_subgraphs`` whose weights a batch moved, ``refreshed_pairs``
    whose exact distance was recomputed (``core.bound_refresh``) and the
    ``relaxations`` and seconds (``refresh_s``) that took,
    ``capped_pairs`` whose Theorem 1 bound passed the exact distance and
    was lowered to it; reference trees the commits carried over
    (``trees_kept``) or dropped (``trees_evicted``).  A build or a
    rebaseline on weights that are not integers counts the subgraphs it
    capped there too."""

    batches: int = 0
    touched_subgraphs: int = 0
    refreshed_pairs: int = 0
    capped_pairs: int = 0
    relaxations: int = 0
    refresh_s: float = 0.0
    trees_kept: int = 0
    trees_evicted: int = 0


@dataclasses.dataclass
class BuildStats:
    """Timings and sizes of one build.  ``device_sources``: boundary
    sources whose level DP ran in the batched pass on the index's device;
    ``host_sources``: sources whose DP ran on the host (every source of a
    CPU build; on a card, those the batch cannot hold, see
    ``core.bounding_batch``); ``device_walks``: level walks the walk
    kernel rebuilt; ``simple_walks``: walks of the build that came back
    simple."""

    partition_s: float = 0.0
    bounding_s: float = 0.0
    compact_s: float = 0.0
    skeleton_s: float = 0.0
    n_paths: int = 0
    n_pairs: int = 0
    ebp_slots: int = 0
    mptree_slots: int = 0
    device_sources: int = 0
    host_sources: int = 0
    device_walks: int = 0
    simple_walks: int = 0

    @property
    def total_s(self) -> float:
        return self.partition_s + self.bounding_s + self.compact_s + self.skeleton_s


class DTLP:
    """The full two-level index."""

    def __init__(
        self,
        graph: Graph,
        partition: Partition,
        sub_indexes: list,
        skeleton: SkeletonGraph,
        edge_owner: np.ndarray,
        xi: int,
        lbd_mode: str,
        stats: BuildStats,
        z: int | None = None,
        device: str | None = None,
    ):
        self.graph = graph
        self.partition = partition
        self.sub_indexes = sub_indexes
        self.skeleton = skeleton
        self.edge_owner = edge_owner
        self.z = z  # partition size bound the index was built with
        self.device = device  # where the bounding stage runs (None: host)
        self.xi = xi
        self.lbd_mode = lbd_mode
        self.stats = stats
        self.update_stats = UpdateStats()
        self._pair_dist: PairDistances | None = None  # built on first use
        # lazy reference-stream state: per-target SidetrackTrees over the
        # base skeleton (see ref_tree_cache below)
        self._ref_trees = None
        self._ref_trees_key: tuple | None = None

    # ------------------------------------------------------------- build
    @classmethod
    def build(
        cls,
        graph: Graph,
        z: int,
        xi: int = 10,
        *,
        storage: str = "mptree",
        lbd_mode: str = "paper",
        lsh_h: int = 20,
        lsh_b: int = 2,
        seed: int = 0,
        device=None,
    ) -> "DTLP":
        """Partition ``graph`` into subgraphs of at most ``z`` vertices and
        build both levels.  ``device`` is where the index serves: on a
        card the bounding stage runs as one batched pass there
        (``core.bounding_batch``); None or a CPU device keeps the
        per-source host build."""
        device = _bounding_device(device)
        stats = BuildStats()
        t0 = time.perf_counter()
        part = partition_graph(graph, z, seed=seed)
        stats.partition_s = time.perf_counter() - t0

        t0 = time.perf_counter()
        edge_owner = np.full(graph.m, -1, dtype=np.int64)
        for sg in part.subgraphs:
            edge_owner[sg.edges] = sg.gid
        sub_indexes = build_subgraph_indexes(graph, part.subgraphs, xi,
                                             lbd_mode, stats, device)
        stats.bounding_s = time.perf_counter() - t0

        t0 = time.perf_counter()
        for si in sub_indexes:
            ebp = si.storage  # built as EBPII first
            path_len = np.array(
                [0 if p is None else len(p) for p in si.path_vertices],
                dtype=np.int64,
            )
            stats.ebp_slots += ebp.slots(path_len)
            if storage == "mptree":
                sig = minhash_signatures(ebp, len(si.path_edges), h=lsh_h)
                groups = lsh_groups(sig, b=lsh_b)
                tree = GMPTree(ebp, groups)
                stats.mptree_slots += tree.slots(path_len)
                si.storage = tree
        stats.compact_s = time.perf_counter() - t0

        t0 = time.perf_counter()
        skeleton = SkeletonGraph(graph.n, graph.directed)
        skeleton.finalize(sub_indexes)
        skeleton.refresh_weights(sub_indexes)
        stats.skeleton_s = time.perf_counter() - t0
        stats.n_paths = sum(si.path_phi.shape[0] for si in sub_indexes)
        stats.n_pairs = sum(si.pairs.shape[0] for si in sub_indexes)
        dtlp = cls(graph, part, sub_indexes, skeleton, edge_owner, xi,
                   lbd_mode, stats, z=int(z), device=device)
        if dtlp._cap_unsound_bounds():
            skeleton.refresh_weights(sub_indexes)
        return dtlp

    # ------------------------------------------------------- maintenance
    def apply_updates(self, eids: np.ndarray, new_w: np.ndarray, *,
                      incremental: bool = True) -> float:
        """Apply a weight-update batch; returns maintenance seconds.

        ``incremental=True`` (default) runs the delta-scoped path —
        ``prepare_updates`` + ``commit_updates``: only touched subgraph
        indexes rebuild their bounds, only affected skeleton edges
        recompute, and the lazy reference-tree cache is repaired instead
        of dropped.  ``incremental=False`` is the wholesale reference
        path (full ``refresh_weights``, cache invalidated outright) the
        equivalence oracle replays against; both produce bit-identical
        bounds, skeleton weights and reference streams.
        """
        if incremental:
            plan = self.prepare_updates(eids, new_w)
            t0 = time.perf_counter()
            self.commit_updates(plan)
            return plan.prepare_s + (time.perf_counter() - t0)
        t0 = time.perf_counter()
        eids, new_w = dedupe_updates(eids, new_w)
        delta = new_w - self.graph.w[eids]
        self.graph.apply_updates(eids, new_w)
        owners = self.edge_owner[eids]
        touched = np.unique(owners[owners >= 0])
        self.update_stats.batches += 1
        exact = self._refresh_bounds(self.graph.w, touched)
        for gid in touched:
            si = self.sub_indexes[gid]
            mask = owners == gid
            si.update_actual_distances(eids[mask], delta[mask])
            self.update_stats.capped_pairs += si.rebuild_bounds(
                self.graph, self.lbd_mode, exact[gid])
        if touched.shape[0]:
            self.skeleton.refresh_weights(self.sub_indexes)
        return time.perf_counter() - t0

    def prepare_updates(self, eids: np.ndarray,
                        new_w: np.ndarray) -> UpdatePlan:
        """Stage one update batch's full effect WITHOUT mutating state.

        Runs the same float operations, in the same order, as the
        wholesale path — per-path D deltas (EBP-II/G-MPTree lookups),
        per-touched-subgraph profile/BD recompute from the future
        weight buffer — but into shadow arrays, so epoch-*e* queries
        keep executing against untouched state while epoch *e+1* is
        prepared.  The batch is deduped last-write-wins first (a
        repeated eid must not double-count its delta).  Each touched
        subgraph's lower bounds are capped at its pairs' exact distances
        under the future weights (``core.bound_refresh``).
        """
        t0 = time.perf_counter()
        eids, new_w = dedupe_updates(eids, new_w)
        g = self.graph
        delta = new_w - g.w[eids]
        w_next = g.w.copy()
        w_next[eids] = new_w
        owners = self.edge_owner[eids]
        touched = np.unique(owners[owners >= 0])
        self.update_stats.batches += 1
        exact = self._refresh_bounds(w_next, touched)
        sub_updates = []
        new_lbds: dict = {}
        for gid in touched:
            si = self.sub_indexes[gid]
            mask = owners == gid
            D = si.path_D.copy()
            for e, dw in zip(eids[mask], delta[mask]):
                pids = si.storage.paths_containing(int(e))
                if pids.shape[0]:
                    D[pids] += dw
            profile = unit_weight_profile(
                w_next[si.sg.edges], g.vfrag[si.sg.edges]
            )
            BD = bound_distances(profile, si.path_phi)
            lbd, capped = capped_bounds(lower_bound_distances_vec(
                si.pair_ptr, D, BD, mode=self.lbd_mode), exact[gid])
            self.update_stats.capped_pairs += capped
            sub_updates.append((int(gid), D, BD, profile, lbd))
            new_lbds[int(gid)] = lbd
        affected, skel_new_w, changes, t_idx, t_vals = (
            self.skeleton.plan_partial_refresh(new_lbds)
        )
        prepare_s = time.perf_counter() - t0
        obs.span_at("dtlp_prepare", t0, prepare_s, edges=int(eids.shape[0]),
                    subgraphs=int(touched.shape[0]),
                    skeleton_changes=len(changes))
        return UpdatePlan(
            eids=eids, new_w=new_w, w_next=w_next,
            sub_updates=sub_updates, skel_affected=affected,
            skel_new_w=skel_new_w, skel_changes=changes,
            skel_touched_idx=t_idx, skel_touched_vals=t_vals,
            prepare_s=prepare_s,
        )

    def commit_updates(self, plan: UpdatePlan) -> None:
        """Install a staged :class:`UpdatePlan`: the epoch handoff.

        Pointer swaps and array writes only — no recomputation.  The
        graph's previous weight buffer survives one epoch (``w_at``),
        the reference-tree cache is repaired in place (trees the changed
        skeleton edges provably miss are carried over copy-on-write,
        the rest rebuild on demand), and the skeleton version bump makes
        every new ``view()`` see the fresh weights while views already
        captured by in-flight steppers stay untouched.
        """
        self.graph.apply_updates(plan.eids, plan.new_w)
        for gid, D, BD, profile, lbd in plan.sub_updates:
            si = self.sub_indexes[gid]
            si.path_D = D
            si.path_BD = BD
            si.profile = profile
            si.lbd = lbd
        if plan.sub_updates:
            self.skeleton.commit_partial_refresh(
                plan.skel_affected, plan.skel_new_w,
                plan.skel_touched_idx, plan.skel_touched_vals,
            )
            if self._ref_trees is not None and len(self._ref_trees):
                tracing = obs.enabled()
                t0 = obs.clock() if tracing else 0.0
                kept, evicted = self._ref_trees.repair(
                    plan.skel_changes, self.skeleton.view())
                if tracing:
                    obs.span_at("tree_repair", t0, obs.clock() - t0,
                                kept=kept, evicted=evicted)
                self.update_stats.trees_kept += kept
                self.update_stats.trees_evicted += evicted
            # re-key: the repaired cache IS valid for the new skeleton
            # state (wholesale refreshes leave the key stale on purpose,
            # so ref_tree_cache drops the cache there)
            self._ref_trees_key = (id(self.skeleton),
                                   self.skeleton._version)

    def _refresh_bounds(self, w: np.ndarray, touched: np.ndarray) -> dict:
        """{gid: exact distances of the subgraph's pairs under ``w``} for
        each touched gid (none computed when nothing is touched), counted
        in ``update_stats``."""
        st = self.update_stats
        if not touched.shape[0]:
            return {}
        if self._pair_dist is None:
            self._pair_dist = PairDistances(self.sub_indexes, self.device)
        pd = self._pair_dist
        t0 = obs.clock()
        flat = pd(w)
        dt = obs.clock() - t0
        obs.span_at("bound_refresh", t0, dt, subgraphs=int(touched.shape[0]),
                    relaxations=pd.relaxations)
        out = {int(g): flat[pd.ptr[g]:pd.ptr[g + 1]] for g in touched}
        st.touched_subgraphs += int(touched.shape[0])
        st.refreshed_pairs += sum(int(v.shape[0]) for v in out.values())
        st.relaxations += pd.relaxations
        st.refresh_s += dt
        return out

    def _cap_unsound_bounds(self) -> int:
        """Cap at its pairs' exact distances the bounds of every subgraph
        that has an edge of unit weight other than 1 (w ≠ vfrag), where
        Theorem 1's bound can leak; returns how many subgraphs that was.
        A graph of integer weights has none, and keeps the paper's
        bounds."""
        g = self.graph
        owners = self.edge_owner[np.flatnonzero(g.w != g.vfrag)]
        touched = np.unique(owners[owners >= 0])
        exact = self._refresh_bounds(g.w, touched)
        for gid in touched:
            si = self.sub_indexes[gid]
            si.lbd, capped = capped_bounds(si.lbd, exact[int(gid)])
            self.update_stats.capped_pairs += capped
        return int(touched.shape[0])

    def __getstate__(self):
        state = self.__dict__.copy()
        state["_pair_dist"] = None  # device tensors: rebuilt on first use
        return state

    # ----------------------------------------------------------- helpers
    @property
    def epoch(self) -> int:
        """Graph epoch (one bump per update batch) — the version every
        worker slab is stamped with and every QueryResult reports."""
        return self.graph.epoch

    def subgraphs_of_pair(self, u: int, v: int) -> list:
        return self.partition.subgraphs_of_pair(u, v)

    def ref_tree_cache(self):
        """Per-skeleton-state cache of lazy reference-stream sidetrack
        trees (bounded LRU ``refstream.TreeCache``), keyed by target
        skeleton vertex.

        The "lazy" stream (``core.refstream``) builds one reverse SPT +
        sidetrack heap per target and reuses it across every query to
        that target; the structure is only valid for one skeleton weight
        state, so the cache self-invalidates whenever the skeleton's
        weights are refreshed (``apply_updates``) or the skeleton is
        rebuilt outright (``rebaseline``)."""
        from .refstream import TreeCache

        key = (id(self.skeleton), self.skeleton._version)
        if self._ref_trees is None or self._ref_trees_key != key:
            self._ref_trees = TreeCache()
            self._ref_trees_key = key
        return self._ref_trees

    # --------------------------------------------------- drift / rebaseline
    def drift(self) -> float:
        """Mean |w/w0 − 1|: how far weights have drifted from the vfrag
        baseline.  Bound tightness decays with drift (the paper's §6.4.1
        τ-degradation); past ~1.0 the skeleton loses most pruning power."""
        return float(np.mean(np.abs(self.graph.w / self.graph.w0 - 1.0)))

    def rebaseline(self) -> float:
        """Re-anchor vfrags at the CURRENT weights and rebuild the level-1
        index + skeleton on the existing partition (beyond-paper
        production feature: restores tight bounds after heavy drift;
        cost ≈ initial build minus partitioning).  Returns seconds.

        Lazy reference streams recover by rebuilding their per-target
        SPT + sidetrack heap against the fresh skeleton (one Dijkstra +
        O(m log n) heap inserts, NOT a re-run of Yen rounds): the
        ``ref_tree_cache`` is dropped here and repopulates on demand.
        The re-anchored weights are no longer integers, so the bounds are
        capped as in a build (``_cap_unsound_bounds``)."""
        t0 = time.perf_counter()
        self._ref_trees = None
        self._ref_trees_key = None
        g = self.graph
        g.w0 = g.w.copy()
        g.vfrag = np.maximum(1, np.rint(g.w0)).astype(np.int64)
        self.sub_indexes = build_subgraph_indexes(
            g, self.partition.subgraphs, self.xi, self.lbd_mode,
            BuildStats(), self.device)
        self._pair_dist = None
        self._cap_unsound_bounds()
        # re-compact storage (bounding paths changed)
        for si in self.sub_indexes:
            ebp = si.storage
            sig = minhash_signatures(ebp, len(si.path_edges), h=20)
            groups = lsh_groups(sig, b=2)
            si.storage = GMPTree(ebp, groups)
        self.skeleton = SkeletonGraph(g.n, g.directed)
        self.skeleton.finalize(self.sub_indexes)
        self.skeleton.refresh_weights(self.sub_indexes)
        return time.perf_counter() - t0


def capped_bounds(lbd: np.ndarray, exact: np.ndarray) -> tuple:
    """Theorem 1's bounds capped at the pairs' exact distances, and how
    many the cap lowered (the pairs where Theorem 1 leaked)."""
    return np.minimum(lbd, exact), int(np.count_nonzero(exact < lbd))


def _bounding_device(device) -> str | None:
    """The device the bounding stage runs on: None (the host) for None or
    a CPU device; a card's name where one is asked for, which must be
    there (nothing falls back to the host)."""
    if device is None:
        return None
    from ..device import resolve_device

    dev = resolve_device(device)
    return None if dev.type == "cpu" else str(dev)


def build_subgraph_indexes(graph: Graph, subgraphs: list, xi: int,
                           lbd_mode: str, stats: BuildStats,
                           device: str | None) -> list:
    """Every subgraph's level-1 index: source by source on the host where
    ``device`` is None, else as one batched pass on ``device``."""
    if device is None:
        out = [_build_subgraph_index(graph, sg, xi, lbd_mode)
               for sg in subgraphs]
        stats.host_sources = sum(int(sg.boundary_local.shape[0])
                                 for sg in subgraphs)
        stats.simple_walks = sum(
            sum(p is not None for p in si.path_vertices) for si in out)
        return out
    return batched_subgraph_indexes(graph, subgraphs, xi, lbd_mode, stats,
                                    device)


def batched_subgraph_indexes(graph: Graph, subgraphs: list, xi: int,
                             lbd_mode: str, stats: BuildStats, device,
                             max_iter: int | None = None) -> list:
    """:func:`_build_subgraph_index` of every subgraph, bit for bit, with
    the DP and the walks of all boundary sources batched on ``device``
    (``core.bounding_batch``; on a CPU device through the kernels' plain
    versions).  Sources the batch cannot hold take the host path.
    ``max_iter`` is a test seam: it replaces the DP's cap of nv·ξ+8
    relaxations, as in :func:`bounding.kdistinct_walk_dp`.  Adds the
    pass's counts to ``stats``."""
    from .bounding_batch import source_paths_batched

    blocks = source_paths_batched(graph, subgraphs, xi, device, stats,
                                  max_iter)
    out = []
    for sg, sg_blocks in zip(subgraphs, blocks):
        vf_hw = graph.vfrag[sg.eid].astype(np.float64)
        for a_pos, blk in enumerate(sg_blocks):
            if blk is None:
                sg_blocks[a_pos] = blk = source_paths(graph, sg, vf_hw, a_pos,
                                                      xi, max_iter)
                stats.simple_walks += sum(v is not None for v in blk[3])
        out.append(finish_subgraph_index(graph, sg, sg_blocks, lbd_mode))
    return out


def _build_subgraph_index(graph: Graph, sg: Subgraph, xi: int, lbd_mode: str,
                          max_iter: int | None = None) -> SubgraphIndex:
    """One subgraph's level-1 index, source by source on the host
    (``max_iter``: the test seam of :func:`batched_subgraph_indexes`)."""
    vf_hw = graph.vfrag[sg.eid].astype(np.float64)
    blocks = [source_paths(graph, sg, vf_hw, a_pos, xi, max_iter)
              for a_pos in range(sg.boundary_local.shape[0])]
    return finish_subgraph_index(graph, sg, blocks, lbd_mode)


def source_paths(graph: Graph, sg: Subgraph, vf_hw: np.ndarray, a_pos: int,
                 xi: int, max_iter: int | None = None) -> tuple:
    """The pairs and bounding paths of boundary source ``a_pos``, by the
    host DP and one greedy walk per level: (pairs [(src, dst)], levels per
    pair, φ per path, vertices per path, edge ids per path), a path's
    vertices and edge ids None where its level has no simple walk
    (``max_iter``: the test seam of :func:`batched_subgraph_indexes`)."""
    boundary = sg.boundary_local
    bsrc = int(boundary[a_pos])
    D = kdistinct_walk_dp(sg.indptr, sg.nbr, vf_hw, bsrc, xi, max_iter)
    targets = boundary if graph.directed else boundary[a_pos + 1 :]
    pairs, counts, phis, verts_l, eids_l = [], [], [], [], []
    for bt in targets:
        bt = int(bt)
        if bt == bsrc:
            continue
        levels = D[:, bt]
        levels = levels[np.isfinite(levels)]
        if levels.shape[0] == 0:
            continue
        for lv in levels:
            verts = extract_level_path(
                sg.indptr, sg.nbr, vf_hw, D, bsrc, bt, float(lv)
            )
            eids = None
            if verts is not None:
                eids = _path_edge_ids(sg, verts)
                if eids is None:
                    verts = None
            phis.append(int(round(float(lv))))
            verts_l.append(verts)
            eids_l.append(eids)
        pairs.append((bsrc, bt))
        counts.append(levels.shape[0])
    return pairs, counts, phis, verts_l, eids_l


def finish_subgraph_index(graph: Graph, sg: Subgraph, blocks: list,
                          lbd_mode: str) -> SubgraphIndex:
    """Assemble a subgraph's index from its sources' blocks (in boundary
    order, each as :func:`source_paths` returns it): path distances,
    bound distances, lower bounds and the EBP-II storage."""
    pair_list, phis, verts_l, eids_l = [], [], [], []
    counts = []
    for pairs, cnt, phi, verts, eids in blocks:
        pair_list += pairs
        counts += cnt
        phis += phi
        verts_l += verts
        eids_l += eids
    n_pairs = len(pair_list)
    pair_ptr = np.zeros(n_pairs + 1, dtype=np.int64)
    np.cumsum(np.asarray(counts, dtype=np.int64), out=pair_ptr[1:])
    path_phi = np.array(phis, dtype=np.int64) if phis else np.empty(0, dtype=np.int64)
    path_D = np.full(path_phi.shape[0], INF)
    for p, eids in enumerate(eids_l):
        if eids is not None:
            path_D[p] = float(np.sum(graph.w[eids]))
    profile = unit_weight_profile(graph.w[sg.edges], graph.vfrag[sg.edges])
    path_BD = bound_distances(profile, path_phi) if path_phi.shape[0] else np.empty(0)
    lbd = lower_bound_distances_vec(pair_ptr, path_D, path_BD, mode=lbd_mode)
    si = SubgraphIndex(
        sg=sg,
        pairs=np.array(pair_list, dtype=np.int64).reshape(n_pairs, 2),
        pair_ptr=pair_ptr,
        path_phi=path_phi,
        path_D=path_D,
        path_BD=path_BD,
        path_vertices=verts_l,
        path_edges=eids_l,
        storage=EBPII(eids_l),
        profile=profile,
        lbd=lbd,
    )
    return si


def _path_edge_ids(sg: Subgraph, verts: list) -> np.ndarray | None:
    """Global edge ids along a local-vertex path (lightest parallel edge)."""
    out = []
    for a, b in zip(verts, verts[1:]):
        lo, hi = sg.indptr[a], sg.indptr[a + 1]
        hits = np.nonzero(sg.nbr[lo:hi] == b)[0]
        if hits.shape[0] == 0:
            return None
        out.append(int(sg.eid[lo + hits[0]]))
    return np.array(out, dtype=np.int64)
