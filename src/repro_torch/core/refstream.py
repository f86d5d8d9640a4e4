"""Reference-path streams for KSP-DG's filter phase (Theorem 3).

KSP-DG consumes skeleton *reference paths* in nondecreasing weight: each
reference's weight is a valid lower bound on every not-yet-enumerated
candidate, which is what makes the stop rule sound.  How the stream is
produced is pluggable:

* ``yen``  — the original stream: ``core.yen.ksp_stream`` in ``findksp``
  mode enumerates simple skeleton paths.  Exact, but every next
  reference costs a full deviation round (one Dijkstra per vertex of the
  previous path) — on geodesic corridors dense with boundary vertices,
  where combinatorially many references tie at the same weight, the
  stream becomes the bottleneck and the ``max_iterations`` guard
  truncates answers (``QueryStats.truncated``).

* ``lazy`` — an Eppstein-style deviation-walk stream (Eppstein 1998's
  k-shortest-*walks* construction): one reverse shortest-path tree to
  ``t`` plus a persistent heap of *sidetrack edges* (edges off the tree,
  keyed by their detour cost δ(e) = w(e) + d(head) − d(tail) ≥ 0).
  Every s→t walk corresponds to a unique sidetrack sequence of weight
  d(s) + Σδ, and a best-first search over the heap structure yields
  walks in nondecreasing weight at O(log) amortized cost per walk.
  Walks may be non-simple, but the set of walks contains every simple
  path at the same weight, so walk weights are valid lower bounds for
  the stop rule — and KSP-DG's join already discards non-simple
  candidates, so exactness is untouched.

Streams are registered as :class:`ReferenceStreamSpec`s; the spec also
carries ``tie_batch``, the number of equal-weight references
``ksp_dg_stepper`` may fold into ONE filter/refine iteration.  The lazy
stream's cheap references make large cohorts affordable, which is the
actual fix for the corridor-ties stall: a tied weight level that costs
the Yen stream thousands of iterations collapses into a handful of
cohort iterations whose refine pairs are de-duplicated anyway.
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools
from typing import Callable

import numpy as np

from .sssp import CSRView, reverse_spt
from .yen import ksp_stream

__all__ = [
    "ReferenceStreamSpec",
    "SidetrackTree",
    "TreeCache",
    "register_ref_stream",
    "get_ref_stream",
    "available_ref_streams",
    "DEFAULT_REF_STREAM",
]

# weight-tie tolerance shared with the stepper's stop rule
TIE_EPS = 1e-9

# incremental SPT repair margin: a changed skeleton edge leaves a cached
# tree's reverse SPT provably intact only when its detour cost δ stays
# strictly positive (by more than every epsilon the Dijkstra uses for
# strict-improvement and staleness checks) both BEFORE and AFTER the
# change — otherwise the edge is, or could become, a tree edge and the
# parent structure is relax-order dependent, so the tree is evicted and
# rebuilt from scratch on next use (which is trivially bit-identical)
REPAIR_EPS = 1e-6


class TreeCache:
    """Bounded LRU of per-target :class:`SidetrackTree`s.

    Each tree pins O(skeleton n + m) state (reverse-SPT arrays,
    sidetrack lists, persistent heap nodes), so the cache must not grow
    with the number of distinct query targets the way an unbounded dict
    would — same reasoning as ``core.kspdg.PartialKSPCache``, much
    smaller bound because entries are much bigger.
    """

    def __init__(self, max_trees: int = 64):
        from collections import OrderedDict

        self.data: "OrderedDict[int, SidetrackTree]" = OrderedDict()
        self.max_trees = int(max_trees)
        # lifetime lookup counters: the one-to-many fanout's tree-sharing
        # claim is testable as "N targets, N−1 hits on one entry"
        self.hits = 0
        self.misses = 0

    def get(self, key):
        hit = self.data.get(key)
        if hit is not None:
            self.data.move_to_end(key)
            self.hits += 1
        else:
            self.misses += 1
        return hit

    def put(self, key, tree) -> None:
        if key in self.data:
            self.data.move_to_end(key)
        else:
            while len(self.data) >= self.max_trees:
                self.data.popitem(last=False)
        self.data[key] = tree

    def values(self):
        return self.data.values()

    def __len__(self) -> int:
        return len(self.data)

    def repair(self, changes, view: CSRView) -> tuple[int, int]:
        """Incrementally carry cached trees across one skeleton weight
        refresh.  ``changes`` is ``[(u, v, old_w, new_w)]`` in skeleton
        vertex ids; ``view`` is the POST-change CSR.  Trees the changes
        provably do not touch are replaced by repaired copies (shared
        reverse SPT, dirty sidetrack lists dropped — see
        :meth:`SidetrackTree.repaired`); the rest are evicted and
        rebuild on demand.  Returns ``(kept, evicted)``.
        """
        kept = evicted = 0
        for t in list(self.data):
            rep = self.data[t].repaired(changes, view)
            if rep is None:
                del self.data[t]
                evicted += 1
            else:
                self.data[t] = rep
                kept += 1
        return kept, evicted


# ---------------------------------------------------------------------------
# persistent leftist heap (path-copying merge: every H_T(v) along the
# shortest-path tree shares structure with its parent's heap)
# ---------------------------------------------------------------------------
class _HeapNode:
    """One sidetrack *chain head* in a persistent leftist min-heap.

    ``u`` names the tail vertex; the node's key is δ of u's cheapest
    sidetrack.  The rest of u's sidetracks (sorted by δ) are not heap
    nodes — the enumeration walks them as a chain via ``(node, i)``.
    """

    __slots__ = ("key", "u", "left", "right", "rank")

    def __init__(self, key, u, left=None, right=None):
        self.key = key
        self.u = u
        self.left = left
        self.right = right
        self.rank = (right.rank if right is not None else 0) + 1


def _hmerge(a: _HeapNode | None, b: _HeapNode | None) -> _HeapNode | None:
    """Persistent leftist merge — O(log) new nodes, inputs untouched."""
    if a is None:
        return b
    if b is None:
        return a
    if b.key < a.key:
        a, b = b, a
    left = a.left
    right = _hmerge(a.right, b)
    if (left.rank if left is not None else 0) < right.rank:
        left, right = right, left
    return _HeapNode(a.key, a.u, left, right)


class SidetrackTree:
    """Reverse SPT + sidetrack deviation heaps for one target ``t``.

    Construction is one Dijkstra plus O(m log n) heap inserts; the tree
    is reusable across every source querying the same target (DTLP
    caches it per skeleton state — see ``DTLP.ref_tree_cache``), and
    after weight updates or a rebaseline it is simply rebuilt instead of
    re-running Yen rounds.
    """

    def __init__(self, view: CSRView, t: int, directed: bool = False):
        self.view = view
        self.t = int(t)
        self.directed = bool(directed)
        d, nxt = reverse_spt(view, self.t, directed)
        self.d = d
        self.nxt = nxt
        # per-vertex sidetrack lists, built ON DEMAND: a query only ever
        # touches vertices along traversed tree paths, so eagerly
        # scanning all n vertices / m edges here would be a fixed cost
        # per uncached tree (spliced endpoints — the common serving case)
        self._S: list = [None] * view.n
        # H(v) = sidetrack chain heads of every vertex on the tree path
        # v→t, built lazily along parent chains with structure sharing
        self._heaps: dict[int, _HeapNode | None] = {}

    def repaired(self, changes, view: CSRView) -> "SidetrackTree | None":
        """A copy of this tree valid for ``view`` (the post-change
        skeleton), or ``None`` when the changes may touch the tree.

        Soundness: for every changed edge (u, v) — both orientations on
        undirected skeletons — whose head is reachable, we require the
        detour cost δ = w + d[head] − d[tail] to exceed ``REPAIR_EPS``
        at BOTH the old and new weight.  Then the edge was a strict
        non-tree sidetrack before and stays one after, so the reverse
        SPT's ``d``/``nxt`` match what a fresh Dijkstra on ``view``
        would produce (the tree-edge set and all distances are
        untouched, tie cases excluded by the margin), and only the tail
        vertices' sidetrack δ values move — those lists are dropped and
        rebuilt lazily against the new view.

        Copy-on-write: the original tree object is never mutated —
        in-flight ``walks()`` generators read ``_S``/``_heaps`` live and
        must keep streaming the OLD epoch's references unperturbed.
        """
        d = self.d
        dirty: set[int] = set()
        for u, v, old_w, new_w in changes:
            pairs = ((u, v),) if self.directed else ((u, v), (v, u))
            for a, b in pairs:
                if not np.isfinite(d[b]):
                    continue
                if not np.isfinite(d[a]):
                    # the tail was unreachable; a newly-finite edge
                    # weight would connect it and grow the tree
                    if np.isfinite(new_w):
                        return None
                    continue
                slack = float(d[b]) - float(d[a])
                if min(old_w, new_w) + slack <= REPAIR_EPS:
                    return None
                dirty.add(int(a))
        clone = SidetrackTree.__new__(SidetrackTree)
        clone.view = view
        clone.t = self.t
        clone.directed = self.directed
        clone.d = d
        clone.nxt = self.nxt
        clone._S = [None if u in dirty else su
                    for u, su in enumerate(self._S)]
        # heaps are a deterministic function of the sidetrack lists and
        # the (unchanged) tree structure; rebuild lazily where needed
        clone._heaps = {} if dirty else dict(self._heaps)
        return clone

    def sidetracks(self, u: int) -> list[tuple[float, int]]:
        """Sidetrack edges out of ``u``: [(δ, head)], ascending by δ.

        One canonical tree half-edge per vertex (the first zero-δ edge
        to the next hop) is excluded; every other finite edge —
        including tied-weight parallels with δ = 0 — is a sidetrack.
        """
        u = int(u)
        su = self._S[u]
        if su is not None:
            return su
        view, d = self.view, self.d
        su = []
        if np.isfinite(d[u]):
            hop = int(self.nxt[u])
            tree_left = u != self.t
            for p in range(int(view.indptr[u]), int(view.indptr[u + 1])):
                v = int(view.nbr[p])
                if not np.isfinite(d[v]):
                    continue
                delta = float(view.hw[p]) + float(d[v]) - float(d[u])
                if tree_left and v == hop and delta <= TIE_EPS:
                    tree_left = False
                    continue
                su.append((max(delta, 0.0), v))
            su.sort()
        self._S[u] = su
        return su

    def heap_of(self, v: int) -> _HeapNode | None:
        """H(v), memoized along the tree path v→t (iterative: skeleton
        tree paths can be long enough to trouble the recursion limit)."""
        heaps = self._heaps
        stack = []
        x = int(v)
        while x != self.t and x not in heaps:
            stack.append(x)
            x = int(self.nxt[x])
            if x < 0:  # unreachable chain: no heap anywhere along it
                break
        if x == self.t and x not in heaps:
            st = self.sidetracks(x)
            heaps[x] = _HeapNode(st[0][0], x) if st else None
        base = heaps.get(x) if x >= 0 else None
        while stack:
            u = stack.pop()
            st = self.sidetracks(u)
            if st:
                base = _hmerge(base, _HeapNode(st[0][0], u))
            heaps[u] = base
        return heaps.get(int(v))

    def _tree_path(self, v: int) -> list[int]:
        out = [int(v)]
        while out[-1] != self.t:
            out.append(int(self.nxt[out[-1]]))
        return out

    def _walk(self, s: int, seq) -> list[int]:
        """Materialize a sidetrack sequence (reversed linked list) into
        the full vertex walk: tree segments stitched by the sidetracks."""
        edges = []
        while seq is not None:
            seq, e = seq
            edges.append(e)
        edges.reverse()
        out: list[int] = []
        cur = int(s)
        for u, v in edges:
            while cur != u:
                out.append(cur)
                cur = int(self.nxt[cur])
            out.append(u)
            cur = v
        out.extend(self._tree_path(cur))
        return out

    def walks(self, s: int):
        """Yield s→t walks as (weight, vertex-tuple), weight ascending.

        Best-first search over Eppstein's path graph: a state is one
        sidetrack choice ``(heap node, chain index)`` plus the sequence
        taken so far.  Successors — deeper heap node, next chain entry,
        or a fresh sidetrack after the current one — all cost at least
        as much (heap order, chain sort order, δ ≥ 0), so the global
        pop order is nondecreasing and every sequence appears once.
        """
        s = int(s)
        if not np.isfinite(self.d[s]):
            return
        base0 = float(self.d[s])
        yield (base0, tuple(self._tree_path(s)))
        root = self.heap_of(s)
        if root is None:
            return
        tb = itertools.count()  # heap tiebreak: _HeapNodes don't compare
        heap = [(base0 + root.key, next(tb), base0, root, 0, None)]
        while heap:
            cost, _, base, hn, ci, prev = heapq.heappop(heap)
            u = hn.u
            su = self.sidetracks(u)
            _, v = su[ci]
            seq = (prev, (u, v))
            yield (cost, tuple(self._walk(s, seq)))
            if ci == 0:  # heap children exist only at the chain head
                for child in (hn.left, hn.right):
                    if child is not None:
                        heapq.heappush(
                            heap,
                            (base + child.key, next(tb), base, child, 0, prev),
                        )
            if ci + 1 < len(su):
                heapq.heappush(
                    heap,
                    (base + su[ci + 1][0], next(tb), base, hn, ci + 1, prev),
                )
            h2 = self.heap_of(v)
            if h2 is not None:  # take a further sidetrack after this one
                heapq.heappush(
                    heap, (cost + h2.key, next(tb), cost, h2, 0, seq)
                )


# ---------------------------------------------------------------------------
# stream registry
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ReferenceStreamSpec:
    """One reference-stream implementation.

    ``factory(view, s, t, directed, tree_cache=None)`` returns an
    iterator of (weight, path-tuple) in nondecreasing weight;
    ``tree_cache`` is an optional dict the stream may use to reuse
    per-target structures across queries (only valid while the weights
    backing ``view`` are unchanged — the caller owns invalidation).
    ``tie_batch`` is the max number of equal-weight references the
    KSP-DG stepper folds into one filter/refine iteration.
    """

    name: str
    factory: Callable
    tie_batch: int = 1
    description: str = ""


def _yen_stream(view, s, t, directed=False, tree_cache=None):
    # findksp mode: one reverse SPT guides every spur search as an A*
    # heuristic — same exact stream as yen mode, ~7x fewer heap pops on
    # road-like skeletons
    return ksp_stream(view, s, t, None, mode="findksp", directed=directed)


def _lazy_stream(view, s, t, directed=False, tree_cache=None):
    tree = None if tree_cache is None else tree_cache.get(t)
    if tree is None:
        tree = SidetrackTree(view, t, directed=directed)
        if tree_cache is not None:
            tree_cache.put(t, tree)
    return tree.walks(s)


_REF_STREAMS: dict[str, ReferenceStreamSpec] = {}

# the serving stack's default (EngineSpec.ref_stream); bare core calls
# keep "yen" for exact backward compatibility with pre-stream behavior
DEFAULT_REF_STREAM = "yen"


def register_ref_stream(spec: ReferenceStreamSpec, *,
                        overwrite: bool = False) -> ReferenceStreamSpec:
    if not overwrite and spec.name in _REF_STREAMS:
        raise ValueError(f"reference stream {spec.name!r} already registered")
    _REF_STREAMS[spec.name] = spec
    return spec


def get_ref_stream(name) -> ReferenceStreamSpec:
    """Resolve a stream name (or pass a spec through); None → default."""
    if name is None:
        name = DEFAULT_REF_STREAM
    if isinstance(name, ReferenceStreamSpec):
        return name
    spec = _REF_STREAMS.get(name)
    if spec is None:
        raise ValueError(
            f"unknown reference stream {name!r}; "
            f"available: {available_ref_streams()}"
        )
    return spec


def available_ref_streams() -> list[str]:
    return sorted(_REF_STREAMS)


register_ref_stream(ReferenceStreamSpec(
    name="yen",
    factory=_yen_stream,
    tie_batch=1,
    description="simple-path stream via core.yen ksp_stream (findksp "
                "mode); one deviation round per reference",
))

register_ref_stream(ReferenceStreamSpec(
    name="lazy",
    factory=_lazy_stream,
    tie_batch=256,
    description="Eppstein-style lazy deviation-walk stream: reverse SPT "
                "+ persistent sidetrack heap, O(log) per reference",
))
