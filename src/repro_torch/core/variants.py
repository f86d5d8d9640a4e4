"""Query-variant policies for KSP-DG: one search loop, many workloads.

The serving stack answers every query shape through the SAME machinery —
``ksp_dg_stepper``'s filter/refine loop over shared grouped solves.  A
:class:`VariantPolicy` is the pluggable piece that turns that loop into
a different workload without forking the stack: it decides how deep the
candidate pool is (``solve_k``), when the reference stream may stop
(``stop_bound``), and what subset of the enumerated candidates is the
answer (``finalize``).  Everything the distributed runtime cares about —
refine-pair batching, cross-query dedup, epoch fencing, caching — is
variant-blind, because the policy never touches weights or solves: it
only reads the exactly-enumerated candidate list ``L``.

Built-in policies:

* ``ksp`` (:class:`PlainKSP`) — the paper's top-k query; the identity
  policy every other variant is measured against.
* ``bounded`` (:class:`BoundedKSP`) — length-bounded enumeration: emit
  every path within a ``stretch`` factor of the shortest (the icarus
  ``desirability_stretch`` rule), with ``k`` as the unbounded-answer
  budget guard.  Pure stop-rule change: the lazy reference stream
  already enumerates in nondecreasing weight, so the policy just stops
  once the next reference outweighs ``stretch × d₀``.
* ``diverse`` (:class:`DiverseKSP`) — k mutually dissimilar paths via
  the Lion/PowerPlanner ``min_dist``/``cost_add`` technique: greedy
  selection over the weight-ordered candidate stream, accepting a path
  only when its edge overlap with every already-selected path stays
  below ``1 − min_dist``, with ``cost_add`` capping how much costlier a
  diverse path may be than the shortest.  The penalty acts at the
  selection layer, NOT the solve layer, so diverse queries keep sharing
  grouped solves (and cache entries) with every other in-flight query.

``one_to_many`` is the fourth request variant but needs no policy here:
the service fans it out into per-target sub-queries whose refine tasks
the scheduler de-duplicates into shared batches (and, on undirected
graphs, whose reversed orientation shares ONE reverse-SPT
``ref_tree_cache`` entry) — see ``repro.service.KSPService``.

    >>> make_variant("ksp") is None   # plain ksp needs no policy
    True
    >>> make_variant("bounded", stretch=1.5).name
    'bounded'
    >>> make_variant("diverse", min_dist=0.4).solve_k(3)
    12
"""

from __future__ import annotations

from .refstream import TIE_EPS

INF = float("inf")

__all__ = [
    "VariantPolicy",
    "PlainKSP",
    "BoundedKSP",
    "DiverseKSP",
    "make_variant",
    "path_edges",
    "path_overlap",
    "greedy_diverse",
]


def path_edges(path, directed: bool = False) -> frozenset:
    """The edge set of a vertex path, as comparable keys.

    Undirected edges are normalized to (min, max) so a path and its
    reversal share edges.

        >>> sorted(path_edges((3, 1, 2)))
        [(1, 2), (1, 3)]
        >>> sorted(path_edges((3, 1, 2), directed=True))
        [(1, 2), (3, 1)]
    """
    if directed:
        return frozenset(zip(path, path[1:]))
    return frozenset(
        (u, v) if u < v else (v, u) for u, v in zip(path, path[1:])
    )


def path_overlap(e1: frozenset, e2: frozenset) -> float:
    """Overlap fraction of two edge sets: |shared| / min(|e1|, |e2|).

    1.0 means one path is (edge-wise) contained in the other; 0.0 means
    edge-disjoint.  Normalizing by the SHORTER path makes the metric
    symmetric and strict: a long detour that swallows a selected path
    whole still counts as fully overlapping.

        >>> a = path_edges((0, 1, 2, 3))
        >>> path_overlap(a, path_edges((0, 1, 2, 3)))
        1.0
        >>> path_overlap(a, path_edges((0, 5, 6, 3)))
        0.0
    """
    if not e1 or not e2:
        return 1.0 if e1 == e2 else 0.0
    return len(e1 & e2) / min(len(e1), len(e2))


def greedy_diverse(paths, k: int, min_dist: float, *,
                   cost_cap: float = INF, directed: bool = False):
    """Greedy diverse selection over a weight-ascending path list.

    Walks ``[(dist, vertex-tuple)]`` in order, selecting a path when its
    overlap with EVERY already-selected path is at most ``1 − min_dist``
    (and its cost is within ``cost_cap``); stops at ``k`` selections.
    This is the oracle semantics of the ``diverse`` variant — the
    streaming implementation is certified against exactly this function
    on the exhaustively-enumerated path list.
    """
    sel: list = []
    sel_edges: list = []
    max_overlap = 1.0 - float(min_dist)
    for d, p in paths:
        if d > cost_cap + TIE_EPS:
            break
        e = path_edges(p, directed)
        if all(path_overlap(e, e2) <= max_overlap + 1e-12
               for e2 in sel_edges):
            sel.append((d, p))
            sel_edges.append(e)
            if len(sel) >= k:
                break
    return sel


class VariantPolicy:
    """Base policy = the plain top-k query (identity behavior).

    The stepper calls three hooks:

    ``solve_k(k)``
        Candidate-pool depth: the ``k`` used for partial solves, joins
        and the running list ``L``.  This is also the cross-query batch
        key the scheduler de-duplicates on, so policies that keep it at
        the request ``k`` share solves with plain queries bit-for-bit.

    ``stop_bound(L, k, directed)``
        The Theorem-3 generalization: a weight ``B`` such that once the
        next *simple* reference path weighs more than ``B``, the answer
        is final (every not-yet-enumerated path weighs at least the next
        reference).  ``None`` means "cannot stop yet".

    ``stop_at(bound, next_ref_w)``
        Whether the search may stop when the next simple reference
        weighs ``next_ref_w`` against stop bound ``bound``.  Plain top-k
        stops on a TIE (Theorem 3: ``L[k-1] ≤`` next reference — ties
        beyond the k returned are legitimately dropped); set-valued
        variants (bounded, diverse) override to strict ``>`` because
        paths TYING the bound belong to the answer and the tie plateau
        must be enumerated through.

    ``finalize(L, k, stats, directed)``
        Map the exactly-enumerated candidate list to the answer, setting
        any result flags on ``stats`` (e.g. ``bound_clipped``).
    """

    name = "ksp"

    def solve_k(self, k: int) -> int:
        return int(k)

    def stop_bound(self, L, k, directed):
        return L[k - 1][0] if len(L) >= k else None

    def stop_at(self, bound: float, next_ref_w: float) -> bool:
        return bound <= next_ref_w + TIE_EPS

    def finalize(self, L, k, stats, directed):
        return L[:k]


PlainKSP = VariantPolicy


class BoundedKSP(VariantPolicy):
    """Length-bounded enumeration: every path within ``stretch × d₀``.

    ``k`` is the budget guard on an otherwise unbounded answer: when
    more than ``k`` paths fit under the stretch bound, the ``k``
    shortest are returned and ``QueryStats.bound_clipped`` is set (the
    answer is still exact as a top-k; it is the ENUMERATION that was
    clipped).  The pool runs one LOOKAHEAD slot deep (``solve_k = k+1``)
    so clipping is detected exactly: a (k+1)-th candidate inside the
    stretch window proves the window outgrew the budget.  The stop rule
    is sound with the streaming ``L[0]``: it only shrinks toward the
    true ``d₀`` as candidates arrive, so the bound used is never tighter
    than the final one.
    """

    name = "bounded"

    def __init__(self, stretch: float = 1.2):
        self.stretch = float(stretch)
        if self.stretch < 1.0:
            raise ValueError(f"stretch must be ≥ 1, got {stretch}")

    def solve_k(self, k: int) -> int:
        return int(k) + 1

    def stop_bound(self, L, k, directed):
        if not L:
            return None
        bound = self.stretch * L[0][0]
        if len(L) > k:
            # the lookahead slot is filled: once top-(k+1) is certified
            # exact the budgeted answer (and the clip flag) is decided
            bound = min(bound, L[k][0])
        return bound

    def stop_at(self, bound: float, next_ref_w: float) -> bool:
        # strict: paths TYING the stretch cut are part of the answer,
        # so the tie plateau at the bound must be enumerated through
        return next_ref_w > bound + TIE_EPS

    def finalize(self, L, k, stats, directed):
        if not L:
            return []
        cut = self.stretch * L[0][0] + TIE_EPS
        out = [(d, p) for d, p in L[:k] if d <= cut]
        if len(L) > k and L[k][0] <= cut:
            # the lookahead candidate sits inside the stretch window:
            # more within-bound paths exist beyond the k returned
            stats.bound_clipped = True
        return out


class DiverseKSP(VariantPolicy):
    """k mutually dissimilar paths (Lion/PowerPlanner ``min_dist``).

    Greedy over the weight-ordered candidate stream: a candidate is
    selected when its edge overlap with every selected path is at most
    ``1 − min_dist`` (``min_dist`` = required dissimilarity fraction,
    in (0, 1]); ``cost_add`` caps acceptable detour cost at
    ``(1 + cost_add) × d₀`` — "5% of the best path's cost is the most a
    diverse alternative may add".  Greedy-in-weight-order is prefix-
    stable: a selection decided at weight ``w`` can never be changed by
    candidates heavier than ``w``, which is what makes the streaming
    stop rule exact against :func:`greedy_diverse` on the full path
    enumeration.

    ``pool`` bounds the internal candidate pool (default ``4k``, at
    least 8): partial solves and joins run at depth ``pool`` so the
    top-``pool`` enumeration stays exact.  When ``k`` diverse paths do
    not exist within the pool (or the cost cap), the policy returns what
    it found; pool exhaustion with the cost cap still open additionally
    sets ``QueryStats.truncated`` (a deeper pool might find more).
    """

    name = "diverse"

    def __init__(self, min_dist: float = 0.3, cost_add: float | None = None,
                 pool: int | None = None):
        self.min_dist = float(min_dist)
        if not 0.0 < self.min_dist <= 1.0:
            raise ValueError(f"min_dist must be in (0, 1], got {min_dist}")
        self.cost_add = None if cost_add is None else float(cost_add)
        if self.cost_add is not None and self.cost_add < 0:
            raise ValueError(f"cost_add must be ≥ 0, got {cost_add}")
        self.pool = None if pool is None else int(pool)
        if self.pool is not None and self.pool < 1:
            raise ValueError(f"pool must be ≥ 1, got {pool}")

    def solve_k(self, k: int) -> int:
        if self.pool is not None:
            return max(int(k), self.pool)
        return max(4 * int(k), 8)

    def _cost_cap(self, L) -> float:
        if self.cost_add is None or not L:
            return INF
        return (1.0 + self.cost_add) * L[0][0]

    def _select(self, L, k, directed):
        return greedy_diverse(L, k, self.min_dist,
                              cost_cap=self._cost_cap(L), directed=directed)

    def stop_bound(self, L, k, directed):
        if not L:
            return None
        bounds = []
        cap = self._cost_cap(L)
        if cap < INF:
            # past the cost cap no candidate is admissible at all
            bounds.append(cap)
        sel = self._select(L, k, directed)
        if len(sel) >= k:
            # greedy prefix-stability: heavier candidates cannot alter
            # selections made at or below the k-th selected weight
            bounds.append(sel[k - 1][0])
        if len(L) >= self.solve_k(k):
            # pool full: once top-pool is certified exact, nothing new
            # can enter L and the selection cannot change
            bounds.append(L[-1][0])
        return min(bounds) if bounds else None

    def stop_at(self, bound: float, next_ref_w: float) -> bool:
        # strict, like BoundedKSP: a candidate TYING the cost cap is
        # admissible, and a tie at the k-th selected weight could be a
        # lexicographically-earlier path that changes the greedy prefix
        return next_ref_w > bound + TIE_EPS

    def finalize(self, L, k, stats, directed):
        sel = self._select(L, k, directed)
        if (len(sel) < k and len(L) >= self.solve_k(k)
                and L[-1][0] <= self._cost_cap(L) + TIE_EPS):
            # the pool ran out before the cost cap closed the search: a
            # deeper pool might have found more diverse paths
            stats.truncated = True
        return sel


def make_variant(variant: str, *, stretch=None, min_dist=None,
                 cost_add=None, pool=None) -> VariantPolicy | None:
    """Build the stepper policy for one request's variant fields.

    Returns ``None`` for ``"ksp"`` (and for ``"one_to_many"``, whose
    per-target sub-queries are plain) — the stepper treats ``None`` as
    :class:`PlainKSP` without allocating anything on the hot path.
    """
    if variant in ("ksp", "one_to_many", None):
        return None
    if variant == "bounded":
        return BoundedKSP(stretch=1.2 if stretch is None else stretch)
    if variant == "diverse":
        return DiverseKSP(min_dist=0.3 if min_dist is None else min_dist,
                          cost_add=cost_add, pool=pool)
    raise ValueError(
        f"unknown query variant {variant!r}; "
        "available: ksp, diverse, bounded, one_to_many"
    )
