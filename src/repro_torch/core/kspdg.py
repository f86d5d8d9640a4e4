"""KSP-DG: distributed filter-and-refine KSP search (Section 5).

Each iteration: (filter) take the next shortest *reference path* on the
skeleton graph G_λ; (refine) for every adjacent boundary pair on it,
compute partial KSPs inside the covering subgraph(s) — the step that
runs in parallel across workers/devices — then join the partial lists
into candidate KSPs and fold them into the running top-k list L.
Terminates when L holds k paths and the k-th is not longer than the
next reference path (Theorem 3).

Non-boundary endpoints (Section 5.2 / Step 1 on Storm): the query
endpoints are spliced into a per-query *extended* skeleton with edges
to every boundary vertex of their home subgraph, weighted by the exact
within-subgraph shortest distance (a valid lower bound of itself).
"""

from __future__ import annotations

import dataclasses
import heapq
from collections import OrderedDict

import numpy as np

from repro_torch import obs

from .dtlp import DTLP
from .refstream import TIE_EPS, get_ref_stream
from .sssp import ROUTE_CALLS, CSRView, dijkstra, subgraph_view
from .variants import VariantPolicy
from .yen import ksp

INF = float("inf")

# shared identity policy: plain top-k, allocated once for the hot path
_PLAIN = VariantPolicy()


@dataclasses.dataclass
class QueryStats:
    iterations: int = 0
    references: int = 0  # reference paths consumed (≥ iterations: a
    # tie-batched cohort folds many equal-weight references into one)
    walks_skipped: int = 0  # non-simple lazy-stream walks consumed for
    # the stop rule but never refined (they cannot join simply)
    refine_tasks: int = 0
    cache_hits: int = 0
    partial_paths: int = 0
    join_pops: int = 0  # segment combinations the joins popped
    join_paths: int = 0  # of those, the simple paths the joins kept
    # True when the iteration guard fired before Theorem 3's stopping
    # rule: the result is best-effort, not provably exact.  Happens on
    # geodesic corridors dense with boundary vertices, where the skeleton
    # Yen stream enumerates combinatorially many tied-weight reference
    # paths — the "lazy" reference stream exists to remove this mode.
    truncated: bool = False
    # bounded-variant flag: the stretch window held more paths than the
    # budget k allowed — the returned top-k is exact, the enumeration of
    # the window was clipped (see core.variants.BoundedKSP)
    bound_clipped: bool = False


class PartialKSPCache:
    """(graph version, subgraph, src, dst, k) → partial KSP list.

    Shared across queries of a batch; invalidated by version bump —
    the QueryBolt-side reuse the paper leans on for concurrent queries.
    Eviction is bounded LRU: a full cache drops its least-recently-used
    entry instead of flushing everything, so one burst past capacity no
    longer costs the whole working set (stale-version entries age out
    the same way — their keys are never touched again after a bump).
    """

    def __init__(self, max_entries: int = 200_000):
        self.data: OrderedDict = OrderedDict()
        self.max_entries = int(max_entries)

    def get(self, key):
        hit = self.data.get(key)
        if hit is not None:
            self.data.move_to_end(key)
        return hit

    def put(self, key, value):
        if key in self.data:
            self.data.move_to_end(key)
        else:
            while len(self.data) >= self.max_entries:
                self.data.popitem(last=False)
        self.data[key] = value

    def __len__(self) -> int:
        return len(self.data)


def _extended_skeleton(dtlp: DTLP, s: int, t: int):
    """Extended G_λ view + id mappings for one query.

    Returns (view, ext_of_global, global_of_ext, home) where ``home``
    maps a non-boundary endpoint to its single home subgraph gid.
    """
    skel = dtlp.skeleton
    base = skel.view()
    g2s = skel.g2s
    directed = dtlp.graph.directed
    extra_vertices: list[int] = []
    extra_index: dict[int, int] = {}  # global id → position in extra_vertices
    extra_edges: list[tuple[int, int, float]] = []  # oriented (gu, gv, w)
    home: dict = {}

    def ext_id(gv: int) -> int:
        sid = int(g2s[gv])
        if sid >= 0:
            return sid
        return base.n + extra_index[gv]

    for endpoint in {s, t}:
        if int(g2s[endpoint]) >= 0:
            continue
        owners = dtlp.partition.subgraphs_of_vertex(endpoint)
        if len(owners) != 1:
            raise ValueError(f"vertex {endpoint} has owners {owners}")
        gid = owners[0]
        home[endpoint] = gid
        extra_index[endpoint] = len(extra_vertices)
        extra_vertices.append(endpoint)
        sg = dtlp.partition.subgraphs[gid]
        view = subgraph_view(sg, dtlp.graph.w)
        # splice direction: s needs s→boundary distances (forward search);
        # t needs boundary→t distances, which on a directed graph come
        # from a Dijkstra over the REVERSED subgraph
        incoming = directed and endpoint == t
        if incoming:
            view = view.reversed()
        lsrc = sg.g2l[endpoint]
        dist, _, _ = dijkstra(view, lsrc)
        for lb in sg.boundary_local:
            if np.isfinite(dist[lb]):
                gb = int(sg.vertices[lb])
                if incoming:
                    extra_edges.append((gb, endpoint, float(dist[lb])))
                else:
                    extra_edges.append((endpoint, gb, float(dist[lb])))
        other = t if endpoint == s else s
        if other in sg.g2l and other != endpoint:
            lo = sg.g2l[other]
            if np.isfinite(dist[lo]):
                if incoming:
                    extra_edges.append((other, endpoint, float(dist[lo])))
                else:
                    extra_edges.append((endpoint, other, float(dist[lo])))

    n_ext = base.n + len(extra_vertices)
    if extra_vertices:
        # resolve each splice edge's endpoint ids ONCE
        h_src = np.array([ext_id(u) for (u, v, w) in extra_edges], dtype=np.int64)
        h_dst = np.array([ext_id(v) for (u, v, w) in extra_edges], dtype=np.int64)
        h_w = np.array([w for (u, v, w) in extra_edges], dtype=np.float64)
        if not directed:
            # undirected splice: each edge traversable both ways
            h_src, h_dst = (np.concatenate([h_src, h_dst]),
                            np.concatenate([h_dst, h_src]))
            h_w = np.concatenate([h_w, h_w])
        src_all = np.concatenate([base_src(base), h_src])
        dst_all = np.concatenate([base.nbr, h_dst])
        w_all = np.concatenate([base.hw, h_w])
        order = np.argsort(src_all, kind="stable")
        counts = np.bincount(src_all, minlength=n_ext)
        indptr = np.zeros(n_ext + 1, dtype=np.int64)
        np.cumsum(counts, out=indptr[1:])
        view = CSRView(n_ext, indptr, dst_all[order], w_all[order])
    else:
        view = base

    global_of_ext = {}
    for gv in np.nonzero(g2s >= 0)[0]:
        global_of_ext[int(g2s[gv])] = int(gv)
    for i, gv in enumerate(extra_vertices):
        global_of_ext[base.n + i] = int(gv)
    return view, ext_id, global_of_ext, home


def base_src(view: CSRView) -> np.ndarray:
    return np.repeat(np.arange(view.n), np.diff(view.indptr))


def pair_owner_gids(dtlp: DTLP, a: int, b: int, home: dict) -> list:
    """Candidate owning subgraphs of one refine pair (a, b).

    A spliced (non-boundary) endpoint pins the pair to its single home
    subgraph; a boundary-boundary pair may be covered by several.
    """
    owners_a = home.get(a)
    owners_b = home.get(b)
    if owners_a is not None:
        return [owners_a]
    if owners_b is not None:
        return [owners_b]
    return dtlp.subgraphs_of_pair(a, b)


def refine_groups(dtlp: DTLP, pairs: list, home: dict):
    """Group one iteration's refine pairs by owning subgraph.

    The distributed runtime's dispatch unit (Section 6.1: tasks are
    routed to the SubgraphBolt that owns the covering subgraph).

    Returns ``(pair_gids, groups)``: ``pair_gids[i]`` lists the candidate
    gids of ``pairs[i]``; ``groups[gid]`` lists ``(pair_idx, a, b)`` tasks
    whose endpoints both live in subgraph ``gid``.
    """
    pair_gids = [pair_owner_gids(dtlp, a, b, home) for a, b in pairs]
    groups: dict = {}
    for i, (a, b) in enumerate(pairs):
        for gid in pair_gids[i]:
            sg = dtlp.partition.subgraphs[gid]
            if a in sg.g2l and b in sg.g2l:
                groups.setdefault(gid, []).append((i, a, b))
    return pair_gids, groups


def _partial_ksps(
    dtlp: DTLP,
    a: int,
    b: int,
    k: int,
    mode: str,
    cache: PartialKSPCache | None,
    stats: QueryStats,
    home: dict,
) -> list[tuple[float, tuple]]:
    """k shortest a→b paths inside the subgraphs covering both (Alg. 2)."""
    gids = pair_owner_gids(dtlp, a, b, home)
    merged: list[tuple[float, tuple]] = []
    seen = set()
    version = dtlp.graph.version
    for gid in gids:
        sg = dtlp.partition.subgraphs[gid]
        if a not in sg.g2l or b not in sg.g2l:
            continue
        key = (version, gid, a, b, k, mode)
        hit = cache.get(key) if cache is not None else None
        if hit is not None:
            stats.cache_hits += 1
            paths = hit
        else:
            stats.refine_tasks += 1
            view = subgraph_view(sg, dtlp.graph.w)
            local = ksp(view, sg.g2l[a], sg.g2l[b], k, mode=mode, directed=dtlp.graph.directed)
            paths = [
                (d, tuple(int(sg.vertices[v]) for v in p)) for d, p in local
            ]
            if cache is not None:
                cache.put(key, paths)
        for d, p in paths:
            if p not in seen:
                seen.add(p)
                merged.append((d, p))
    merged.sort(key=lambda x: (x[0], x[1]))
    stats.partial_paths += min(len(merged), k)
    return merged[:k]


def _k_best_joins(segments: list[list[tuple[float, tuple]]], k: int,
                  stats: QueryStats | None = None):
    """k best simple concatenations, one entry per segment (lazy heap).

    ``stats``, when given, gains the combinations popped (``join_pops``)
    and the simple paths kept (``join_paths``): their ratio is the join's
    yield."""
    m = len(segments)
    if any(not seg for seg in segments):
        return []
    first = tuple([0] * m)
    start_d = sum(seg[0][0] for seg in segments)
    heap = [(start_d, first)]
    visited = {first}
    out = []
    pops = 0
    while heap and len(out) < k:
        d, idx = heapq.heappop(heap)
        pops += 1
        # join the paths: consecutive segments share their joint vertex
        verts: list[int] = []
        ok = True
        for j in range(m):
            p = segments[j][idx[j]][1]
            verts.extend(p if j == 0 else p[1:])
        if len(set(verts)) == len(verts):
            out.append((d, tuple(verts)))
        for j in range(m):
            if idx[j] + 1 < len(segments[j]):
                nxt = idx[:j] + (idx[j] + 1,) + idx[j + 1 :]
                if nxt not in visited:
                    visited.add(nxt)
                    nd = d - segments[j][idx[j]][0] + segments[j][idx[j] + 1][0]
                    heapq.heappush(heap, (nd, nxt))
    if stats is not None:
        stats.join_pops += pops
        stats.join_paths += len(out)
    return out


def _timed(name: str, fn, *args, **attrs):
    """``fn(*args)``, recorded as the span ``name`` when tracing is on.

    The stepper's spans (``skeleton``, ``ref_next``, ``cohort``,
    ``stop_scan``) go through here: with tracing off a call
    pays one flag test and reads no clock, since no stats counter wants
    these durations."""
    if not obs.enabled():
        return fn(*args)
    t0 = obs.clock()
    out = fn(*args)
    obs.span_at(name, t0, obs.clock() - t0, **attrs)
    return out


def _ref_build(spec, view, es, et, directed, tree_cache, s, t):
    """The reference stream, recorded as the span ``ref_build`` when
    tracing is on, with the attribute ``route``: how the plain searches
    of its construction ran (``native``, ``python`` or both as
    ``mixed``; ``none`` where it ran none, as for a cached tree)."""
    if not obs.enabled():
        return spec.factory(view, es, et, directed, tree_cache=tree_cache)
    before = dict(ROUTE_CALLS)
    t0 = obs.clock()
    refs = spec.factory(view, es, et, directed, tree_cache=tree_cache)
    dur = obs.clock() - t0
    ran = [r for r in ("native", "python") if ROUTE_CALLS[r] > before[r]]
    route = ran[0] if len(ran) == 1 else ("mixed" if ran else "none")
    obs.span_at("ref_build", t0, dur, s=s, t=t, route=route)
    return refs


def _cohort_pairs(cohort, global_of_ext, stats: QueryStats):
    """One cohort's refine pairs, ordered and de-duplicated, and each
    simple reference's pair indices; non-simple walks are counted in
    ``stats.walks_skipped`` and dropped."""
    pair_index: dict = {}
    pairs: list[tuple] = []
    ref_pairs: list[list[int]] = []
    for _, ref_path_ext in cohort:
        ref_path = [global_of_ext[v] for v in ref_path_ext]
        if len(set(ref_path)) != len(ref_path):
            stats.walks_skipped += 1
            continue
        idxs = []
        for a, b in zip(ref_path, ref_path[1:]):
            j = pair_index.get((a, b))
            if j is None:
                j = len(pairs)
                pair_index[(a, b)] = j
                pairs.append((a, b))
            idxs.append(j)
        ref_pairs.append(idxs)
    return pairs, ref_pairs


def _skip_walks(pending, pull, bound, ref_budget, global_of_ext,
                stats: QueryStats):
    """The stop rule's scan: consume the non-simple walks at or below
    ``bound`` ahead of the next simple reference; returns the first
    reference not consumed (None once the stream runs dry)."""
    while (pending is not None
           and stats.references < ref_budget
           and pending[0] <= bound + TIE_EPS):
        ref_path = [global_of_ext[v] for v in pending[1]]
        if len(set(ref_path)) == len(ref_path):
            break  # simple: its weight is the sharp bound
        stats.references += 1
        stats.walks_skipped += 1
        pending = pull()
    return pending


@dataclasses.dataclass
class RefineRequest:
    """One KSP-DG iteration's refine work, yielded by ``ksp_dg_stepper``.

    ``pairs`` are the adjacent (a, b) global-id pairs along the current
    reference path; the consumer must answer with one partial-KSP segment
    list per pair (ascending ``[(dist, global-path-tuple)]``, length ≤ k)
    via ``generator.send(seg_lists)`` — either a list aligned with
    ``pairs`` or a ``{pair_index: seg_list}`` dict covering every index,
    so a pipelined scheduler assembling results out of dispatch order
    (per-worker batches complete whenever their device round lands) can
    hand them over without re-sorting.  ``stats`` is the query's live
    ``QueryStats`` so refiners can account cache hits / tasks in place.
    """

    pairs: list
    home: dict
    k: int
    stats: QueryStats


def ksp_dg_stepper(
    dtlp: DTLP,
    s: int,
    t: int,
    k: int,
    *,
    max_iterations: int = 10_000,
    ref_stream=None,
    tie_batch: int | None = None,
    variant=None,
):
    """Resumable KSP-DG (Algorithm 1): one generator step per iteration.

    Yields a :class:`RefineRequest` for each filter-phase reference
    cohort and expects the matching segment lists back through ``send``;
    the generator's return value (``StopIteration.value``) is ``(L,
    stats)``.  This inversion-of-control form lets a scheduler interleave
    many queries' iterations in lockstep and merge their refine tasks
    into shared grouped solves (``repro.dist.scheduler``); ``ksp_dg``
    below is the single-query driver over the same machinery.

    ``ref_stream`` names a :class:`repro.core.refstream
    .ReferenceStreamSpec` ("yen" — the default — or "lazy", the
    Eppstein-style deviation-walk stream).  One iteration consumes a
    *cohort* of up to ``tie_batch`` references tied at the same weight
    (default: the stream spec's own ``tie_batch``); the cohort's refine
    pairs are de-duplicated into a single :class:`RefineRequest` and the
    join runs per reference, so a tied weight level that would cost the
    Yen stream thousands of iterations costs the lazy stream a handful.
    The stop rule is unchanged — cohorts only batch references the rule
    would have had to consume anyway, and every cohort member's weight
    ties the first member's, so no reference past the stopping weight is
    ever refined "extra".

    ``variant`` is an optional :class:`repro.core.variants.VariantPolicy`
    bending the same loop to a different workload (diverse / bounded —
    see :mod:`repro.core.variants`).  The policy widens the candidate
    pool (``solve_k``), generalizes the Theorem-3 stop bound
    (``stop_bound``), and maps the enumerated candidates to the answer
    (``finalize``); ``None`` is the plain top-k query.  Refine depth and
    :class:`RefineRequest.k` follow ``solve_k``, so the scheduler's
    cross-query dedup keys stay correct automatically.

    With tracing on, the stepper records spans on the ambient track, so
    they nest inside whatever span drove it (the scheduler's ``admit``
    or ``splice``): ``skeleton`` (the extended skeleton), ``ref_build``
    (the reference stream's construction), ``ref_next`` (each pull from
    the stream), ``cohort`` (a cohort's references mapped to refine
    pairs), ``join`` (one iteration's joins and their fold into L, with
    the combinations popped and the simple paths kept) and ``stop_scan``
    (the stop rule's scan past non-simple walks, its pulls included).
    """
    policy = variant if variant is not None else _PLAIN
    solve_k = policy.solve_k(k)
    directed = dtlp.graph.directed
    spec = get_ref_stream(ref_stream)
    batch = spec.tie_batch if tie_batch is None else max(1, int(tie_batch))
    stats = QueryStats()
    if s == t:
        return policy.finalize([(0.0, (s,))], k, stats, directed), stats
    view, ext_id, global_of_ext, home = _timed(
        "skeleton", _extended_skeleton, dtlp, s, t, s=s, t=t)
    es, et = ext_id(s), ext_id(t)
    # per-target sidetrack trees are reusable across queries only on the
    # un-spliced base skeleton (no home ⇒ no per-query extra vertices)
    tree_cache = dtlp.ref_tree_cache() if not home else None
    refs = _ref_build(spec, view, es, et, directed, tree_cache, s, t)

    L: list[tuple[float, tuple]] = []
    L_set = set()
    # two budgets: ``max_iterations`` bounds REFINE rounds (the expensive
    # distributed work — exactly the pre-stream meaning for the Yen
    # stream, whose references are all simple and all refined), while the
    # reference budget bounds raw stream consumption so a lazy stream
    # cannot spin forever skipping non-simple walks between refines
    ref_budget = max_iterations * batch

    def pull():
        return _timed("ref_next", next, refs, None, s=s, t=t,
                      iteration=stats.iterations)

    pending = pull()
    while (pending is not None and stats.iterations < max_iterations
           and stats.references < ref_budget):
        cohort = [pending]
        pending = pull()
        while (pending is not None and len(cohort) < batch
               and stats.references + len(cohort) < ref_budget
               and pending[0] <= cohort[0][0] + TIE_EPS):
            cohort.append(pending)
            pending = pull()
        stats.references += len(cohort)
        # ordered de-dup of the cohort's refine pairs: tied references on
        # a corridor mostly cross the same boundary pairs, so the request
        # (and the grouped solve behind it) stays small.  Non-simple
        # references (lazy-stream walks revisiting a vertex) are consumed
        # for the stop rule but never refined: every join of a walk
        # contains the walk's full vertex sequence, so the repeated
        # vertex makes every candidate non-simple — refining one is pure
        # waste.
        pairs, ref_pairs = _timed("cohort", _cohort_pairs, cohort,
                                  global_of_ext, stats, s=s, t=t,
                                  iteration=stats.iterations)
        if pairs:
            stats.iterations += 1
            seg_lists = yield RefineRequest(pairs=pairs, home=home,
                                            k=solve_k, stats=stats)
            if isinstance(seg_lists, dict):
                # out-of-order delivery: per-worker pipelines answer in
                # completion order, keyed by pair index — realign here
                seg_lists = [seg_lists[j] for j in range(len(pairs))]
            # one ``join`` span per iteration: every reference's joins
            # and their fold into L
            tracing = obs.enabled()
            if tracing:
                t_join = obs.clock()
                pops0, kept0 = stats.join_pops, stats.join_paths
            for idxs in ref_pairs:
                for d, p in _k_best_joins([seg_lists[j] for j in idxs],
                                          solve_k, stats):
                    if p not in L_set:
                        L_set.add(p)
                        L.append((d, p))
            L.sort(key=lambda x: (x[0], x[1]))
            for d_, p_ in L[solve_k:]:
                L_set.discard(p_)
            L = L[:solve_k]
            if tracing:
                obs.span_at("join", t_join, obs.clock() - t_join, s=s, t=t,
                            iteration=stats.iterations, pairs=len(pairs),
                            references=stats.references,
                            join_pops=stats.join_pops - pops0,
                            join_paths=stats.join_paths - kept0)
        # the variant policy names the Theorem-3 bound: the weight at or
        # below which the answer is already decided (L[k-1] for plain
        # top-k; see core.variants for the bounded/diverse forms)
        bound = policy.stop_bound(L, k, directed)
        if pending is not None and bound is not None:
            # sharpened stop rule: only SIMPLE references can ever seed a
            # simple candidate (every join of a repeated-vertex walk is
            # itself non-simple), so the binding Theorem-3 lower bound is
            # the next simple reference's weight, not the next raw
            # walk's.  Skip-and-consume non-simple walks up to that
            # reference — or until any walk already outweighs the bound,
            # which certifies the stop on its own; the reference budget
            # bounds the scan on walk-dense tie plateaus.
            pending = _timed("stop_scan", _skip_walks, pending, pull, bound,
                             ref_budget, global_of_ext, stats, s=s, t=t,
                             iteration=stats.iterations)
            if pending is None or policy.stop_at(bound, pending[0]):
                break
    else:
        stats.truncated = pending is not None
    return policy.finalize(L, k, stats, directed), stats


def ksp_dg(
    dtlp: DTLP,
    s: int,
    t: int,
    k: int,
    *,
    partial_mode: str = "pyen",
    cache: PartialKSPCache | None = None,
    max_iterations: int = 10_000,
    refine_fn=None,
    return_stats: bool = False,
    ref_stream=None,
    tie_batch: int | None = None,
    variant=None,
):
    """KSP-DG (Algorithm 1).  Returns [(dist, path)] ascending, len ≤ k.

    ``refine_fn(pairs, k, home)`` may be supplied by the distributed
    runtime to compute all per-pair partial KSP lists of one iteration in
    parallel (``repro.dist.cluster``).  ``home`` maps spliced non-boundary
    endpoints to their single home subgraph; together with
    ``refine_groups`` it exposes the iteration's owner-aligned task
    groups, so a caller can dispatch whole groups to workers instead of
    re-deriving ownership per pair.  Default is the in-process path.

    This is a thin driver over :func:`ksp_dg_stepper` — one ``send`` per
    iteration, with the refine computed synchronously in between.
    ``ref_stream``/``tie_batch`` select and tune the reference-path
    stream (see :mod:`repro.core.refstream`).
    """
    stepper = ksp_dg_stepper(dtlp, s, t, k, max_iterations=max_iterations,
                             ref_stream=ref_stream, tie_batch=tie_batch,
                             variant=variant)
    seg_lists = None
    while True:
        try:
            req = stepper.send(seg_lists) if seg_lists is not None else next(stepper)
        except StopIteration as fin:
            L, stats = fin.value
            return (L, stats) if return_stats else L
        if refine_fn is not None:
            seg_lists = refine_fn(req.pairs, req.k, req.home)
            req.stats.refine_tasks += len(req.pairs)
        else:
            seg_lists = [
                _partial_ksps(dtlp, a, b, req.k, partial_mode, cache,
                              req.stats, req.home)
                for a, b in req.pairs
            ]
