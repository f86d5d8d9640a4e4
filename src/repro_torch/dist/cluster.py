"""The distributed KSP-DG runtime (Section 6's KSPBolt/SubgraphBolt
topology, in-process): a cluster of workers answers exact KSP queries by
driving ``core.kspdg.ksp_dg`` with a refine callback that groups every
iteration's boundary pairs by owning subgraph and dispatches the groups
to the subgraphs' primary workers — falling back to replicas on failure
or straggling (re-issue), raising on double failure (data loss).

Refine engines are pluggable :class:`repro_torch.engine.registry.EngineSpec`s
(builtin: host ``"pyen"``, plain PyTorch ``"dense_bf"``, and ``"cuda_bf"``
— the fused Hopper kernel backend; each spec's ``SolverBackend`` carries
the slab geometry, so no lane/packing constants live here);
``repro_torch.service.KSPService`` is the public serving entry point over
this module — ``Cluster.query`` is kept as the internal sequential driver.

Every slab engine keeps its worker slabs resident on one ``device``: the
card (``"cuda"``, the default) unless the caller asks for ``"cpu"``.
Asking for the card on a host without one raises; nothing falls back.

Graph versions are first-class **epochs** here: every worker slab is
stamped with the epoch it was packed/patched at, ``Worker.execute``
refuses tasks when its epoch lags the graph (a replica that missed an
update batch re-syncs via ``patch_weights`` — counted in
``WorkerStats.resyncs`` — instead of silently serving stale weights),
and a dead worker accumulates the batches it missed for replay on
revival.

Also here: streaming weight maintenance (per-worker slab patching +
epoch bump), straggler auto-detection (per-worker task-latency EWMA vs
the fleet median), elastic rescale, and checkpoint/restore that
round-trips placement, per-worker stats and the epoch.
"""

from __future__ import annotations

import dataclasses

import numpy as np

import torch

from repro_torch import obs
from repro_torch.core.dtlp import DTLP
from repro_torch.core.kspdg import PartialKSPCache, ksp_dg, refine_groups
from repro_torch.engine.registry import EngineSpec, get_engine

from .placement import Placement, place, subgraph_cost, subgraph_loads

# EWMA smoothing for per-task worker latency (straggler detection)
_LAT_ALPHA = 0.3
# per-call cost floor: fixed dispatch overhead (python, jit call) must
# not read as straggling on a worker whose batches are all tiny
_CALL_COST_FLOOR = 1024.0
# spike clip: one observation may move the EWMA at most this factor past
# itself — recurring jit-compilation events (every new shape bucket) are
# hundreds of ms and would otherwise bench healthy workers
_LAT_CLIP = 8.0
# scored calls before a worker's EWMA is trusted for detection: early
# samples are compile-dominated on the dense engine (every new shape
# bucket compiles), so judging a short history benches healthy workers
_MIN_SCORED_CALLS = 6
# probation: an AUTO-benched worker receives one probe group every this
# many routes, keeping its EWMA live so a false positive (cold jit
# buckets) self-heals and a recovered straggler rejoins the fleet —
# manual ``mark_slow`` injection is never probed
_PROBE_EVERY = 16


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; asking for CUDA on a host without
    a usable card raises instead of falling back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to serve on the CPU"
        )
    return dev


class StaleReplicaError(RuntimeError):
    """A worker was asked to serve at an epoch its slab cannot reach —
    dead workers must never execute, and a stale replica must re-sync
    before serving.  Reaching this means the routing layer is broken."""


def merge_segments(pairs, pair_gids, results, k):
    """Per-pair segment lists from owner-keyed partial results.

    ``results`` maps (gid, a, b) → [(dist, global-path)]; a pair covered
    by several subgraphs merges their lists de-duped, ascending, top-k.
    Shared by the per-query refine below and the cross-query batched
    scatter in ``dist.scheduler`` — both must produce byte-identical
    segment lists for the two serving paths to agree path-for-path.
    """
    seg_lists = []
    for i, (a, b) in enumerate(pairs):
        merged, seen = [], set()
        for gid in pair_gids[i]:
            for d, p in results.get((gid, a, b), []):
                if p not in seen:
                    seen.add(p)
                    merged.append((d, p))
        merged.sort(key=lambda x: (x[0], x[1]))
        seg_lists.append(merged[:k])
    return seg_lists


@dataclasses.dataclass
class WorkerStats:
    tasks: int = 0  # refine tasks assigned (busy-time proxy for scaleout)
    cache_hits: int = 0
    batches: int = 0  # grouped dense solves issued
    resyncs: int = 0  # stale-epoch slab re-syncs before serving
    lat_ewma: float = 0.0  # EWMA of cost-normalized execute latency (s/cost)
    lat_min: float = 0.0  # fastest scored call (0 = none yet): compile-free
    lat_samples: int = 0  # tasks folded into the EWMA
    lat_calls: int = 0  # scored solve calls (excludes the warmup call)


class SolveFuture:
    """Handle for one in-flight ``Worker.execute_async`` batch.

    ``step()`` advances the engine's refine generator by one device
    round: it forces the previous round's solve, does the host-side
    absorb/promote work, and dispatches the next round — leaving that
    round chewing on the device while the caller goes off and steps
    OTHER workers' futures.  When the generator finishes, the future
    fills the worker's partial-KSP cache, folds the accumulated step
    time into the straggler EWMA, and ``result()`` becomes available.

    The step clock sums only time spent INSIDE ``step()`` — device time
    that elapses while the future sits suspended (the overlap the
    pipeline exists to create) is not charged to this worker, so the
    straggler signal measures the worker's own service rate, not the
    scheduler's interleaving.
    """

    __slots__ = ("worker", "epoch", "k", "n_tasks", "out", "_gen",
                 "_misses", "_host_s", "_done")

    def __init__(self, worker, epoch, k, out, misses, gen):
        self.worker = worker
        self.epoch = epoch
        self.k = k
        self.n_tasks = len(misses)
        self.out = out
        self._misses = misses
        self._gen = gen
        self._host_s = 0.0
        # no generator + misses = the host-only engine path: the worker
        # solves inline and calls _finish before handing the future out
        self._done = gen is None and not misses

    @property
    def done(self) -> bool:
        return self._done

    def step(self) -> bool:
        """Advance one device round; returns True once the batch is done.
        Safe to call on a finished future (no-op)."""
        if self._done:
            return True
        t0 = obs.clock()
        # ambient-track scope: spans the engine backend emits during
        # this round (solve_grouped dispatch) land on this worker's
        # timeline without threading wid through the engine API
        with obs.worker_scope(self.worker.wid):
            try:
                next(self._gen)
            except StopIteration as fin:
                self._host_s += obs.clock() - t0
                self._finish(fin.value)
                return True
        self._host_s += obs.clock() - t0
        return False

    def result(self) -> dict:
        """The ``{(gid, a, b): [(dist, path)]}`` map; done futures only."""
        if not self._done:
            raise RuntimeError("SolveFuture not done; step() it first")
        return self.out

    def _finish(self, solved: dict) -> None:
        w = self.worker
        for gid, a, b in self._misses:
            paths = solved[(gid, a, b)]
            w.cache.put((self.epoch, gid, a, b, self.k, w.engine), paths)
            self.out[(gid, a, b)] = paths
        if self._misses:
            cost = sum(w._cost.get(gid, 1.0) for gid, _, _ in self._misses)
            w._observe_latency(self._host_s, cost, len(self._misses))
        self._gen = None
        self._done = True


class Worker:
    """One in-process worker: owns the slabs/caches of its subgraphs.

    The worker carries the graph ``epoch`` its slab was last patched at;
    ``execute`` refuses to serve while that epoch lags ``dtlp.epoch`` —
    a live worker re-syncs (replaying the update batches it missed while
    dead), a dead worker raises :class:`StaleReplicaError`.
    """

    def __init__(self, wid: int, dtlp: DTLP, gids, spec: EngineSpec,
                 device="cuda"):
        self.wid = wid
        self.dtlp = dtlp
        self.gids = set(int(g) for g in gids)
        self.spec = spec
        self.engine = spec.name
        self.alive = True
        self.slow = False
        self.auto_benched = False  # slow was set by straggler detection
        self._probe_countdown = 0
        self.stats = WorkerStats()
        self.cache = PartialKSPCache()
        # where the slab's resident copy lives and its solves run
        self.device = torch.device(device)
        self.epoch = dtlp.epoch
        self.pending: list[np.ndarray] = []  # eid batches missed while dead
        # double-buffered epochs (streaming updates): the slab of the
        # previous epoch survives one commit so queries fenced at epoch
        # e keep solving against e's weights while e+1 serves new ones
        self.prev_slab = None
        # per-subgraph refine-cost proxy (THE shared formula the LPT
        # placer balances): normalizes observed task latency so owning
        # BIG subgraphs doesn't read as straggling
        self._cost = {
            gid: subgraph_cost(dtlp.partition.subgraphs[gid])
            for gid in self.gids
        }
        self.slab = None
        self.row_of: dict = {}
        if spec.packs_slab and self.gids:
            # a worker that owns nothing (more workers than subgraph
            # assignments) keeps no slab; it is never routed tasks
            from repro_torch.engine.dense import pack_subgraphs, place_slab

            # all slab geometry (lane alignment, bucket shapes) comes
            # from the engine backend's SlabLayout — never from here
            self.slab = pack_subgraphs(
                dtlp.partition, dtlp.graph.w, gids=sorted(self.gids),
                layout=spec.layout, epoch=self.epoch,
            )
            self.row_of = {int(g): i for i, g in enumerate(self.slab.gids)}
            # stage the slab on device ONCE — every subsequent dispatch
            # gathers rows from this resident mirror instead of paying a
            # host→device transfer (device-resident across ticks)
            t0 = obs.clock()
            place_slab(self.slab, self.device)
            obs.span_at("slab_place", t0, obs.clock() - t0,
                        worker=self.wid, S=int(self.slab.adj.shape[0]),
                        z=int(self.slab.z), device=str(self.device))

    # ------------------------------------------------------------- refine
    def execute_async(self, tasks, k: int,
                      epoch: int | None = None) -> SolveFuture:
        """Non-blocking form of :meth:`execute`: partition cache hits up
        front, then hand back a :class:`SolveFuture` whose ``step()``
        advances the engine's refine generator one device round at a
        time.  All-hit batches (and host-only engines, which have no
        device rounds to overlap) come back already done.

        ``epoch`` requests a specific serving epoch (streaming updates:
        a query admitted at epoch *e* must be refined against *e*'s
        weights even after the *e+1* swap commits); ``None`` means the
        current graph epoch, the barrier-mode behavior.
        """
        t0 = obs.clock()
        fut = self._execute_async(tasks, k, epoch)
        obs.span_at("execute", t0, obs.clock() - t0, worker=self.wid,
                    epoch=fut.epoch, k=k, tasks=len(tasks),
                    misses=fut.n_tasks)
        return fut

    def _execute_async(self, tasks, k: int,
                       epoch: int | None = None) -> SolveFuture:
        epoch = self.ensure_epoch(epoch)
        out: dict = {}
        misses = []
        for gid, a, b in tasks:
            self.stats.tasks += 1
            key = (epoch, gid, a, b, k, self.engine)
            hit = self.cache.get(key)
            if hit is not None:
                self.stats.cache_hits += 1
                out[(gid, a, b)] = hit
            else:
                misses.append((gid, a, b))
        if not misses:
            return SolveFuture(self, epoch, k, out, [], None)
        if self.spec.refine_async is None:
            # host-only engine: solve inline, clocked like the old path —
            # straggler signal times the real solve only (cache-hit
            # round-trips are ~free and would wash the EWMA with noise)
            fut = SolveFuture(self, epoch, k, out, misses, None)
            t0 = obs.clock()
            with obs.worker_scope(self.wid):
                solved = self.spec.refine(self, misses, k, epoch)
            fut._host_s = obs.clock() - t0
            fut._finish(solved)
            return fut
        gen = self.spec.refine_async(self, misses, k, epoch)
        return SolveFuture(self, epoch, k, out, misses, gen)

    def execute(self, tasks, k: int, epoch: int | None = None) -> dict:
        """tasks: [(gid, a, b)] with global vertex ids, all owned here.

        Returns {(gid, a, b): [(dist, global-path-tuple)], ...}.
        Synchronous drain of :meth:`execute_async` — one implementation,
        two schedules.
        """
        fut = self.execute_async(tasks, k, epoch)
        while not fut.step():
            pass
        return fut.result()

    def ensure_epoch(self, requested: int | None = None) -> int:
        """Refuse-or-resync epoch gate: the only way into ``execute``.

        With ``requested=None`` (barrier mode) guarantees this worker's
        slab matches the CURRENT graph epoch — a live-but-stale worker
        re-syncs, a dead one raises.  With an explicit ``requested``
        epoch (streaming fence), the worker may also serve exactly one
        epoch behind from its double buffer (``prev_slab`` /
        ``Graph.w_at``); anything it cannot reach bit-exactly raises
        :class:`StaleReplicaError`.  Serving wrong-epoch weights is
        structurally impossible either way: the partial-KSP cache is
        keyed by epoch and the slab buffers carry their epoch stamps.
        """
        epoch = self.dtlp.epoch
        if not self.alive:
            raise StaleReplicaError(
                f"worker {self.wid} is dead and cannot serve epoch "
                f"{epoch if requested is None else requested}"
            )
        if requested is None or requested == epoch:
            if self.epoch != epoch:
                self.resync()
            return epoch
        # an older epoch: slab engines serve it from the double buffer
        # (or a not-yet-patched slab still exactly at that epoch); host
        # engines read the graph's retained previous weight buffer
        if self.slab is None:
            try:
                self.dtlp.graph.w_at(requested)
            except KeyError:
                raise StaleReplicaError(
                    f"worker {self.wid} cannot reach epoch {requested} "
                    f"(graph at {epoch})"
                ) from None
            return int(requested)
        if (self.slab.epoch == requested
                or (self.prev_slab is not None
                    and self.prev_slab.epoch == requested)):
            return int(requested)
        raise StaleReplicaError(
            f"worker {self.wid} cannot serve epoch {requested}: slab at "
            f"{self.slab.epoch}, previous "
            f"{None if self.prev_slab is None else self.prev_slab.epoch}"
        )

    def slab_for(self, epoch: int):
        """The slab buffer packed at ``epoch`` (current or previous)."""
        if self.slab is not None and self.slab.epoch == epoch:
            return self.slab
        if self.prev_slab is not None and self.prev_slab.epoch == epoch:
            return self.prev_slab
        raise StaleReplicaError(
            f"worker {self.wid} holds no slab for epoch {epoch}"
        )

    def weights_for(self, epoch: int):
        """The logical-edge weight buffer of ``epoch`` (host engines)."""
        try:
            return self.dtlp.graph.w_at(epoch)
        except KeyError:
            raise StaleReplicaError(
                f"worker {self.wid} holds no weights for epoch {epoch}"
            ) from None

    def resync(self) -> None:
        """Replay missed update batches into the slab, advance the epoch."""
        self.stats.resyncs += 1
        t0 = obs.clock()
        pending, self.pending = self.pending, []
        if self.slab is not None and pending:
            self._patch(np.concatenate(pending))
        self._stamp(self.dtlp.epoch)
        obs.span_at("resync", t0, obs.clock() - t0, worker=self.wid,
                    epoch=self.epoch, batches=len(pending))

    def patch_weights(self, eids: np.ndarray) -> None:
        """Apply one update batch in lockstep (the live-worker path)."""
        if self.slab is not None:
            self._patch(eids)
        self._stamp(self.dtlp.epoch)

    def defer_weights(self, eids: np.ndarray) -> None:
        """Record a batch this (dead) worker missed, for resync on revival."""
        self.pending.append(np.asarray(eids, dtype=np.int64).copy())

    def _stamp(self, epoch: int) -> None:
        self.epoch = int(epoch)
        if self.slab is not None:
            self.slab.epoch = self.epoch

    def prepare_patch(self, eids: np.ndarray, w_next: np.ndarray):
        """Stage epoch-*e+1* slab contents in a shadow buffer while this
        worker keeps serving epoch *e* from its live slab.  ``w_next`` is
        the post-batch logical weight buffer (the graph itself is still
        at *e* when this runs).  Returns the shadow (None for slab-less
        workers) for a later :meth:`commit_patch`."""
        if self.slab is None:
            return None
        shadow = dataclasses.replace(self.slab, adj=self.slab.adj.copy())
        self._patch(eids, slab=shadow, w=w_next)
        return shadow

    def commit_patch(self, shadow, epoch: int) -> None:
        """Pointer-swap handoff: the live slab becomes the previous-epoch
        buffer (in-flight epoch-*e* queries keep reading it) and the
        shadow, stamped at the new epoch, starts serving."""
        if self.slab is not None and shadow is not None:
            self.prev_slab = self.slab
            self.slab = shadow
        self._stamp(epoch)

    def _patch(self, eids: np.ndarray, slab=None, w=None) -> None:
        """Re-patch slab entries touched by updated edges.

        Defaults patch the LIVE slab from the CURRENT graph weights (the
        barrier/resync path); the streaming path passes a shadow slab
        and the next epoch's weight buffer instead.  The host buffer is
        patched in place; the device copy is patched FUNCTIONALLY (a
        scatter producing a new tensor), so a shadow slab's copy never
        overwrites the live epoch's — commit stays a pointer swap on the
        device too.
        """
        g = self.dtlp.graph
        slab = self.slab if slab is None else slab
        w = g.w if w is None else w
        # de-duped effective cell values: parallel edges between a pair
        # collapse to one min — make_update_fn's scatter contract
        cells: dict = {}
        for e in np.asarray(eids, dtype=np.int64):
            gid = int(self.dtlp.edge_owner[e])
            row = self.row_of.get(gid)
            if row is None:
                continue
            sg = self.dtlp.partition.subgraphs[gid]
            lu = sg.g2l[int(g.edge_u[e])]
            lv = sg.g2l[int(g.edge_v[e])]
            # min over parallel edges between (lu, lv), like the packer
            val = self._min_weight(sg, lu, lv, w)
            slab.adj[row, lu, lv] = val
            cells[(row, lu, lv)] = val
            if not g.directed:
                rval = self._min_weight(sg, lv, lu, w)
                slab.adj[row, lv, lu] = rval
                cells[(row, lv, lu)] = rval
        if slab.adj_dev is not None and cells:
            self._patch_device(slab, cells)

    def _patch_device(self, slab, cells: dict) -> None:
        """Scatter patched cells into the slab's device copy.

        Batches are padded to a pow2 length with -1 rows, dropped by the
        scatter (the same batch contract as the reference package's).
        """
        from repro_torch.engine.dense import scatter_slab_cells

        n = len(cells)
        n_pad = 1 << (n - 1).bit_length() if n > 1 else 1
        rows = np.full(n_pad, -1, np.int32)
        uu = np.zeros(n_pad, np.int32)
        vv = np.zeros(n_pad, np.int32)
        ww = np.zeros(n_pad, np.float32)
        for i, ((r, lu, lv), val) in enumerate(cells.items()):
            rows[i], uu[i], vv[i], ww[i] = r, lu, lv, float(val)
        slab.adj_dev = scatter_slab_cells(slab.adj_dev, rows, uu, vv, ww)

    def _min_weight(self, sg, lu: int, lv: int, w: np.ndarray) -> np.float32:
        lo, hi = sg.indptr[lu], sg.indptr[lu + 1]
        hits = np.nonzero(sg.nbr[lo:hi] == lv)[0]
        return np.float32(np.min(w[sg.eid[lo + hits]]))

    def _observe_latency(self, dt: float, cost: float, n_tasks: int) -> None:
        """Fold one execute's solve latency into the straggler EWMA.

        The signal is seconds per unit of placement-cost, NOT per task:
        a worker that owns the biggest subgraphs legitimately spends
        more wall time per task, and must not read as a straggler.  The
        cost is floored (fixed dispatch overhead on tiny batches) and
        each worker's FIRST observation is discarded as warmup — for the
        dense engine that call typically pays one-off jit compilation.
        """
        if n_tasks <= 0 or cost <= 0:
            return
        st = self.stats
        if st.lat_samples == 0:
            st.lat_samples += n_tasks  # warmup call: count it, don't score
            return
        per_cost = dt / max(cost, _CALL_COST_FLOOR)
        # the latency noise is one-sided (jit compilation only ever ADDS
        # time), so the fastest scored call approximates the worker's
        # true compile-free service rate — detection cross-checks it
        st.lat_min = (per_cost if st.lat_min == 0.0
                      else min(st.lat_min, per_cost))
        if st.lat_ewma == 0.0:
            st.lat_ewma = per_cost
        else:
            # spike clip: a compile event must not swamp the signal; a
            # genuinely slow worker still converges geometrically
            per_cost = min(per_cost, _LAT_CLIP * st.lat_ewma)
            st.lat_ewma = _LAT_ALPHA * per_cost + (1 - _LAT_ALPHA) * st.lat_ewma
        st.lat_samples += n_tasks
        st.lat_calls += 1


class Cluster:
    """In-process worker cluster with owner-aligned placement.

    ``straggler_factor`` enables automatic straggler detection: a worker
    whose per-task latency EWMA exceeds ``factor ×`` the fleet median
    (with at least ``straggler_min_tasks`` observed tasks) is marked
    ``slow`` by ``route`` and its groups re-issue to the replica —
    ``mark_slow`` stays available as manual fault injection, and
    ``mark_slow(wid, False)`` clears an auto-detection too.  ``None``
    disables (the default for direct construction; ``repro_torch.service``
    turns it on).

    ``device`` is where slab engines keep their slabs and run their
    solves: the card unless the caller asks for ``"cpu"``.  A device
    mesh (``mesh``, ``mesh_axis``) is not ported yet: passing one raises.
    """

    def __init__(self, dtlp: DTLP, n_workers: int, engine="pyen",
                 *, device="cuda", mesh=None, mesh_axis=("data", "model"),
                 straggler_factor: float | None = None,
                 straggler_min_tasks: int = 8,
                 placement: Placement | None = None):
        self.dtlp = dtlp
        self.spec = get_engine(engine)
        self.engine = self.spec.name
        if mesh is not None:
            raise ValueError(
                f"engine {self.engine!r} has no device-mesh path in "
                "repro_torch; multi-GPU serving is queued in ROADMAP.md"
            )
        self.device = resolve_device(device)
        self.straggler_factor = (
            None if straggler_factor is None else float(straggler_factor)
        )
        self.straggler_min_tasks = int(straggler_min_tasks)
        self.reissues = 0
        self.auto_slowed = 0  # workers benched by straggler auto-detection
        self.auto_recovered = 0  # benched workers that rejoined via probation
        self._straggler_cache = None  # (state sig, fleet medians)
        self._build_workers(int(n_workers), placement=placement)

    # -------------------------------------------------------------- build
    def _build_workers(self, n_workers: int,
                       placement: Placement | None = None) -> None:
        if placement is None:
            placement = place(subgraph_loads(self.dtlp), n_workers)
        elif placement.n_workers != n_workers:
            raise ValueError(
                f"placement is for {placement.n_workers} workers, "
                f"cluster has {n_workers}"
            )
        self.placement: Placement = placement
        self.workers = [
            Worker(w, self.dtlp, self.placement.owned_by(w), self.spec,
                   device=self.device)
            for w in range(n_workers)
        ]

    @property
    def n_workers(self) -> int:
        return len(self.workers)

    @property
    def epoch(self) -> int:
        """Current graph epoch — stamped on every result served now."""
        return self.dtlp.epoch

    # -------------------------------------------------------------- query
    def query(self, s: int, t: int, k: int, *, max_iterations: int = 10_000,
              return_stats: bool = False, ref_stream=None):
        """Exact KSP through the cluster: [(dist, path)], ascending.

        Internal sequential driver — the public serving surface is
        ``repro_torch.service.KSPService``, which adds typed requests, epoch
        stamping, SLO admission and cross-query batching on top.

        ``max_iterations`` bounds one query's KSP-DG iterations (a tail
        latency guard); when it fires the result is best-effort and the
        stats carry ``truncated=True`` — pass ``return_stats`` to see.
        ``ref_stream`` overrides the engine spec's reference stream
        (default: ``spec.ref_stream``, "lazy" for builtin engines).
        """
        return ksp_dg(self.dtlp, int(s), int(t), int(k),
                      refine_fn=self._refine,
                      max_iterations=max_iterations,
                      return_stats=return_stats,
                      ref_stream=(self.spec.ref_stream
                                  if ref_stream is None else ref_stream))

    def _refine(self, pairs, k, home):
        """One iteration's refine: group by subgraph, dispatch to owners."""
        pair_gids, groups = refine_groups(self.dtlp, pairs, home)
        by_worker: dict = {}
        for gid, items in groups.items():
            worker, reissued = self.route(gid)
            if reissued:
                self.reissues += len(items)
            tasks = by_worker.setdefault(worker.wid, {})
            for _, a, b in items:
                tasks[(gid, a, b)] = None  # de-duped, order-preserving
        results: dict = {}
        for wid, tasks in by_worker.items():
            results.update(self.workers[wid].execute(list(tasks), k))
        return merge_segments(pairs, pair_gids, results, k)

    def route(self, gid: int):
        """(worker, reissued) for one subgraph's task group."""
        p = int(self.placement.primary[gid])
        r = int(self.placement.replica[gid])
        pw = self.workers[p]
        self._check_straggler(pw)
        if pw.alive and not pw.slow:
            return pw, False
        if pw.alive and pw.auto_benched:
            # probation: every _PROBE_EVERY routes the benched primary
            # serves one group anyway — its EWMA stays live, and once it
            # reads fleet-normal again it rejoins (false positives from
            # cold jit buckets self-heal; recovered stragglers return)
            pw._probe_countdown -= 1
            if pw._probe_countdown <= 0:
                pw._probe_countdown = _PROBE_EVERY
                if self._recovered(pw):
                    pw.slow = False
                    pw.auto_benched = False
                    self.auto_recovered += 1
                return pw, False  # the probe itself
        if r != p and self.workers[r].alive:
            return self.workers[r], True  # replica takeover / re-issue
        if pw.alive:
            return pw, False  # no healthy replica: wait on the primary
        raise RuntimeError(
            f"subgraph {gid} unavailable: primary worker {p} and replica "
            f"worker {r} are both dead — data loss, queries cannot be exact"
        )

    def _check_straggler(self, w: Worker) -> None:
        """Auto-set ``slow`` when a worker's task-latency EWMA runs past
        ``straggler_factor ×`` the fleet median (ROADMAP: automatic
        re-issue instead of manual ``mark_slow`` fault injection)."""
        factor = self.straggler_factor
        if (factor is None or w.slow or not w.alive
                or w.stats.lat_samples < self.straggler_min_tasks
                or w.stats.lat_calls < _MIN_SCORED_CALLS):
            return
        med_ewma, med_min = self._fleet_medians()
        # both signals must agree: the EWMA says "currently slow", the
        # per-worker minimum says "not just a compile/GC transient" —
        # a healthy worker's fastest call is always fleet-normal
        if (med_ewma > 0.0 and w.stats.lat_ewma > factor * med_ewma
                and med_min > 0.0 and w.stats.lat_min > factor * med_min):
            w.slow = True
            w.auto_benched = True
            w._probe_countdown = _PROBE_EVERY
            self.auto_slowed += 1

    def _fleet_medians(self) -> tuple[float, float]:
        """(median EWMA, median lat_min) over qualified live workers.

        Cached per observation state: ``route`` runs once per subgraph
        group per tick, but the medians only move when some worker
        scores a new solve call — keyed on the fleet's total scored-call
        count (plus liveness), so the numpy work runs once per change
        instead of once per route."""
        sig = (
            sum(x.stats.lat_calls for x in self.workers),
            sum(1 for x in self.workers if x.alive),
        )
        if self._straggler_cache is not None and \
                self._straggler_cache[0] == sig:
            return self._straggler_cache[1]
        peers = [
            x.stats for x in self.workers
            if x.alive and x.stats.lat_samples >= self.straggler_min_tasks
            and x.stats.lat_calls >= _MIN_SCORED_CALLS
        ]
        if len(peers) < 2:
            meds = (0.0, 0.0)  # no fleet to compare against
        else:
            meds = (
                float(np.median([p.lat_ewma for p in peers])),
                float(np.median([p.lat_min for p in peers])),
            )
        self._straggler_cache = (sig, meds)
        return meds

    def _recovered(self, w: Worker) -> bool:
        """Probation verdict: EWMA back under half the bench threshold
        (hysteresis against flapping).  ``lat_min`` is forgiven — it is
        a run-lifetime minimum and would otherwise bench forever."""
        factor = self.straggler_factor
        if factor is None:
            return True
        peers = [
            x.stats.lat_ewma for x in self.workers
            if x.alive and not x.slow and x.stats.lat_calls > 0
        ]
        if not peers:
            return False
        med = float(np.median(peers))
        return med > 0.0 and w.stats.lat_ewma <= 0.5 * factor * med

    # -------------------------------------------------------------- faults
    def _worker(self, wid: int) -> Worker:
        if not 0 <= wid < len(self.workers):
            raise ValueError(
                f"worker {wid} does not exist (cluster has "
                f"{len(self.workers)} workers)"
            )
        return self.workers[wid]

    def kill(self, wid: int) -> None:
        self._worker(wid).alive = False

    def revive(self, wid: int) -> None:
        """Bring a dead worker back.  Its slab stays at the epoch it died
        at; the first ``execute`` re-syncs (replaying missed batches) —
        lazily, so revival is O(1) and the resync shows up in stats."""
        self._worker(wid).alive = True

    def mark_slow(self, wid: int, flag: bool = True) -> None:
        """Manual straggler injection; ``flag=False`` also clears an
        auto-detection (operator override ends probation)."""
        w = self._worker(wid)
        w.slow = bool(flag)
        if not flag:
            w.auto_benched = False

    # --------------------------------------------------------- maintenance
    def apply_updates(self, eids, new_w) -> float:
        """Apply a weight-update batch: bump the epoch, patch every LIVE
        worker in lockstep, and defer the batch on dead workers so their
        replicas re-sync on revival instead of serving stale weights.
        Returns seconds."""
        t0 = obs.clock()
        eids = np.asarray(eids, dtype=np.int64)
        self.dtlp.apply_updates(eids, np.asarray(new_w, dtype=np.float64))
        for worker in self.workers:
            if worker.alive:
                worker.patch_weights(eids)
            else:
                worker.defer_weights(eids)
        dt = obs.clock() - t0
        obs.span_at("apply_updates", t0, dt, epoch=self.epoch,
                    edges=int(eids.shape[0]))
        return dt

    def apply_updates_streaming(self, eids, new_w, *,
                                n_epochs: int = 1) -> tuple[float, float]:
        """Streaming update commit: prepare epoch *e+1* (index deltas +
        per-worker shadow slabs) while workers keep serving *e*, then
        hand off with a pointer swap.  No drain — in-flight epoch-*e*
        queries finish against the retained double buffers.

        ``n_epochs`` > 1 records that this batch coalesced that many
        queued :class:`UpdateBatch`es (last-write-wins merged upstream):
        the epoch counter advances by the full count so per-batch epoch
        accounting (``min_epoch`` holds, result stamps) matches what N
        separate barrier commits would have produced.

        Returns ``(prepare_s, commit_s)`` — commit is the swap window,
        the only span during which admissions could observe a torn
        state (they can't: it mutates only pointers + the epoch).
        """
        t0 = obs.clock()
        plan = self.dtlp.prepare_updates(eids, new_w)
        shadows: dict = {}
        for w in self.workers:
            if not w.alive:
                continue
            eids_w = plan.eids
            if w.pending:
                # revived worker that never re-synced: fold its missed
                # batches into the shadow (w_next already carries their
                # final weights), so the swap installs a CURRENT slab
                eids_w = np.unique(np.concatenate(w.pending + [plan.eids]))
            tw = obs.clock()
            shadows[w.wid] = w.prepare_patch(eids_w, plan.w_next)
            obs.span_at("prepare_patch", tw, obs.clock() - tw,
                        worker=w.wid, edges=int(eids_w.shape[0]))
        prepare_s = obs.clock() - t0
        obs.span_at("epoch_prepare", t0, prepare_s,
                    epoch=self.epoch + 1, edges=int(plan.eids.shape[0]))
        t1 = obs.clock()
        self.dtlp.commit_updates(plan)
        if n_epochs > 1:
            self.dtlp.graph.advance_epoch_to(
                self.dtlp.epoch + int(n_epochs) - 1
            )
        epoch = self.epoch
        for w in self.workers:
            if w.alive:
                if w.pending:
                    w.stats.resyncs += 1
                    w.pending = []
                tw = obs.clock()
                w.commit_patch(shadows.get(w.wid), epoch)
                obs.span_at("commit_patch", tw, obs.clock() - tw,
                            worker=w.wid, epoch=epoch)
            else:
                w.defer_weights(plan.eids)
        commit_s = obs.clock() - t1
        obs.span_at("epoch_commit", t1, commit_s, epoch=epoch,
                    n_epochs=int(n_epochs))
        return prepare_s, commit_s

    def rebaseline(self) -> float:
        """Re-anchor the DTLP bounds at the current weights.

        Skeleton lower bounds decay as weights drift from the vfrag
        baseline (the paper's τ-degradation) and KSP-DG iteration counts
        — hence tail latency — blow up with them.  Weights themselves
        don't change, so worker slabs and epoch-keyed caches stay
        valid; only the control-plane index is rebuilt.  Returns seconds.
        """
        t0 = obs.clock()
        dt = self.dtlp.rebaseline()
        obs.span_at("rebaseline", t0, dt, epoch=self.epoch)
        return dt

    def rescale(self, n_workers: int) -> None:
        """Elastic rescale: re-place subgraphs onto a new worker set.

        No index rebuild — only placement, slabs and caches are redone.
        """
        self._build_workers(int(n_workers))

    # --------------------------------------------------- checkpoint/restore
    def checkpoint(self) -> dict:
        """A restart-sufficient snapshot: weights + cluster shape + state.

        Format 2 round-trips what format 1 silently dropped: the
        ``Placement`` (primary/replica/load) so a restored cluster does
        not re-place from scratch, per-worker stats (including the
        straggler EWMA — a restored cluster remembers who was slow),
        worker liveness/slow flags, and the graph epoch.  Format 3 adds
        per-worker epochs and the deferred update batches dead workers
        have not yet replayed — a restore that revives such a worker
        must force the same resync the original would have, instead of
        silently treating its slab as current.
        """
        g = self.dtlp.graph
        return {
            "format": 3,
            "n_workers": self.n_workers,
            "engine": self.engine,
            "epoch": self.epoch,
            "version": g.version,  # format-1 compat alias
            "z": self.dtlp.z,  # index shape: restore rebuilds with these
            "xi": self.dtlp.xi,
            "w": np.asarray(g.w, dtype=np.float64).copy(),
            "placement": {
                "primary": self.placement.primary.copy(),
                "replica": self.placement.replica.copy(),
                "load": self.placement.load.copy(),
            },
            "workers": [
                {
                    "stats": dataclasses.asdict(w.stats),
                    "alive": w.alive,
                    "slow": w.slow,
                    "auto_benched": w.auto_benched,
                    "epoch": w.epoch,
                    "pending": [
                        np.asarray(b, dtype=np.int64).copy()
                        for b in w.pending
                    ],
                }
                for w in self.workers
            ],
        }

    @classmethod
    def restore(cls, snap: dict, graph_factory, z: int | None = None,
                xi: int | None = None,
                engine=None, n_workers: int | None = None,
                device="cuda", mesh=None, mesh_axis=("data", "model"),
                straggler_factor: float | None = None,
                straggler_min_tasks: int = 8,
                **build_kw) -> "Cluster":
        """Rebuild a cluster from ``checkpoint()`` output.

        ``graph_factory`` recreates the static topology (initial
        weights); the snapshot's weights are then replayed as one update
        batch and the epoch fast-forwarded to the snapshot's, so the
        restored cluster answers exactly like — and reports the same
        epoch as — the original.  ``z``/``xi`` default to the snapshot's
        recorded index shape (format ≥ 2); pass them explicitly only to
        restore into a DIFFERENT index shape.  Placement and per-worker
        stats are restored when the worker count AND index shape match
        the snapshot (otherwise the cluster re-places and starts fresh
        stats).  The device is runtime configuration, not state: pass
        ``device`` for the restored cluster.
        """
        z = int(snap["z"]) if z is None else int(z)
        xi = int(snap["xi"]) if xi is None else int(xi)
        g = graph_factory()
        d = DTLP.build(g, z=z, xi=xi, **build_kw)
        n_workers = (int(snap["n_workers"]) if n_workers is None
                     else int(n_workers))
        same_shape = (
            n_workers == int(snap["n_workers"])
            and z == snap.get("z", z) and xi == snap.get("xi", xi)
        )
        placement = None
        if same_shape and "placement" in snap:
            pl = snap["placement"]
            primary = np.asarray(pl["primary"], dtype=np.int64).copy()
            if primary.shape[0] != d.partition.n_subgraphs:
                raise ValueError(
                    f"snapshot placement covers {primary.shape[0]} "
                    f"subgraphs but the rebuilt index has "
                    f"{d.partition.n_subgraphs} — graph_factory does not "
                    "reproduce the checkpointed topology"
                )
            placement = Placement(
                primary=primary,
                replica=np.asarray(pl["replica"], dtype=np.int64).copy(),
                load=np.asarray(pl["load"], dtype=np.float64).copy(),
                n_workers=n_workers,
            )
        cl = cls(
            d, n_workers,
            engine=engine if engine is not None else str(snap["engine"]),
            device=device, mesh=mesh, mesh_axis=mesh_axis,
            straggler_factor=straggler_factor,
            straggler_min_tasks=straggler_min_tasks,
            placement=placement,
        )
        w = np.asarray(snap["w"], dtype=np.float64)
        changed = np.nonzero(w != g.w)[0]
        if changed.shape[0]:
            cl.apply_updates(changed, w[changed])
        epoch = int(snap.get("epoch", snap.get("version", g.version)))
        g.advance_epoch_to(epoch)
        for wk in cl.workers:
            wk._stamp(epoch)
        if same_shape and "workers" in snap:
            for wk, ws in zip(cl.workers, snap["workers"]):
                wk.stats = WorkerStats(**ws["stats"])
                wk.alive = bool(ws["alive"])
                wk.slow = bool(ws["slow"])
                wk.auto_benched = bool(ws.get("auto_benched", False))
                if int(snap.get("format", 1)) >= 3:
                    # a dead worker's deferred batches round-trip, and
                    # its epoch rewinds to the recorded lag, so reviving
                    # it forces the resync the original still owed —
                    # contents are already current (the slab was packed
                    # at the snapshot weights), but the epoch/resync
                    # bookkeeping must match the pre-checkpoint cluster
                    wk.pending = [
                        np.asarray(b, dtype=np.int64).copy()
                        for b in ws.get("pending", [])
                    ]
                    if not wk.alive:
                        wk._stamp(int(ws.get("epoch", epoch)))
        return cl
