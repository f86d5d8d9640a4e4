"""KSPService: the one public way to serve KSP queries.

The facade over the distributed runtime — typed requests in, epoch-
stamped results out, with a submit/poll/drain lifecycle wrapping the
pipelined cross-query scheduler:

* **Epoch-versioned serving.**  Every admitted query is stamped with the
  graph epoch that will answer it.  How an :class:`UpdateBatch` lands is
  ``ServiceConfig.update_mode``: ``"barrier"`` (the reference) freezes
  admission, drains the in-flight set (those queries answer at the
  pre-update epoch), applies the batch (bumping the epoch and patching
  every live worker's slab), then resumes; ``"streaming"`` never drains
  — the next epoch's index deltas and worker slabs are prepared in
  shadow buffers while serving continues, the handoff is a pointer swap
  with per-query epoch fencing (in-flight queries keep refining against
  their admission epoch's double-buffered state), and queued batches
  coalesce last-write-wins per edge so prep never falls behind the
  feed.  ``QueryRequest.min_epoch`` holds a query until the epoch
  reaches it, or rejects it outright when no queued update can get
  there.
* **SLO admission.**  ``QueryRequest.deadline_ms`` rejects by *predicted*
  queue delay (EWMA of recent tick latency × queue depth), not just
  queue depth — the service refuses work it already knows it cannot
  serve in time.
* **Pluggable engines.**  ``ServiceConfig.engine`` names an
  :class:`repro.engine.registry.EngineSpec`; no string-switch reaches
  past the registry.

``Cluster.query`` and ``QueryScheduler.submit/run`` remain as internals
(and for tests); entry points — ``launch/serve.py``, the examples, the
batch/scaleout benchmarks — construct a ``KSPService`` from a
``ServiceConfig``.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
from collections import deque

import numpy as np

from repro_torch import obs
from repro_torch.core.dtlp import DTLP
from repro_torch.core.graph import dedupe_updates
from repro_torch.core.kspdg import QueryStats
from repro_torch.core.variants import make_variant
from repro_torch.dist.cluster import Cluster
from repro_torch.dist.scheduler import QueryScheduler, QueueFull, drive_trace

from .types import (
    AdmissionError,
    DeadlineExceeded,
    EpochUnsatisfiable,
    QueryRequest,
    QueryResult,
    QueueRejected,
    ServiceConfig,
    ServiceStats,
    ServiceTicket,
    UpdateBatch,
)


class _Fanout:
    """Accumulator for one one_to_many request's per-target sub-queries.

    ``absorb`` collects finished scheduler tickets by target index;
    ``assemble`` builds the single :class:`QueryResult` once all are in:
    ``by_target`` in request order (paths un-reversed when the fanout
    submitted swapped target→source queries), ``paths`` merged weight-
    ascending, epoch = the oldest sub-query's (the conservative
    freshness claim), latency = the slowest sub-query's, stats = the
    field-wise aggregate (counters summed, flags OR-ed).
    """

    __slots__ = ("ticket", "targets", "rev", "parts", "missing")

    def __init__(self, ticket: ServiceTicket, targets, rev: bool):
        self.ticket = ticket
        self.targets = tuple(targets)
        self.rev = bool(rev)
        self.parts: dict = {}  # target index → finished scheduler ticket
        self.missing = len(self.targets)

    def absorb(self, idx: int, tk) -> bool:
        """Store one finished sub-query; True once every target answered."""
        self.parts[idx] = tk
        self.missing -= 1
        return self.missing == 0

    def assemble(self) -> QueryResult:
        """Merge the per-target sub-results into one ``QueryResult``."""
        by_target = []
        merged = []
        agg = QueryStats()
        int_fields = [f.name for f in dataclasses.fields(QueryStats)
                      if f.type == "int"]
        epoch = None
        latency = 0.0
        for idx in range(len(self.targets)):
            tk = self.parts[idx]
            paths = [(d, tuple(reversed(p))) for d, p in tk.result] \
                if self.rev else list(tk.result)
            by_target.append(tuple(paths))
            merged.extend(paths)
            epoch = tk.epoch if epoch is None else min(epoch, tk.epoch)
            latency = max(latency, tk.latency or 0.0)
            for name in int_fields:
                setattr(agg, name,
                        getattr(agg, name) + getattr(tk.stats, name))
            agg.truncated |= tk.stats.truncated
            agg.bound_clipped |= tk.stats.bound_clipped
        merged.sort(key=lambda x: (x[0], x[1]))
        return QueryResult(
            qid=self.ticket.qid,
            paths=tuple(merged),
            epoch=int(epoch),
            stats=agg,
            latency_ms=float(latency) * 1e3,
            by_target=tuple(by_target),
        )


class KSPService:
    """Typed serving facade: queries and weight updates through one door.

    Construct over a built index (``KSPService(dtlp, config)``), from a
    raw graph (``KSPService.build(graph, config)``), or from a snapshot
    (``KSPService.restore(snap, graph_factory, config)``).  Then:

        svc = KSPService.build(graph, ServiceConfig(engine="dense_bf"))
        ticket = svc.submit(QueryRequest(s=0, t=99, k=3))
        svc.update(UpdateBatch(eids, new_w))       # epoch barrier
        result = svc.poll(ticket) or ...           # or svc.drain()
        result.epoch, result.paths, result.stats

    ``query(s, t, k)`` is the one-shot convenience; ``replay(requests,
    arrival_times=...)`` serves a timed trace on the scheduler's
    simulated clock (the benchmark/driver path).
    """

    def __init__(self, dtlp: DTLP | None = None,
                 config: ServiceConfig | None = None, *,
                 cluster: Cluster | None = None):
        if (dtlp is None) == (cluster is None):
            raise ValueError("supply exactly one of dtlp or cluster")
        self.config = config if config is not None else ServiceConfig()
        cfg = self.config
        if cluster is None:
            cluster = Cluster(
                dtlp, cfg.n_workers, engine=cfg.engine, device=cfg.device,
                mesh=cfg.mesh, mesh_axis=cfg.mesh_axis,
                straggler_factor=cfg.straggler_factor,
                straggler_min_tasks=cfg.straggler_min_tasks,
            )
        self.cluster = cluster
        self.dtlp = cluster.dtlp
        self.scheduler = QueryScheduler(
            cluster, max_in_flight=cfg.max_in_flight,
            max_queue=cfg.max_queue, max_iterations=cfg.max_iterations,
            ref_stream=cfg.ref_stream, pipeline_depth=cfg.pipeline_depth,
        )
        self.stats = ServiceStats()
        self._qid = itertools.count()
        self._updates: deque[UpdateBatch] = deque()
        self._update_clocks: deque[float] = deque()  # enqueue instants
        self._held: list[ServiceTicket] = []  # waiting on min_epoch
        self._by_sqid: dict[int, ServiceTicket] = {}
        # EWMA of seconds to apply/prepare one UpdateBatch: the
        # update-prep term of predicted_wait (SLO admission must see
        # queued batches, not just queued queries)
        self._apply_ewma = 0.0
        # per-batch update-visibility lag (seconds on the scheduler
        # clock, enqueue → epoch commit) — the streaming benchmark's
        # freshness metric; barrier mode records it too
        self.update_lags: list[float] = []
        # one export surface over every layer's accounting: the Stats
        # dataclasses register as providers (live views — snapshot()
        # reads their CURRENT fields), measurements go to histograms
        self.registry = obs.MetricsRegistry()
        self.registry.provider("service", lambda: {
            **dataclasses.asdict(self.stats),
            "rejected": self.stats.rejected,
        })
        self.registry.provider("scheduler", lambda: {
            **dataclasses.asdict(self.scheduler.stats),
            "tasks_deduped": self.scheduler.stats.tasks_deduped,
            "idle_fracs": self.scheduler.stats.idle_fracs(),
            "tick_latency_ewma_ms": self.scheduler.tick_latency_ewma * 1e3,
        })
        self.registry.provider("workers", lambda: [
            {
                "wid": w.wid,
                **dataclasses.asdict(w.stats),
                "alive": w.alive,
                "slow": w.slow,
                "auto_benched": w.auto_benched,
            }
            for w in self.cluster.workers
        ])
        self.registry.provider("cluster", lambda: {
            "engine": self.cluster.engine,
            "n_workers": self.cluster.n_workers,
            "epoch": self.cluster.epoch,
            "reissues": self.cluster.reissues,
            "resyncs": self.resyncs,
            "auto_slowed": self.cluster.auto_slowed,
            "auto_recovered": self.cluster.auto_recovered,
        })
        self._lat_hist = self.registry.histogram("query_latency_ms")
        self._lag_hist = self.registry.histogram("update_lag_ms")
        # consecutive deadline rejections with no admission in between:
        # the rejection-storm trigger for a flight-recorder dump
        self._deadline_streak = 0
        self.flight_dumps: list[dict] = []

    # ------------------------------------------------------- construction
    @classmethod
    def build(cls, graph, config: ServiceConfig | None = None,
              **dtlp_kw) -> "KSPService":
        """Build the DTLP index (``config.z``/``config.xi``) on the device
        it serves on (``config.device``) and serve it."""
        cfg = config if config is not None else ServiceConfig()
        d = DTLP.build(graph, z=cfg.z, xi=cfg.xi, device=cfg.device,
                       **dtlp_kw)
        return cls(d, cfg)

    @classmethod
    def restore(cls, snap: dict, graph_factory,
                config: ServiceConfig | None = None,
                **build_kw) -> "KSPService":
        """Stand a service up from ``checkpoint()`` output.

        With ``config=None`` the engine, worker count and index shape
        (``z``/``xi``) all come from the snapshot; a supplied config
        overrides them (a different shape re-places and starts fresh
        worker stats — see ``Cluster.restore``).
        """
        cfg = config if config is not None else ServiceConfig(
            engine=str(snap["engine"]), n_workers=int(snap["n_workers"]),
            z=int(snap["z"]), xi=int(snap["xi"]),
        )
        cluster = Cluster.restore(
            snap, graph_factory, z=cfg.z, xi=cfg.xi,
            engine=cfg.engine, n_workers=cfg.n_workers, device=cfg.device,
            mesh=cfg.mesh, mesh_axis=cfg.mesh_axis,
            straggler_factor=cfg.straggler_factor,
            straggler_min_tasks=cfg.straggler_min_tasks,
            **build_kw,
        )
        svc = cls(config=cfg, cluster=cluster)
        state = snap.get("service")
        if state is not None:  # format ≥ 4: cumulative metrics round-trip
            svc.stats = ServiceStats(**state["stats"])
            bs = dict(state["scheduler_stats"])
            # worker_busy_s keys may come back as strings (a snapshot
            # that went through JSON); BatchStats wants int wids
            bs["worker_busy_s"] = {
                int(w): float(s)
                for w, s in bs.get("worker_busy_s", {}).items()
            }
            svc.scheduler.stats = type(svc.scheduler.stats)(**bs)
            svc.update_lags = [float(x) for x in state.get("update_lags", [])]
            svc._apply_ewma = float(state.get("apply_ewma", 0.0))
            for name, hsnap in state.get("histograms", {}).items():
                svc.registry.histogram(
                    name, bounds=hsnap["bounds"]
                ).load(hsnap)
        return svc

    def checkpoint(self) -> dict:
        """Cluster snapshot plus the service's cumulative metrics.

        Format 4 = the cluster's format-3 snapshot (placement, worker
        state, epoch, weights — see ``Cluster.checkpoint``) with a
        ``"service"`` section so a restored service's ``snapshot()``
        continues monotonically from the original's counters instead of
        silently resetting the fleet's history.
        """
        snap = self.cluster.checkpoint()
        snap["format"] = 4
        snap["service"] = {
            "stats": dataclasses.asdict(self.stats),
            "scheduler_stats": dataclasses.asdict(self.scheduler.stats),
            "update_lags": list(self.update_lags),
            "apply_ewma": self._apply_ewma,
            "histograms": {
                h.name: h.snapshot()
                for h in (self._lat_hist, self._lag_hist)
            },
        }
        return snap

    # ----------------------------------------------------------- telemetry
    def snapshot(self) -> dict:
        """One JSON-serializable view of every layer's accounting.

        Merges ``ServiceStats`` + scheduler ``BatchStats`` (with derived
        idle fractions and dedup counts) + per-worker ``WorkerStats``
        (resyncs, probation state included) + cluster routing counters +
        the live latency/lag histograms — the schema
        ``benchmarks/common.service_row`` flattens into bench rows and
        flight-recorder dumps attach for post-mortems.
        """
        return {"epoch": self.epoch, **self.registry.snapshot()}

    def _flight_dump(self, reason: str) -> dict | None:
        """Take one flight-recorder dump (when obs is recording): the
        recent per-track window plus the metrics snapshot, kept on
        ``self.flight_dumps`` and appended to ``config.flight_dump_path``
        (JSON lines) when set."""
        dump = obs.flight_dump(reason)
        if dump is None:
            return None
        dump["snapshot"] = self.snapshot()
        self.flight_dumps.append(dump)
        self.stats.flight_dumps += 1
        path = self.config.flight_dump_path
        if path:
            with open(path, "a") as f:
                json.dump(dump, f)
                f.write("\n")
        return dump

    @property
    def epoch(self) -> int:
        """Current graph epoch (one bump per applied UpdateBatch)."""
        return self.cluster.epoch

    @property
    def resyncs(self) -> int:
        """Stale-replica slab re-syncs across the fleet."""
        return sum(w.stats.resyncs for w in self.cluster.workers)

    @property
    def reissues(self) -> int:
        """Tasks re-routed to a replica after their primary died."""
        return self.cluster.reissues

    def predicted_wait_ms(self) -> float:
        """The SLO admission signal: predicted queue delay, in ms.

        Folds queued/preparing update batches into the estimate: each
        costs one apply (EWMA of observed apply times), and in barrier
        mode a pending batch additionally freezes admission until every
        in-flight query drains (≈ active count × tick latency EWMA).
        Without this, ``deadline_ms`` admission systematically
        underestimates the wait whenever a swap is pending.
        """
        wait = self.scheduler.predicted_wait()
        if self._updates:
            wait += len(self._updates) * self._apply_ewma
            if self.config.update_mode == "barrier":
                wait += (len(self.scheduler.active)
                         * self.scheduler.tick_latency_ewma)
        return wait * 1e3

    # ----------------------------------------------------------- admission
    def submit(self, request: QueryRequest, *,
               arrival: float | None = None) -> ServiceTicket:
        """Admit one query; raises :class:`AdmissionError` subclasses.

        Checks run in order: epoch satisfiability (``min_epoch`` beyond
        every scheduled update → :class:`EpochUnsatisfiable`), the SLO
        deadline (predicted queue delay > ``deadline_ms`` →
        :class:`DeadlineExceeded`), then queue capacity
        (:class:`QueueRejected`).  A satisfiable-but-not-yet ``min_epoch``
        holds the ticket service-side until the barrier advances the
        epoch far enough.
        """
        req = request
        horizon = self.epoch + len(self._updates)
        if req.min_epoch is not None and req.min_epoch > horizon:
            self.stats.rejected_epoch += 1
            raise EpochUnsatisfiable(
                f"min_epoch {req.min_epoch} unreachable: epoch {self.epoch} "
                f"+ {len(self._updates)} queued update batch(es)"
            )
        if req.deadline_ms is not None:
            predicted = self.predicted_wait_ms()
            if predicted > req.deadline_ms:
                self.stats.rejected_deadline += 1
                self._deadline_streak += 1
                if self._deadline_streak == self.config.reject_storm:
                    # a storm: the service has been refusing every
                    # arrival for a while — capture what the workers
                    # were doing while the backlog stopped draining
                    self._flight_dump("deadline_storm")
                raise DeadlineExceeded(
                    f"predicted queue delay {predicted:.1f}ms exceeds "
                    f"deadline {req.deadline_ms:.1f}ms"
                )
        self._deadline_streak = 0
        ticket = ServiceTicket(
            qid=next(self._qid), request=req,
            arrival=self.scheduler.clock if arrival is None else float(arrival),
        )
        if req.min_epoch is not None and req.min_epoch > self.epoch:
            self._held.append(ticket)
            self.stats.held_for_epoch += 1
        else:
            self._enqueue(ticket)
        self.stats.submitted += 1
        return ticket

    def _enqueue(self, ticket: ServiceTicket) -> None:
        req = ticket.request
        if req.variant == "one_to_many":
            self._enqueue_fanout(ticket)
            return
        policy = make_variant(req.variant, stretch=req.stretch,
                              min_dist=req.min_dist, cost_add=req.cost_add,
                              pool=req.pool)
        try:
            tk = self.scheduler.submit(
                req.s, req.t, req.k,
                arrival=ticket.arrival, variant=policy,
            )
        except QueueFull as e:
            self.stats.rejected_queue += 1
            raise QueueRejected(str(e)) from e
        ticket._ticket = tk
        self._by_sqid[tk.qid] = ticket

    def _enqueue_fanout(self, ticket: ServiceTicket) -> None:
        """Fan a one_to_many request into per-target scheduler queries.

        The sub-queries run CONCURRENTLY through the shared pipes, so
        their refine tasks de-duplicate against each other (targets near
        each other mostly cross the same boundary pairs) and against
        every other in-flight query.  On undirected graphs each
        sub-query is submitted target→source: the reference stream's
        per-target sidetrack tree is keyed by the search target, so the
        swapped orientation gives all sub-queries ONE shared
        ``ref_tree_cache`` entry (the source's reverse SPT) instead of
        one tree per target; paths are un-reversed at assembly.
        Directed graphs skip the swap — task-level dedup still applies.
        """
        req = ticket.request
        rev = not self.dtlp.graph.directed
        fan = _Fanout(ticket, req.targets, rev)
        added = []
        try:
            for idx, tgt in enumerate(req.targets):
                s, t = (tgt, req.s) if rev else (req.s, tgt)
                tk = self.scheduler.submit(s, t, req.k,
                                           arrival=ticket.arrival)
                self._by_sqid[tk.qid] = (fan, idx)
                added.append(tk.qid)
        except QueueFull as e:
            # partial fanout: orphan the already-submitted sub-queries
            # (their completions no-op against _by_sqid) and reject
            for qid in added:
                self._by_sqid.pop(qid, None)
            self.stats.rejected_queue += 1
            raise QueueRejected(str(e)) from e
        ticket._ticket = fan

    def update(self, batch: UpdateBatch, *, wait: bool = True) -> int:
        """Queue a weight-update batch for the configured update mode.

        Barrier mode orders it behind every in-flight query (admission
        freezes, the in-flight set drains, then the batch applies);
        streaming mode commits it as an epoch handoff, draining
        nothing.  With ``wait=True`` (default) ticks until the batch
        has applied and returns the new epoch; ``wait=False`` queues it
        for the next safe point (a later ``tick``/``poll``/``drain``
        applies it — queued streaming batches coalesce).
        """
        if not isinstance(batch, UpdateBatch):
            raise TypeError(
                f"update takes an UpdateBatch, got {type(batch).__name__}"
            )
        self._updates.append(batch)
        self._update_clocks.append(self.scheduler.clock)
        if wait:
            while self._updates:
                self.tick()
        return self.epoch

    # ------------------------------------------------------------ lifecycle
    def tick(self) -> list[ServiceTicket]:
        """One service round: update bookkeeping (barrier drain or
        streaming handoff, per ``config.update_mode``), held-query
        release, one scheduler tick.  Returns the tickets completed.

        Any exception escaping the round — ``StaleReplicaError``, data
        loss, an engine failure — first triggers a flight-recorder dump
        (when obs is recording), so the last thing every worker did
        before the failure is on disk before the stack unwinds.
        """
        try:
            return self._tick()
        except Exception as e:
            self._flight_dump(f"exception:{type(e).__name__}")
            raise

    def _tick(self) -> list[ServiceTicket]:
        if self.config.update_mode == "streaming":
            self._stream_updates()
        else:
            self._barrier()
        self._release_held()
        out = []
        for tk in self.scheduler.tick():
            entry = self._by_sqid.pop(tk.qid, None)
            if entry is None:
                continue  # raw-scheduler submission, not ours
            if isinstance(entry, tuple):
                # one_to_many sub-query: fold into its fanout, resolve
                # the service ticket only when every target is answered
                fan, idx = entry
                if not fan.absorb(idx, tk):
                    continue
                ticket = fan.ticket
                ticket.result = fan.assemble()
            else:
                ticket = entry
                ticket.result = QueryResult(
                    qid=ticket.qid,
                    paths=tuple(tk.result),
                    epoch=int(tk.epoch),
                    stats=tk.stats,
                    latency_ms=float(tk.latency or 0.0) * 1e3,
                )
            self._lat_hist.observe(ticket.result.latency_ms)
            self.stats.completed += 1
            out.append(ticket)
        return out

    def _barrier(self) -> None:
        """Order queued UpdateBatches against in-flight queries: freeze
        admission while any query is mid-flight, apply at the safe point."""
        if not self._updates:
            return
        if self.scheduler.active:
            self.scheduler.freeze_admission = True
            self.stats.barrier_ticks += 1
            return
        while self._updates:
            batch = self._updates.popleft()
            enq = self._update_clocks.popleft()
            dt = self.cluster.apply_updates(batch.eids, batch.new_w)
            self._observe_apply(dt)
            self._observe_lag(max(0.0, self.scheduler.clock - enq))
            self.stats.update_batches += 1
        self._maybe_rebaseline()
        self.scheduler.freeze_admission = False

    def _stream_updates(self) -> None:
        """Commit queued UpdateBatches as one streaming epoch handoff.

        The gate: every in-flight query must already be at the CURRENT
        epoch (the double buffer retains exactly one previous epoch, so
        a second handoff cannot open while epoch-*e* queries still
        run).  Queued batches coalesce — concatenated in arrival order,
        de-duplicated last-write-wins per edge — into ONE prepare/swap
        whose epoch advances by the batch count, so per-batch epoch
        accounting (``min_epoch`` horizons, result stamps) matches N
        barrier commits.  Admission is never frozen.
        """
        if not self._updates:
            return
        min_ep = self.scheduler.min_active_epoch()
        if min_ep is not None and min_ep < self.epoch:
            self.stats.handoff_waits += 1
            return
        batches = list(self._updates)
        clocks = list(self._update_clocks)
        self._updates.clear()
        self._update_clocks.clear()
        eids, new_w = dedupe_updates(
            np.concatenate([b.eids for b in batches]),
            np.concatenate([b.new_w for b in batches]),
        )
        prep_s, commit_s = self.cluster.apply_updates_streaming(
            eids, new_w, n_epochs=len(batches)
        )
        self._observe_apply(prep_s + commit_s)
        for enq in clocks:
            self._observe_lag(max(0.0, self.scheduler.clock - enq))
        self.stats.update_batches += len(batches)
        self.stats.coalesced_batches += len(batches) - 1
        # drift rebaseline fires at the commit, no drain needed: weights
        # are unchanged by it, in-flight steppers hold their admission
        # snapshots, and only the control-plane index is rebuilt
        self._maybe_rebaseline()

    def _observe_apply(self, dt: float) -> None:
        self._apply_ewma = (dt if self._apply_ewma == 0.0
                            else 0.3 * dt + 0.7 * self._apply_ewma)

    def _observe_lag(self, lag_s: float) -> None:
        self.update_lags.append(lag_s)
        self._lag_hist.observe(lag_s * 1e3)

    def _maybe_rebaseline(self) -> None:
        drift_gate = self.config.rebaseline_drift
        if drift_gate and self.dtlp.drift() > drift_gate:
            self.cluster.rebaseline()
            self.stats.rebaselines += 1

    def _release_held(self) -> None:
        if not self._held:
            return
        still = []
        for ticket in self._held:
            if ticket.request.min_epoch <= self.epoch:
                try:
                    self._enqueue(ticket)
                except QueueRejected:
                    ticket.rejected = QueueRejected.reason
            else:
                still.append(ticket)
        self._held = still

    def poll(self, ticket: ServiceTicket) -> QueryResult | None:
        """Advance the service one tick unless the ticket already
        resolved; returns its result when available."""
        if not ticket.done:
            self.tick()
        return ticket.result

    def drain(self) -> list[ServiceTicket]:
        """Tick until no queries (queued, held, or in flight) and no
        update batches remain; returns the tickets that completed."""
        out: list[ServiceTicket] = []
        while (self.scheduler.queue or self.scheduler.active
               or self._held or self._updates):
            out.extend(self.tick())
        return out

    def query(self, s: int, t: int, k: int = 3, **req_kw) -> QueryResult:
        """One-shot convenience: submit and serve to completion."""
        ticket = self.submit(QueryRequest(int(s), int(t), int(k), **req_kw))
        while not ticket.done:
            self.tick()
        if ticket.rejected is not None:
            raise AdmissionError(
                f"query ({s}→{t}) rejected after hold: {ticket.rejected}"
            )
        return ticket.result

    # ------------------------------------------------------------ workloads
    def replay(self, requests, *, arrival_times=None,
               batch_window: float | None = None) -> list[ServiceTicket]:
        """Serve a timed trace of :class:`QueryRequest`s; returns every
        ticket — rejected ones included, with ``ticket.rejected`` set —
        in submission order.

        ``arrival_times`` gives each request's arrival on the scheduler's
        simulated clock (seconds, ascending); ``None`` means all at once.
        ``batch_window`` (seconds; default ``config.batch_window_ms``)
        groups arrivals into the same admission burst when the scheduler
        is under-occupied.  Admission — deadline, epoch, queue bound —
        runs per request as it arrives, so an overloaded stretch of the
        trace shows up as ``stats.rejected_*`` instead of an exception.
        """
        reqs = [
            r if isinstance(r, QueryRequest) else QueryRequest(*r)
            for r in requests
        ]
        sched = self.scheduler
        if arrival_times is None:
            arrivals = [sched.clock] * len(reqs)
        else:
            arrivals = [float(a) for a in arrival_times]
            if len(arrivals) != len(reqs):
                raise ValueError("arrival_times length != requests length")
        window = (self.config.batch_window_ms / 1e3
                  if batch_window is None else float(batch_window))
        tickets: list[ServiceTicket] = []

        def submit_at(i, arrival):
            try:
                tickets.append(self.submit(reqs[i], arrival=arrival))
            except AdmissionError as e:
                tickets.append(ServiceTicket(
                    qid=next(self._qid), request=reqs[i],
                    arrival=arrival, rejected=e.reason,
                ))

        drive_trace(
            sched, arrivals, submit_at, self.tick,
            extra_pending=lambda: bool(self._held or self._updates),
            window=window,
        )
        return tickets

    # --------------------------------------------------------------- faults
    def kill(self, wid: int) -> None:
        """Fault injection: kill a worker (replicas take over)."""
        self.cluster.kill(wid)

    def revive(self, wid: int) -> None:
        """Bring a dead worker back; it re-syncs before serving again."""
        self.cluster.revive(wid)

    def mark_slow(self, wid: int, flag: bool = True) -> None:
        """Manual straggler injection (auto-detection also sets this)."""
        self.cluster.mark_slow(wid, flag)

    def rescale(self, n_workers: int) -> None:
        """Elastic rescale (drains in-flight queries first: worker slabs
        and caches are rebuilt, so mid-flight hand-off is meaningless)."""
        self.drain()
        self.cluster.rescale(n_workers)
