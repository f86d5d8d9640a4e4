"""Cross-query batched serving: pipelined scheduling of concurrent KSP
queries over one worker cluster.

``Cluster.query`` drives one KSP-DG instance at a time, so the grouped
[S, J, z] dense solves run at single-query occupancy.  The
``QueryScheduler`` keeps N queries in flight as resumable steppers
(``core.kspdg.ksp_dg_stepper``) and, in its default **pipelined** mode,
gives every worker its own asynchronous pipe:

    pipe (one per worker):
      backlog  — batches of (gid, a, b) refine tasks waiting to
                 dispatch, de-duplicated ACROSS queries per
                 (epoch, k): a query whose task is already queued (or
                 already in flight) joins the existing batch instead of
                 re-requesting it;
      inflight — up to ``pipeline_depth`` dispatched batches (device
                 solves issued, results unforced).  The open backlog
                 batch keeps filling while the previous one solves —
                 the double-buffered dispatch slot.

    pump (one ``tick``): fill every pipe's free slots, then step each
    pipe's oldest in-flight batch one device round.  A ``step`` forces
    the previous round (the only point the host waits on the device),
    does the host-side Yen absorb/promote, and dispatches the next
    round — which then cooks on the device while the pump steps OTHER
    workers' pipes.  Device solves overlap host splicing with no
    threads: JAX async dispatch does the overlap, the pump does the
    interleaving.  When a batch completes, every query waiting on it
    splices its segment lists (``cluster.merge_segments``) and advances
    one KSP-DG iteration immediately — a query whose stop rule fires
    resolves its ticket on the spot, at the incrementally-advanced
    clock, not at a global tick boundary.

``pipeline=False`` retains the original lockstep tick (gather → merge →
dispatch → scatter, one global barrier per round): it is the reference
schedule the determinism tests replay against, and the two modes produce
byte-identical answers — the stepper is the same code, every partial-KSP
solve is exact regardless of batch composition, and ``merge_segments``
builds the same segment lists, so scheduling changes the overlap, never
the math.

Admission control sits on top: a bounded FIFO queue (``max_queue``), a
cap on in-flight queries (``max_in_flight``) and, in ``run``, a batch
window that groups simulated arrivals before a tick starts.
``repro.service.KSPService`` is the public serving surface over this
scheduler — it adds typed requests, epoch stamping/barriers (via
``freeze_admission``) and deadline-based SLO admission (via
``predicted_wait``); ``submit``/``run`` here are internals.  Epoch
safety is per-ticket: every batch carries the ADMISSION epoch of its
waiting queries (the cross-query join key is (epoch, k, task), both
modes), and workers are told which epoch to solve at.  In barrier mode
update batches still apply only while ``active`` is empty, so all
in-flight dedup shares one epoch and behavior is byte-identical to the
pre-epoch-fencing scheduler; in streaming mode a swap may commit with
epoch-*e* queries in flight — they keep refining against the workers'
double-buffered *e* state while *e+1* admissions batch separately.
"""

from __future__ import annotations

import dataclasses
import itertools
from collections import deque

from repro_torch import obs
from repro_torch.core.kspdg import ksp_dg_stepper, refine_groups

from .cluster import Cluster, merge_segments


@dataclasses.dataclass
class BatchStats:
    """Aggregate scheduler counters (one instance per scheduler)."""

    ticks: int = 0
    admitted: int = 0
    completed: int = 0
    rejected: int = 0  # bounced by the bounded admission queue
    tasks_requested: int = 0  # per-query (gid, a, b) tasks before merging
    tasks_dispatched: int = 0  # after cross-query de-dup
    batches_dispatched: int = 0  # grouped Worker.execute batches issued
    max_queue_depth: int = 0
    max_in_flight: int = 0
    # pipeline occupancy: peak dispatched-but-unfinished batches across
    # all pipes (≤ n_workers × pipeline_depth; 1 in lockstep mode where
    # exactly one batch is ever in flight)
    max_inflight_batches: int = 0
    # wall seconds inside working (non-idle) ticks, and the share each
    # worker spent actually being driven (dispatch + step + deliver):
    # idle fraction of worker w = 1 - worker_busy_s[w] / working_s
    working_s: float = 0.0
    worker_busy_s: dict = dataclasses.field(default_factory=dict)

    @property
    def tasks_deduped(self) -> int:
        """Tasks answered by another concurrent query's identical task.

        ``tasks_requested`` counts every per-query task at gather time;
        ``tasks_dispatched`` counts unique tasks per dispatched worker
        batch — so joins against both QUEUED and IN-FLIGHT batches
        (per-worker pipeline dedup) land here, exactly like the
        per-global-tick merge did in lockstep mode.
        """
        return self.tasks_requested - self.tasks_dispatched

    def idle_fracs(self) -> dict:
        """Per-worker idle fraction of working time (pipeline health)."""
        if self.working_s <= 0.0:
            return {}
        return {
            wid: max(0.0, 1.0 - busy / self.working_s)
            for wid, busy in sorted(self.worker_busy_s.items())
        }


@dataclasses.dataclass
class QueryTicket:
    """One admitted query's handle: identity, timing, and result."""

    qid: int
    s: int
    t: int
    k: int
    # optional core.variants.VariantPolicy bending the stepper to a
    # different workload (diverse / bounded); None = plain top-k.  The
    # policy only changes the stepper's stop rule and pool depth — its
    # refine tasks still dedup/batch through the shared pipes, keyed by
    # the RefineRequest's solve_k
    variant: object = None
    arrival: float = 0.0  # scheduler clock at submit
    admitted_at: float | None = None
    finished_at: float | None = None
    ticks: int = 0  # KSP-DG refine rounds this query advanced through
    epoch: int | None = None  # graph epoch the query was admitted under
    result: list | None = None
    stats: object = None  # core QueryStats, set on completion
    _stepper: object = dataclasses.field(default=None, repr=False)
    _request: object = dataclasses.field(default=None, repr=False)
    # wall clock (obs.clock) at submit — the queue_wait span's origin;
    # distinct from `arrival`, which lives on the SIMULATED clock
    _t_wall: float = dataclasses.field(default=0.0, repr=False)

    @property
    def done(self) -> bool:
        """The query finished: its stop rule fired and ``result`` is set."""
        return self.finished_at is not None

    @property
    def latency(self) -> float | None:
        """Queueing + service time on the scheduler clock (seconds)."""
        if self.finished_at is None:
            return None
        return self.finished_at - self.arrival


class QueueFull(RuntimeError):
    """Raised by ``submit`` when the bounded admission queue is full."""


class _Batch:
    """One worker-bound group of de-duplicated refine tasks.

    Fills while in a pipe's backlog (``open``), then dispatches as ONE
    ``Worker.execute_async`` call; queries joining after dispatch still
    share its results (their tasks are in ``tasks``), they just can't
    add new ones — the next open batch takes those.
    """

    __slots__ = ("wid", "epoch", "k", "tasks", "waiters", "future",
                 "t_dispatch")

    def __init__(self, wid: int, epoch: int, k: int):
        self.wid = wid
        self.epoch = epoch
        self.k = k
        self.tasks: dict = {}  # ordered {(gid, a, b): None}
        self.waiters: dict = {}  # ordered {_Pending: [its tasks here]}
        self.future = None  # SolveFuture once dispatched
        self.t_dispatch = None  # obs.clock at dispatch (solve EWMA)


class _Pending:
    """One query's outstanding refine round: which batches it waits on
    and the per-task results collected so far."""

    __slots__ = ("tk", "req", "pair_gids", "results", "missing")

    def __init__(self, tk: QueryTicket, req, pair_gids):
        self.tk = tk
        self.req = req
        self.pair_gids = pair_gids
        self.results: dict = {}  # (gid, a, b) → [(dist, path)]
        self.missing = 0  # undelivered batches this round waits on


class _WorkerPipe:
    """One worker's asynchronous pipeline state."""

    __slots__ = ("wid", "open", "backlog", "inflight", "solve_ewma",
                 "solve_samples")

    def __init__(self, wid: int):
        self.wid = wid
        self.open: dict = {}  # (epoch, k) → the backlog batch still filling
        self.backlog: deque = deque()  # batches awaiting a dispatch slot
        self.inflight: deque = deque()  # dispatched, ≤ pipeline_depth
        # EWMA of dispatch→delivery wall seconds per batch: the
        # per-worker service-time signal predicted_wait multiplies by
        # this pipe's depth
        self.solve_ewma = 0.0
        self.solve_samples = 0

    @property
    def depth(self) -> int:
        """Batches this pipe holds: queued backlog + dispatched in-flight."""
        return len(self.backlog) + len(self.inflight)


def drive_trace(sched, arrivals, submit_at, tick, *,
                extra_pending=lambda: False, window: float = 0.0) -> None:
    """The arrival-driven replay loop, shared by ``QueryScheduler.run``
    and ``repro.service.KSPService.replay`` so the tricky simulated-clock
    semantics exist exactly once.

    ``submit_at(i, arrival)`` admits request ``i`` (and owns rejection
    handling); ``tick()`` advances the system one round;
    ``extra_pending()`` reports caller-side work the loop must drain
    (held queries, queued update batches).  The clock advances by each
    tick's measured wall time; when the system is idle it jumps to the
    next arrival, and when it is under-occupied and the next arrival is
    within ``window`` seconds it waits (advances the clock) to group
    arrivals into the same admission burst.
    """
    i = 0
    n = len(arrivals)

    def submit_due(horizon):
        nonlocal i
        while i < n and arrivals[i] <= horizon:
            sched.clock = max(sched.clock, arrivals[i])
            submit_at(i, arrivals[i])
            i += 1

    while i < n or sched.queue or sched.active or extra_pending():
        submit_due(sched.clock)
        if not sched.queue and not sched.active and not extra_pending():
            if i >= n:
                break  # tail requests rejected at admission: all done
            sched.clock = max(sched.clock, arrivals[i])  # idle: jump
            continue
        if (window > 0.0 and i < n
                and len(sched.active) + len(sched.queue) < sched.max_in_flight
                and arrivals[i] <= sched.clock + window):
            submit_due(sched.clock + window)
        tick()


class QueryScheduler:
    """Cross-query batching over a ``Cluster`` — pipelined by default,
    lockstep under ``pipeline=False``.

    The scheduler keeps its own simulated clock: ``run`` advances it by
    measured wall time plus the arrival process, so latency percentiles
    reflect queueing delay under the given concurrency even though
    execution is single-threaded in-process.  In pipelined mode the
    clock advances *incrementally inside* a tick, so a query completing
    mid-pump is stamped at its actual completion instant.
    """

    def __init__(self, cluster: Cluster, *, max_in_flight: int = 8,
                 max_queue: int | None = None, max_iterations: int = 10_000,
                 ref_stream=None, pipeline: bool = True,
                 pipeline_depth: int = 2):
        self.cluster = cluster
        self.max_in_flight = max(1, int(max_in_flight))
        self.max_queue = None if max_queue is None else int(max_queue)
        self.max_iterations = int(max_iterations)
        # reference-path stream every admitted stepper consumes; None
        # inherits the cluster engine spec's default ("lazy" builtin)
        self.ref_stream = (cluster.spec.ref_stream if ref_stream is None
                           else ref_stream)
        self.pipeline = bool(pipeline)
        self.pipeline_depth = max(1, int(pipeline_depth))
        self.queue: deque[QueryTicket] = deque()
        self.active: list[QueryTicket] = []
        self.finished: list[QueryTicket] = []
        self.stats = BatchStats()
        self._qid = itertools.count()
        self.clock = 0.0
        # EWMA of working-tick wall latency (seconds): the queue-depth
        # term of predicted_wait in both modes (a pipelined tick is one
        # pump round: bounded by a single batch delivery)
        self.tick_latency_ewma = 0.0
        self._tick_samples = 0
        # epoch barrier hook (repro.service): while True, ticks keep
        # advancing in-flight queries but admit nothing, so a pending
        # UpdateBatch can be ordered after every query it must not affect
        self.freeze_admission = False
        # pipelined-mode state: per-worker pipes, the cross-query join
        # index (epoch, k, gid, a, b) → _Batch (queued OR in flight),
        # and the incremental clock mark (valid inside a tick only)
        self._pipes: dict[int, _WorkerPipe] = {}
        self._task_index: dict = {}
        self._mark: float | None = None

    def predicted_wait(self) -> float:
        """Predicted queueing delay (seconds) of the next submission.

        Lockstep: EWMA of recent tick latency × admission-queue depth.
        Pipelined: the deepest worker pipe bounds service — backlog +
        in-flight batches × that pipe's solve-time EWMA — plus the same
        queue term for submissions still waiting to be admitted.  Zero
        until first observations — admission must not reject on a cold
        scheduler.
        """
        queue_term = self.tick_latency_ewma * len(self.queue)
        if not self.pipeline:
            return queue_term
        worst = 0.0
        for pipe in self._pipes.values():
            if pipe.solve_ewma > 0.0 and pipe.depth:
                worst = max(worst, pipe.depth * pipe.solve_ewma)
        return worst + queue_term

    def min_active_epoch(self) -> int | None:
        """Oldest admission epoch among in-flight queries, or None when
        nothing is active — the streaming commit gate: a swap may only
        commit once every active query is at the CURRENT epoch, keeping
        the double buffer's depth-2 window {e, e+1} sufficient."""
        epochs = [tk.epoch for tk in self.active if tk.epoch is not None]
        return min(epochs) if epochs else None

    # ----------------------------------------------------------- admission
    def submit(self, s: int, t: int, k: int, *,
               arrival: float | None = None,
               variant=None) -> QueryTicket:
        """Enqueue one query; raises :class:`QueueFull` past capacity.

        Capacity counts the free in-flight slots the next tick will
        drain, not just the waiting room — a burst against an idle
        scheduler must not bounce off a small ``max_queue``.

        ``arrival`` back-dates the ticket's arrival clock for queries
        that arrived while a tick was running (``run`` passes the trace
        time); default is the current scheduler clock.  ``variant`` is
        an optional :class:`repro.core.variants.VariantPolicy` carried
        to the query's stepper (None = plain top-k).
        """
        if self.max_queue is not None:
            free = max(0, self.max_in_flight - len(self.active))
            if len(self.queue) >= self.max_queue + free:
                self.stats.rejected += 1
                raise QueueFull(
                    f"admission queue full ({len(self.queue)} waiting, "
                    f"{free} free slots); query ({s}→{t}) rejected"
                )
        ticket = QueryTicket(
            qid=next(self._qid), s=int(s), t=int(t), k=int(k),
            variant=variant,
            arrival=self.clock if arrival is None else float(arrival),
            _t_wall=obs.clock(),
        )
        self.queue.append(ticket)
        self.stats.max_queue_depth = max(self.stats.max_queue_depth,
                                         len(self.queue))
        return ticket

    def _admit(self) -> None:
        if self.freeze_admission:
            return
        while self.queue and len(self.active) < self.max_in_flight:
            self._stamp_clock()  # pipelined: admit at the current instant
            tk = self.queue.popleft()
            tk.admitted_at = self.clock
            tk.epoch = self.cluster.epoch  # the epoch that will answer it
            t_adm = obs.clock()
            obs.span_at("queue_wait", tk._t_wall, t_adm - tk._t_wall,
                        qid=tk.qid)
            tk._stepper = ksp_dg_stepper(
                self.cluster.dtlp, tk.s, tk.t, tk.k,
                max_iterations=self.max_iterations,
                ref_stream=self.ref_stream,
                variant=tk.variant,
            )
            self.stats.admitted += 1
            self._advance(tk, None)  # prime to the first RefineRequest
            obs.span_at("admit", t_adm, obs.clock() - t_adm, qid=tk.qid,
                        s=tk.s, t=tk.t, k=tk.k, epoch=tk.epoch)
            if not tk.done:
                self.active.append(tk)
                if self.pipeline:
                    self._gather(tk)
        self.stats.max_in_flight = max(self.stats.max_in_flight,
                                       len(self.active))

    def _advance(self, tk: QueryTicket, seg_lists) -> None:
        """Feed one round's segment lists into a query's stepper."""
        try:
            if seg_lists is None:
                tk._request = next(tk._stepper)
            else:
                tk._request = tk._stepper.send(seg_lists)
        except StopIteration as fin:
            tk.result, tk.stats = fin.value
            tk.finished_at = self.clock
            tk._stepper = tk._request = None
            self.finished.append(tk)
            self.stats.completed += 1

    # -------------------------------------------------- pipelined serving
    def _stamp_clock(self) -> None:
        """Advance the simulated clock by the wall time elapsed since
        the last stamp — the incremental form of lockstep's one
        clock-add per tick, valid only inside a pipelined tick."""
        if self._mark is None:
            return
        now = obs.clock()
        self.clock += now - self._mark
        self._mark = now

    def _gather(self, tk: QueryTicket) -> None:
        """Route one query round's tasks into worker pipes, joining any
        queued or in-flight batch that already carries a task."""
        req = tk._request
        pair_gids, groups = refine_groups(self.cluster.dtlp, req.pairs,
                                          req.home)
        pending = _Pending(tk, req, pair_gids)
        # the ADMISSION epoch, not the cluster's current one: under
        # streaming updates a swap may commit while this query is in
        # flight, and its later rounds must keep refining against the
        # epoch its stepper snapshotted (workers double-buffer it)
        epoch = tk.epoch
        for gid, items in groups.items():
            for _, a, b in items:
                self.stats.tasks_requested += 1
                self._enqueue_task(pending, epoch, req.k, (gid, a, b))
        if pending.missing == 0:
            # degenerate round with no refine work: splice right away
            self._splice(pending)

    def _enqueue_task(self, pending: _Pending, epoch: int, k: int,
                      task) -> None:
        ikey = (epoch, k, task)
        batch = self._task_index.get(ikey)
        if batch is None:
            worker, reissued = self.cluster.route(task[0])
            if reissued:
                self.cluster.reissues += 1
            pipe = self._pipes.get(worker.wid)
            if pipe is None:
                pipe = self._pipes[worker.wid] = _WorkerPipe(worker.wid)
            batch = pipe.open.get((epoch, k))
            if batch is None:
                batch = _Batch(worker.wid, epoch, k)
                pipe.open[(epoch, k)] = batch
                pipe.backlog.append(batch)
            batch.tasks[task] = None
            self._task_index[ikey] = batch
        # else: cross-query join — the task is already queued or in
        # flight; this query just waits on that batch (counted as dedup
        # via tasks_requested - tasks_dispatched)
        waiting = batch.waiters.get(pending)
        if waiting is None:
            waiting = batch.waiters[pending] = []
            pending.missing += 1
        waiting.append(task)

    def _dispatch_pipe(self, pipe: _WorkerPipe) -> None:
        """Fill this pipe's free dispatch slots from its backlog."""
        while pipe.backlog and len(pipe.inflight) < self.pipeline_depth:
            batch = pipe.backlog.popleft()
            pipe.open.pop((batch.epoch, batch.k), None)
            worker = self.cluster.workers[pipe.wid]
            if not worker.alive:
                # died between gather and dispatch: re-route every task
                # (and its waiters) through the replica placement
                self._requeue(batch)
                continue
            t0 = obs.clock()
            batch.future = worker.execute_async(list(batch.tasks), batch.k,
                                                epoch=batch.epoch)
            busy = obs.clock() - t0
            self.stats.worker_busy_s[pipe.wid] = (
                self.stats.worker_busy_s.get(pipe.wid, 0.0) + busy)
            obs.span_at("dispatch", t0, busy, worker=pipe.wid,
                        epoch=batch.epoch, k=batch.k,
                        tasks=len(batch.tasks))
            batch.t_dispatch = t0
            self.stats.batches_dispatched += 1
            self.stats.tasks_dispatched += len(batch.tasks)
            pipe.inflight.append(batch)

    def _requeue(self, batch: _Batch) -> None:
        for task in batch.tasks:
            ikey = (batch.epoch, batch.k, task)
            if self._task_index.get(ikey) is batch:
                del self._task_index[ikey]
        for pending, tasks in batch.waiters.items():
            pending.missing -= 1
            for task in tasks:
                self._enqueue_task(pending, batch.epoch, batch.k, task)

    def _deliver(self, batch: _Batch, pipe: _WorkerPipe) -> None:
        """Fan one completed batch's results out to its waiting queries;
        any query whose round is now complete splices and advances."""
        results = batch.future.result()
        if batch.t_dispatch is not None:
            service = obs.clock() - batch.t_dispatch
            pipe.solve_ewma = (service if pipe.solve_samples == 0
                               else 0.3 * service + 0.7 * pipe.solve_ewma)
            pipe.solve_samples += 1
        for task in batch.tasks:
            ikey = (batch.epoch, batch.k, task)
            if self._task_index.get(ikey) is batch:
                del self._task_index[ikey]
        for pending, tasks in batch.waiters.items():
            for task in tasks:
                pending.results[task] = results[task]
            pending.missing -= 1
            if pending.missing == 0:
                self._splice(pending)

    def _splice(self, pending: _Pending) -> None:
        """Complete one query round: merge segment lists, advance the
        stepper one KSP-DG iteration at the current clock instant, and
        either finish the query (immediately freeing its slot to the
        admission queue) or gather its next round into the pipes."""
        tk = pending.tk
        req = pending.req
        t0 = obs.clock()
        seg_lists = merge_segments(req.pairs, pending.pair_gids,
                                   pending.results, req.k)
        req.stats.refine_tasks += len(req.pairs)
        tk.ticks += 1
        self._stamp_clock()
        self._advance(tk, seg_lists)
        obs.span_at("splice", t0, obs.clock() - t0, qid=tk.qid,
                    pairs=len(req.pairs), iteration=tk.ticks,
                    done=tk.done)
        if tk.done:
            self.active.remove(tk)
            self._admit()  # a slot freed mid-pump: pull the next query in
        else:
            self._gather(tk)

    def _tick_pipeline(self) -> list[QueryTicket]:
        """One pump round: fill dispatch slots, step every pipe's oldest
        in-flight batch one device round, deliver completions.  Returns
        after ≥ 1 batch delivery (so the replay loop can interleave
        arrivals) or when nothing is in flight."""
        t_begin = obs.clock()
        self._mark = t_begin
        n_fin = len(self.finished)
        self._admit()
        if not self.active:
            # idle (or admission-frozen with nothing in flight): ~free
            self._stamp_clock()
            self._mark = None
            return self.finished[n_fin:]
        self.stats.ticks += 1
        progressed = len(self.finished) > n_fin  # admission may complete
        while not progressed:
            for wid in sorted(self._pipes):
                self._dispatch_pipe(self._pipes[wid])
            inflight_now = sum(len(p.inflight)
                               for p in self._pipes.values())
            self.stats.max_inflight_batches = max(
                self.stats.max_inflight_batches, inflight_now)
            stepped = False
            for wid in sorted(self._pipes):
                pipe = self._pipes[wid]
                if not pipe.inflight:
                    continue
                stepped = True
                batch = pipe.inflight[0]
                t0 = obs.clock()
                done = batch.future.step()
                dt = obs.clock() - t0
                self.stats.worker_busy_s[wid] = (
                    self.stats.worker_busy_s.get(wid, 0.0) + dt)
                obs.span_at("solve", t0, dt, worker=wid,
                            epoch=batch.epoch, k=batch.k,
                            tasks=len(batch.tasks), done=done)
                if done:
                    pipe.inflight.popleft()
                    self._deliver(batch, pipe)
                    progressed = True
            if not stepped:
                break
        now = obs.clock()
        self.stats.working_s += now - t_begin
        dt = now - t_begin
        if self._tick_samples == 0:
            self.tick_latency_ewma = dt
        else:
            self.tick_latency_ewma = 0.3 * dt + 0.7 * self.tick_latency_ewma
        self._tick_samples += 1
        self._stamp_clock()
        self._mark = None
        return self.finished[n_fin:]

    # ---------------------------------------------------------------- tick
    def tick(self) -> list[QueryTicket]:
        """Advance the system one round; returns queries that completed.

        Pipelined mode: one pump round (see :meth:`_tick_pipeline`) with
        completions stamped at their actual in-pump instant.  Lockstep
        mode: the classic global tick — the whole tick, admission
        (stepper priming does the extended-skeleton build and first
        reference-path search) through scatter, is clocked, and
        completions are stamped with the POST-tick clock.
        """
        if self.pipeline:
            return self._tick_pipeline()
        t0 = obs.clock()
        n_fin = len(self.finished)
        self._admit()
        if not self.active:
            self.clock += obs.clock() - t0
            for tk in self.finished[n_fin:]:
                tk.finished_at = self.clock
            return self.finished[n_fin:]
        self.stats.ticks += 1
        # gather: group every active query's pairs, route to workers,
        # de-dup identical (gid, a, b) tasks across queries
        gathered = []  # (ticket, pair_gids)
        # (wid, k, epoch) → {(gid, a, b): None} ordered de-dup: epoch is
        # part of the batch identity so in-flight queries fenced at the
        # previous epoch (streaming handoff) never share a solve — or a
        # cache line — with queries admitted after the swap.  Barrier
        # mode admits every active query at one epoch, so the extra key
        # component changes nothing there.
        merged: dict = {}
        for tk in self.active:
            req = tk._request
            pair_gids, groups = refine_groups(self.cluster.dtlp, req.pairs,
                                              req.home)
            gathered.append((tk, pair_gids))
            for gid, items in groups.items():
                worker, reissued = self.cluster.route(gid)
                if reissued:
                    self.cluster.reissues += len(items)
                tasks = merged.setdefault((worker.wid, req.k, tk.epoch), {})
                for _, a, b in items:
                    self.stats.tasks_requested += 1
                    tasks.setdefault((gid, a, b), None)
        # dispatch: one execute per worker (per distinct k and epoch) —
        # all queries' misses share the same grouped slab solve and
        # cache entries
        results: dict = {}  # (k, epoch) → {(gid, a, b): [(dist, path)]}
        for (wid, k, epoch), tasks in merged.items():
            self.stats.tasks_dispatched += len(tasks)
            self.stats.batches_dispatched += 1
            self.stats.max_inflight_batches = max(
                self.stats.max_inflight_batches, 1)
            tw0 = obs.clock()
            results.setdefault((k, epoch), {}).update(
                self.cluster.workers[wid].execute(list(tasks), k,
                                                  epoch=epoch)
            )
            tw = obs.clock() - tw0
            self.stats.worker_busy_s[wid] = (
                self.stats.worker_busy_s.get(wid, 0.0) + tw)
            obs.span_at("solve", tw0, tw, worker=wid, epoch=epoch, k=k,
                        tasks=len(tasks))
        # scatter: per-query segment lists, one KSP-DG step each
        still_active = []
        for tk, pair_gids in gathered:
            req = tk._request
            ts0 = obs.clock()
            seg_lists = merge_segments(req.pairs, pair_gids,
                                       results.get((req.k, tk.epoch), {}),
                                       req.k)
            req.stats.refine_tasks += len(req.pairs)
            tk.ticks += 1
            self._advance(tk, seg_lists)
            obs.span_at("splice", ts0, obs.clock() - ts0, qid=tk.qid,
                        pairs=len(req.pairs), iteration=tk.ticks,
                        done=tk.done)
            if not tk.done:
                still_active.append(tk)
        self.active = still_active
        dt = obs.clock() - t0
        self.clock += dt
        self.stats.working_s += dt
        # EWMA over WORKING ticks only — idle ticks are ~free and would
        # wash the queue-delay predictor toward zero
        if self._tick_samples == 0:
            self.tick_latency_ewma = dt
        else:
            self.tick_latency_ewma = 0.3 * dt + 0.7 * self.tick_latency_ewma
        self._tick_samples += 1
        completed = self.finished[n_fin:]
        for tk in completed:
            tk.finished_at = self.clock
        return completed

    def drain(self) -> list[QueryTicket]:
        """Tick until queue and in-flight set are empty; all finished."""
        while self.queue or self.active:
            self.tick()
        return self.finished

    # ----------------------------------------------------------- workloads
    def run(self, queries, k: int, *, arrival_times=None,
            batch_window: float = 0.0, reject_overflow: bool = False):
        """Serve a trace of ``(s, t)`` queries; returns their tickets.

        ``arrival_times`` gives each query's arrival on the scheduler
        clock (seconds, ascending); ``None`` means all arrive at once.
        The clock advances by each tick's measured wall time, so a query
        that arrives while earlier ticks run accrues queueing latency.
        When the scheduler is under-occupied and the next arrival is
        within ``batch_window`` seconds, it waits (advances the clock) to
        group arrivals into the same admission burst — the classic
        latency-for-throughput batching knob.  ``reject_overflow`` makes
        a full bounded queue drop queries (counted in ``stats.rejected``)
        instead of raising.
        """
        queries = list(queries)
        if arrival_times is None:
            arrivals = [self.clock] * len(queries)
        else:
            arrivals = [float(a) for a in arrival_times]
            if len(arrivals) != len(queries):
                raise ValueError("arrival_times length != queries length")
        tickets: list[QueryTicket] = []

        def submit_at(i, arrival):
            s, t = queries[i]
            try:
                # arrival back-dated to trace time: a query that landed
                # mid-tick accrues the queueing delay it actually saw
                tickets.append(self.submit(s, t, k, arrival=arrival))
            except QueueFull:
                if not reject_overflow:
                    raise
        drive_trace(self, arrivals, submit_at, self.tick,
                    window=batch_window)
        return tickets
