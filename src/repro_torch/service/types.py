"""Typed request/response surface of the KSP serving API.

One vocabulary for everything that crosses the service boundary: a
:class:`QueryRequest` in, a :class:`QueryResult` (with the epoch that
answered it) out, an :class:`UpdateBatch` for the Δw stream, and a
:class:`ServiceConfig` that replaces the per-entry-point argv/kwarg
plumbing that used to be copied between ``launch/serve.py``, the
examples and the benchmarks.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

__all__ = [
    "QueryRequest",
    "DiverseKSPRequest",
    "BoundedKSPRequest",
    "OneToManyRequest",
    "QueryResult",
    "UpdateBatch",
    "ServiceConfig",
    "ServiceStats",
    "ServiceTicket",
    "AdmissionError",
    "DeadlineExceeded",
    "QueueRejected",
    "EpochUnsatisfiable",
]

#: the request kinds KSPService serves; every one flows through the same
#: scheduler/grouped-solve path (see docs/workloads.md)
VARIANTS = ("ksp", "diverse", "bounded", "one_to_many")


class AdmissionError(RuntimeError):
    """A query was rejected at admission; ``reason`` says why."""

    reason = "rejected"


class DeadlineExceeded(AdmissionError):
    """Predicted queue delay exceeds the request's ``deadline_ms``."""

    reason = "deadline"


class QueueRejected(AdmissionError):
    """The bounded admission queue is full."""

    reason = "queue_full"


class EpochUnsatisfiable(AdmissionError):
    """``min_epoch`` is beyond the current epoch plus every queued
    update batch — no scheduled future can satisfy the request."""

    reason = "epoch"


@dataclasses.dataclass(frozen=True)
class QueryRequest:
    """One KSP query: k shortest s→t paths (or a variant of the shape).

    ``deadline_ms`` opts into SLO admission: the service rejects
    (:class:`DeadlineExceeded`) when the predicted queue delay — tick
    latency EWMA × queue depth — already exceeds it, instead of
    accepting work it cannot serve in time.  ``min_epoch`` demands
    freshness: the query holds until the graph epoch reaches it (or is
    rejected outright when no queued update can get there).

    ``variant`` selects the workload — ``"ksp"`` (plain top-k, the
    default), ``"diverse"`` (k mutually dissimilar paths; tuned by
    ``min_dist``/``cost_add``/``pool``), ``"bounded"`` (every path
    within ``stretch`` × the shortest, budget-guarded by ``k``), or
    ``"one_to_many"`` (one source, the ``targets`` set; ``t`` is
    unused).  The typed subclasses below pin the variant and its
    defaults; construct whichever reads best:

        >>> QueryRequest(0, 9, k=4).variant
        'ksp'
        >>> BoundedKSPRequest(0, 9, stretch=1.5).variant
        'bounded'
        >>> OneToManyRequest(0, targets=(3, 7, 9)).targets
        (3, 7, 9)
    """

    s: int
    t: int
    k: int = 3
    deadline_ms: float | None = None
    min_epoch: int | None = None
    variant: str = "ksp"
    # bounded: answer = all paths with d ≤ stretch × d₀ (≥ 1)
    stretch: float | None = None
    # diverse: required pairwise dissimilarity (edge-overlap ≤ 1−min_dist),
    # optional detour cost cap (1+cost_add)×d₀, candidate-pool override
    min_dist: float | None = None
    cost_add: float | None = None
    pool: int | None = None
    # one_to_many: the target set (``t`` is ignored for this variant)
    targets: tuple | None = None

    def __post_init__(self):
        if self.k < 1:
            raise ValueError(f"k must be ≥ 1, got {self.k}")
        if self.deadline_ms is not None and self.deadline_ms <= 0:
            raise ValueError("deadline_ms must be positive")
        if self.variant not in VARIANTS:
            raise ValueError(
                f"unknown variant {self.variant!r}; one of {VARIANTS}"
            )
        if self.stretch is not None:
            if self.variant != "bounded":
                raise ValueError("stretch is a bounded-variant field")
            if self.stretch < 1.0:
                raise ValueError(f"stretch must be ≥ 1, got {self.stretch}")
        for name in ("min_dist", "cost_add", "pool"):
            if getattr(self, name) is not None and self.variant != "diverse":
                raise ValueError(f"{name} is a diverse-variant field")
        if self.min_dist is not None and not 0.0 < self.min_dist <= 1.0:
            raise ValueError(f"min_dist must be in (0, 1], got {self.min_dist}")
        if self.cost_add is not None and self.cost_add < 0:
            raise ValueError(f"cost_add must be ≥ 0, got {self.cost_add}")
        if self.pool is not None and self.pool < 1:
            raise ValueError(f"pool must be ≥ 1, got {self.pool}")
        if self.variant == "one_to_many":
            if not self.targets:
                raise ValueError("one_to_many requires a non-empty targets")
            object.__setattr__(
                self, "targets", tuple(int(t) for t in self.targets))
        elif self.targets is not None:
            raise ValueError("targets is a one_to_many-variant field")


@dataclasses.dataclass(frozen=True)
class DiverseKSPRequest(QueryRequest):
    """k mutually dissimilar s→t paths (``variant="diverse"`` pinned).

    ``min_dist`` is the required pairwise dissimilarity: any two
    returned paths share at most ``1 − min_dist`` of their edges
    (fraction of the shorter path).  ``cost_add`` optionally caps the
    detour: no returned path costs more than ``(1 + cost_add) × d₀``.
    """

    variant: str = "diverse"
    min_dist: float = 0.3


@dataclasses.dataclass(frozen=True)
class BoundedKSPRequest(QueryRequest):
    """Every s→t path within ``stretch`` × the shortest distance
    (``variant="bounded"`` pinned); ``k`` bounds the answer size —
    ``QueryResult.stats.bound_clipped`` reports when it bit."""

    variant: str = "bounded"
    stretch: float = 1.2


@dataclasses.dataclass(frozen=True)
class OneToManyRequest(QueryRequest):
    """k shortest paths from one source to EACH of ``targets``
    (``variant="one_to_many"`` pinned; ``t`` is unused).

    The service fans the request into per-target sub-queries that run
    concurrently through the shared scheduler — their refine tasks
    de-duplicate into the same grouped solves, and on undirected graphs
    every sub-query is oriented target→source so all of them hit ONE
    reverse-SPT ``ref_tree_cache`` entry.  The result's ``by_target``
    holds one path list per target, in request order; ``paths`` is the
    merged weight-ascending view.
    """

    t: int = -1
    variant: str = "one_to_many"


@dataclasses.dataclass(frozen=True)
class QueryResult:
    """The answer plus its provenance.

    ``paths`` is the exact [(dist, vertex-tuple)] list, ascending, length
    ≤ k.  ``epoch`` is the graph epoch the query was admitted — and,
    thanks to the update barrier, answered — under; a caller comparing
    answers across replicas or time uses it to know which weight state
    it is looking at.  ``stats`` is the core ``QueryStats`` (iterations,
    refine tasks, cache hits, truncation).
    """

    qid: int
    paths: tuple
    epoch: int
    stats: Any
    latency_ms: float
    # one_to_many only: one ``((dist, path), ...)`` tuple per requested
    # target, in request order; None for the point-to-point variants.
    # ``paths`` then holds the merged weight-ascending view and ``stats``
    # the per-sub-query aggregate (epoch = oldest sub-query's epoch,
    # latency = the slowest sub-query's)
    by_target: Any = None

    @property
    def truncated(self) -> bool:
        return bool(self.stats.truncated)

    @property
    def bound_clipped(self) -> bool:
        """Bounded variant: the stretch window held more paths than k."""
        return bool(getattr(self.stats, "bound_clipped", False))


@dataclasses.dataclass(frozen=True)
class UpdateBatch:
    """One Δw batch: ``new_w[i]`` becomes the weight of edge ``eids[i]``.

    Duplicate eids within a batch collapse last-write-wins at
    construction — the batch means "these edges END UP at these
    weights", and downstream incremental maintenance computes per-edge
    deltas against pre-batch weights, which a repeated eid would
    double-count.

    Application is an epoch boundary either way the service runs it:
    in ``update_mode="barrier"`` the service orders the batch after
    every in-flight query (they answer at the pre-update epoch) and
    before every query admitted afterwards (stamped with the new
    epoch); in ``"streaming"`` mode the same ordering holds per query
    via epoch fencing, without draining — in-flight queries finish
    against the retained previous-epoch buffers.
    """

    eids: np.ndarray
    new_w: np.ndarray

    def __post_init__(self):
        eids = np.asarray(self.eids, dtype=np.int64)
        new_w = np.asarray(self.new_w, dtype=np.float64)
        if eids.shape != new_w.shape:
            raise ValueError(
                f"eids {eids.shape} and new_w {new_w.shape} "
                "must have identical shapes"
            )
        from repro_torch.core.graph import dedupe_updates

        eids, new_w = dedupe_updates(eids, new_w)
        object.__setattr__(self, "eids", eids)
        object.__setattr__(self, "new_w", new_w)

    def __len__(self) -> int:
        return int(self.eids.shape[0])


@dataclasses.dataclass
class ServiceConfig:
    """Everything needed to stand up a :class:`~repro_torch.service.KSPService`.

    ``engine`` names an :class:`repro_torch.engine.registry.EngineSpec`;
    ``z``/``xi`` are DTLP build knobs (used by ``KSPService.build``);
    the rest configures the cluster and scheduler underneath.
    ``device`` is where slab engines keep their slabs and run their
    solves: the card by default, the CPU only when asked (``"cpu"``).
    Building a service for ``"cuda"`` on a host without a card raises;
    nothing falls back.  A device mesh (``mesh``) is not ported yet:
    setting one raises when the service is built.
    """

    engine: str = "pyen"
    device: str = "cuda"
    n_workers: int = 4
    max_in_flight: int = 8
    max_queue: int | None = None
    batch_window_ms: float = 0.0
    max_iterations: int = 10_000
    z: int = 24
    xi: int = 6
    mesh: Any = None
    mesh_axis: Any = ("data", "model")
    # 8x the fleet-median cost-normalized latency: loose enough that
    # jit-compile transients never bench a healthy worker, tight enough
    # to catch a genuinely overloaded one (10x+ in the paper's setting)
    straggler_factor: float | None = 8.0
    straggler_min_tasks: int = 8
    # drift-triggered DTLP rebaseline at the update barrier, ON by
    # default: past ~0.3 mean |w/w⁰−1| the skeleton bounds are loose
    # enough that the extra KSP-DG iterations per query cost more than an
    # occasional index rebuild (ROADMAP "Tail latency after drift" —
    # post-update queries ran 10-100x slower before this fired anywhere
    # but launch/serve).  0 disables.
    rebaseline_drift: float = 0.3
    # reference-path stream for KSP-DG's filter phase: a
    # ``repro.core.refstream`` name ("lazy" / "yen"); None inherits the
    # engine spec's default ("lazy" for all builtin engines)
    ref_stream: str | None = None
    # per-worker asynchronous pipelines (the serving default): device
    # solves overlap host splicing and finished queries resolve
    # immediately; False reverts to the global lockstep tick (the
    # reference schedule — answers are byte-identical either way)
    pipeline: bool = True
    # dispatched-but-unforced batches each worker pipe may hold (2 =
    # double-buffered: one solving on device, one filling on host)
    pipeline_depth: int = 2
    # consecutive DeadlineExceeded rejections (no successful admission
    # between them) that trigger one flight-recorder dump — the
    # "rejection storm" post-mortem signal; 0 disables
    reject_storm: int = 50
    # where flight-recorder dumps are written (JSON); None keeps them
    # in-memory only (KSPService.flight_dumps)
    flight_dump_path: str | None = None
    # how UpdateBatches land: "barrier" (the reference) freezes
    # admission and drains every in-flight query before applying;
    # "streaming" prepares the next epoch (incremental index deltas +
    # shadow slabs) while serving continues, commits with a pointer
    # swap once every in-flight query is at the current epoch, and
    # coalesces queued batches last-write-wins per edge so the prep
    # pipeline never falls behind the feed
    update_mode: str = "barrier"

    def __post_init__(self):
        import torch

        from repro_torch.core.refstream import get_ref_stream
        from repro_torch.engine.registry import get_engine

        get_engine(self.engine)  # fail fast on unknown engines
        torch.device(self.device)  # ... and unparsable device strings
        if self.ref_stream is not None:
            get_ref_stream(self.ref_stream)  # ... and unknown streams
        if self.n_workers < 1:
            raise ValueError("n_workers must be ≥ 1")
        if self.max_in_flight < 1:
            raise ValueError("max_in_flight must be ≥ 1")
        if self.pipeline_depth < 1:
            raise ValueError("pipeline_depth must be ≥ 1")
        if self.update_mode not in ("barrier", "streaming"):
            raise ValueError(
                f"update_mode must be 'barrier' or 'streaming', "
                f"got {self.update_mode!r}"
            )


@dataclasses.dataclass
class ServiceStats:
    """Service-level counters (admission, epoch barriers, rejections)."""

    submitted: int = 0
    completed: int = 0
    rejected_deadline: int = 0  # SLO admission: predicted delay > deadline
    rejected_queue: int = 0  # bounded admission queue overflow
    rejected_epoch: int = 0  # min_epoch no scheduled update can reach
    held_for_epoch: int = 0  # queries that waited for an update barrier
    update_batches: int = 0  # UpdateBatches applied (epoch bumps)
    barrier_ticks: int = 0  # ticks spent draining in-flight ahead of one
    rebaselines: int = 0  # drift-triggered DTLP rebaselines
    coalesced_batches: int = 0  # queued batches merged into one commit
    handoff_waits: int = 0  # streaming commits deferred: older epoch in flight
    flight_dumps: int = 0  # post-mortem flight-recorder dumps taken

    @property
    def rejected(self) -> int:
        return (self.rejected_deadline + self.rejected_queue
                + self.rejected_epoch)


@dataclasses.dataclass
class ServiceTicket:
    """One submitted query's handle through submit/poll/drain.

    ``rejected`` carries the admission-failure reason when the query
    never entered the scheduler (replay-style submission); otherwise the
    ticket resolves to a :class:`QueryResult` once served.
    """

    qid: int
    request: QueryRequest
    arrival: float = 0.0
    rejected: str | None = None
    result: QueryResult | None = None
    _ticket: Any = dataclasses.field(default=None, repr=False)  # scheduler's

    @property
    def done(self) -> bool:
        return self.result is not None or self.rejected is not None
