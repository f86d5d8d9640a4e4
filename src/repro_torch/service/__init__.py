"""repro.service — the one typed serving API.

Public surface of the serving stack: :class:`KSPService` (submit/poll/
drain over the pipelined cross-query scheduler, epoch-versioned queries
and updates, SLO admission), the request/response dataclasses — four
query variants, one scheduler path (see ``docs/workloads.md``) — and
the :class:`~repro.engine.registry.EngineSpec` registry for pluggable
refine engines, each spec carrying a
:class:`~repro.engine.backend.SolverBackend` (jnp or Pallas) whose
:class:`~repro.engine.layout.SlabLayout` owns all slab geometry.
Everything underneath — ``dist.cluster.Cluster.query``,
``dist.scheduler.QueryScheduler`` — is an internal.

    from repro_torch.service import KSPService, QueryRequest, ServiceConfig

    svc = KSPService.build(graph, ServiceConfig(engine="dense_bf",
                                                n_workers=8))
    res = svc.query(s, t, k=3)       # res.paths, res.epoch, res.stats

Variant requests go through the same ``submit``/``query`` door:

    from repro_torch.service import (BoundedKSPRequest, DiverseKSPRequest,
                               OneToManyRequest)

    svc.submit(DiverseKSPRequest(s, t, k=3, min_dist=0.4))
    svc.submit(BoundedKSPRequest(s, t, k=16, stretch=1.3))
    svc.submit(OneToManyRequest(s, targets=(a, b, c), k=2))
"""

from repro_torch.engine.backend import (  # noqa: F401
    CudaBackend,
    SolverBackend,
    TorchBackend,
)
from repro_torch.core.refstream import (  # noqa: F401
    ReferenceStreamSpec,
    available_ref_streams,
    get_ref_stream,
    register_ref_stream,
)
from repro_torch.engine.layout import SlabLayout  # noqa: F401
from repro_torch.engine.registry import (  # noqa: F401
    EngineSpec,
    available_engines,
    get_engine,
    register_engine,
)

from .service import KSPService  # noqa: F401
from .types import (  # noqa: F401
    VARIANTS,
    AdmissionError,
    BoundedKSPRequest,
    DeadlineExceeded,
    DiverseKSPRequest,
    EpochUnsatisfiable,
    OneToManyRequest,
    QueryRequest,
    QueryResult,
    QueueRejected,
    ServiceConfig,
    ServiceStats,
    ServiceTicket,
    UpdateBatch,
)

__all__ = [
    "KSPService",
    "VARIANTS",
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
    "EngineSpec",
    "register_engine",
    "get_engine",
    "available_engines",
    "ReferenceStreamSpec",
    "register_ref_stream",
    "get_ref_stream",
    "available_ref_streams",
    "SolverBackend",
    "TorchBackend",
    "CudaBackend",
    "SlabLayout",
]
