"""EngineSpec registry: the pluggable refine-engine surface.

An :class:`EngineSpec` packages everything a ``dist.cluster.Worker``
needs to run one engine — whether it packs a dense slab, the
:class:`~repro_torch.engine.backend.SolverBackend` that executes (and
whose :class:`~repro_torch.engine.layout.SlabLayout` owns all slab
geometry) and how to solve a batch of cache-miss refine tasks — and the
registry maps names to specs.
``repro_torch.service`` re-exports this module as the public way to plug
in an engine; the builtin specs are
``pyen`` (host Yen), ``dense_bf`` (plain PyTorch grouped BF) and
``cuda_bf`` (the fused Hopper kernel).

A spec's ``refine(worker, misses, k, epoch)`` receives the worker (slab,
row_of, dtlp access), the cache-miss task list ``[(gid, a, b)]`` with
global vertex ids, and the serving epoch, and returns ``{(gid, a, b):
[(dist, global-path)]}`` for exactly those tasks — epoch checks and
cache fills stay in ``Worker.execute``, so an engine can never serve
stale weights by accident.  Under streaming updates a worker
double-buffers the previous epoch's slab/weights across one commit
(``Worker.slab_for`` / ``Worker.weights_for``), so an engine must read
THOSE accessors rather than ``worker.slab`` / ``dtlp.graph.w``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.dist.shard_refine import mesh_axis_names  # noqa: F401

from .backend import CudaBackend, SolverBackend, TorchBackend
from .layout import PLAIN_LAYOUT, SlabLayout

__all__ = [
    "EngineSpec",
    "register_engine",
    "get_engine",
    "available_engines",
]


@dataclasses.dataclass(frozen=True)
class EngineSpec:
    """Everything the worker runtime needs to run one refine engine.

    ``refine(worker, misses, k, epoch) -> {(gid, a, b): [(d, path)]}``
    solves a batch of partial-KSP tasks against the weights of
    ``epoch``; ``packs_slab`` makes each worker pack its owned subgraphs
    into a dense ``[S, z, z]`` slab at init, with all geometry coming
    from ``backend.layout``; an engine with a ``backend`` also runs on
    a device mesh (``Cluster`` wires ``shard_refine.make_refine_fn``).
    """

    name: str
    refine: Callable
    # generator form of ``refine``: same signature, but yields once per
    # device round with that round's solve dispatched-but-unforced, and
    # returns the result dict as its StopIteration value.  The pipelined
    # scheduler steps these generators round-robin so one worker's device
    # solve overlaps another's host splicing; None = host-only engine.
    refine_async: Callable | None = None
    packs_slab: bool = False
    backend: SolverBackend | None = None
    # reference-path stream KSP-DG's filter phase consumes when this
    # engine serves a query (``repro_torch.core.refstream`` name)
    ref_stream: str = "lazy"
    description: str = ""

    @property
    def layout(self) -> SlabLayout:
        """The slab geometry this engine's workers pack and solve in."""
        return self.backend.layout if self.backend is not None else PLAIN_LAYOUT

    @property
    def supports_mesh(self) -> bool:
        """Whether the engine runs on a device mesh: every engine with
        a slab backend does, one ``solve_grouped`` per shard."""
        return self.backend is not None


_REGISTRY: dict[str, EngineSpec] = {}


def register_engine(spec: EngineSpec, *, overwrite: bool = False) -> EngineSpec:
    """Register ``spec`` under ``spec.name``; returns it for chaining."""
    from repro_torch.core.refstream import get_ref_stream

    if not overwrite and spec.name in _REGISTRY:
        raise ValueError(f"engine {spec.name!r} is already registered")
    get_ref_stream(spec.ref_stream)  # fail fast on unknown streams
    _REGISTRY[spec.name] = spec
    return spec


def get_engine(name) -> EngineSpec:
    """Resolve an engine name (or pass an :class:`EngineSpec` through).

    >>> get_engine("cuda_bf").backend.name
    'cuda'
    >>> get_engine("dense_bf").supports_mesh
    True
    """
    if isinstance(name, EngineSpec):
        return name
    spec = _REGISTRY.get(name)
    if spec is None:
        raise ValueError(
            f"unknown engine {name!r}; available: {available_engines()}"
        )
    return spec


def available_engines() -> list[str]:
    """Sorted names of every registered engine.

    >>> set(available_engines()) >= {"pyen", "dense_bf", "cuda_bf"}
    True
    """
    return sorted(_REGISTRY)


# ---------------------------------------------------------------------------
# builtin engines
# ---------------------------------------------------------------------------
def _pyen_refine(worker, misses, k, epoch):
    """Host Yen per pair on the epoch's subgraph view (QueryBolt-side)."""
    from repro_torch.core.sssp import subgraph_view
    from repro_torch.core.yen import ksp

    dtlp = worker.dtlp
    w = worker.weights_for(epoch)
    out = {}
    for gid, a, b in misses:
        sg = dtlp.partition.subgraphs[gid]
        view = subgraph_view(sg, w)
        local = ksp(
            view, sg.g2l[a], sg.g2l[b], k,
            mode="pyen", directed=dtlp.graph.directed,
        )
        out[(gid, a, b)] = [
            (d, tuple(int(sg.vertices[v]) for v in p)) for d, p in local
        ]
    return out


def _grouped_refine_async(worker, misses, k, epoch):
    """Generator form of :func:`_grouped_refine`: all misses through ONE
    grouped [S, J, z] lockstep-Yen slab solve, yielding once per device
    round with the round dispatched but not yet copied back (the
    pipelined scheduler interleaves other workers' host work into those
    gaps).  Returns the ``{(gid, a, b): [(d, path)]}`` dict.

    The slab is looked up BY EPOCH, never as ``worker.slab``: the body
    only runs at the first ``next()``, which under the pipelined
    scheduler may land after a streaming swap commits — by then
    ``worker.slab`` already holds the next epoch's weights and this
    batch's epoch lives in ``worker.prev_slab``."""
    from repro_torch.dist.grouped_yen import grouped_ksp_async
    from repro_torch.engine.dense import gather_slab_rows

    dtlp = worker.dtlp
    slab = worker.slab_for(epoch)
    gk_tasks = []
    for gid, a, b in misses:
        sg = dtlp.partition.subgraphs[gid]
        gk_tasks.append((worker.row_of[gid], sg.g2l[a], sg.g2l[b]))
    worker.stats.batches += 1
    # device-resident slab: per-round adjacency comes from an on-device
    # row gather against the resident copy instead of a host re-pack
    # and transfer (the steady-state query path never re-stages the slab)
    results = yield from grouped_ksp_async(
        slab.adj, gk_tasks, k,
        solver=worker.solver, s_multiple=worker.s_multiple,
        backend=worker.spec.backend, device=slab.adj_dev.device,
        gather=lambda rows: gather_slab_rows(slab, rows),
    )
    out = {}
    for (gid, a, b), local in zip(misses, results):
        sg = dtlp.partition.subgraphs[gid]
        out[(gid, a, b)] = [
            (float(d), tuple(int(sg.vertices[v]) for v in p))
            for d, p in local
        ]
    return out


def _grouped_refine(worker, misses, k, epoch):
    """Synchronous driver over :func:`_grouped_refine_async`, executed by
    the spec's :class:`SolverBackend` — or by the worker's mesh solver
    when one is wired."""
    gen = _grouped_refine_async(worker, misses, k, epoch)
    while True:
        try:
            next(gen)
        except StopIteration as fin:
            return fin.value


register_engine(EngineSpec(
    name="pyen",
    refine=_pyen_refine,
    packs_slab=False,
    description="host core.yen per pair through the shared PartialKSPCache",
))

register_engine(EngineSpec(
    name="dense_bf",
    refine=_grouped_refine,
    refine_async=_grouped_refine_async,
    packs_slab=True,
    backend=TorchBackend(),
    description="plain PyTorch grouped [S, J, z] Bellman–Ford over "
                "per-worker slabs",
))

register_engine(EngineSpec(
    name="cuda_bf",
    refine=_grouped_refine,
    refine_async=_grouped_refine_async,
    packs_slab=True,
    backend=CudaBackend(),
    description="fused Hopper bf_solve_grouped kernel over 32-lane slabs "
                "(one launch per shard on a mesh; the kernels' plain "
                "PyTorch versions on CPU tensors)",
))
