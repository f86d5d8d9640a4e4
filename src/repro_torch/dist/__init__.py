"""repro.dist — the distributed KSP-DG runtime.

Layering (host → device):

* ``placement``    — LPT primary/replica placement of subgraphs on workers
* ``cluster``      — in-process worker cluster: exact queries via
  ``core.kspdg.ksp_dg`` + owner-aligned refine dispatch, fault handling,
  weight maintenance, rescale, checkpoint/restore
* ``grouped_yen``  — lockstep Yen over the [S, J, z] grouped BF batch
* ``scheduler``    — cross-query batched serving: concurrent queries run
  as lockstep steppers whose refine tasks are merged (de-duped) into
  shared per-worker grouped solves, behind a bounded admission queue
* ``shard_refine`` — jax.shard_map production refine/update/allreduce

``shard_refine`` (and the dense worker path) import jax; the placement
module is numpy-only, so control-plane users can stay device-free.

This package is the runtime UNDER the public serving API: entry points
construct a ``repro.service.KSPService`` (typed requests, epoch-stamped
results, SLO admission) rather than calling ``Cluster.query`` or
``QueryScheduler.submit`` directly.  Refine engines are named
``repro.engine.registry.EngineSpec``s — no engine string-switches live
here anymore.
"""

from .placement import Placement, place, subgraph_loads  # noqa: F401
