"""repro_torch.dist — the distributed KSP-DG runtime.

Layering (host → device):

* ``placement``    — LPT primary/replica placement of subgraphs on workers
* ``cluster``      — in-process worker cluster: exact queries via
  ``core.kspdg.ksp_dg`` + owner-aligned refine dispatch, fault handling,
  weight maintenance, rescale, checkpoint/restore
* ``grouped_yen``  — lockstep Yen over the [S, J, z] grouped BF batch
* ``scheduler``    — cross-query batched serving: concurrent queries run
  as resumable steppers whose refine tasks are merged (de-duped) into
  shared per-worker pipelined solves, behind a bounded admission queue
* ``shard_refine`` — the multi-device refine/update/allreduce over a
  ``repro_torch.launch.mesh.DeviceMesh`` (``torch.distributed`` across
  processes)

``shard_refine`` and the slab worker path use torch; the placement
module is numpy-only, so control-plane users can stay device-free.

This package is the runtime UNDER the public serving API: entry points
construct a ``repro_torch.service.KSPService`` (typed requests, epoch-stamped
results, SLO admission) rather than calling ``Cluster.query`` or
``QueryScheduler.submit`` directly.  Refine engines are named
``repro_torch.engine.registry.EngineSpec``s — no engine string-switches live
here anymore.
"""

from .placement import Placement, place, subgraph_loads  # noqa: F401
