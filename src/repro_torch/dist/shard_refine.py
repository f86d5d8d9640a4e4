"""Multi-device production paths over a device mesh.

Three factories, each returning a function whose per-shard body runs on
the shard's own block of the owner-aligned [S, ...] slab layout (the
mesh is a :class:`repro_torch.launch.mesh.DeviceMesh`: this process's
devices, one per shard, and optionally a ``torch.distributed`` group of
processes that each hold as many):

* ``make_refine_fn``    — grouped masked BF refine (solve + parents),
  subgraph rows split over the mesh's shards.  Each shard runs its own
  row block through its backend's ``solve_grouped`` (problems are
  co-located with their subgraph's slab row, and every [s, j] problem
  converges on its own), so the mesh solve is byte-identical to the
  single-device backends and needs no collective but the final gather;
* ``make_update_fn``    — scatter of edge-weight updates into the
  sharded [S, z, z] adjacency copy (padding rows marked -1 ignored);
* ``make_allreduce_fn`` — int8-quantized compressed all-reduce with an
  error-feedback residual (the gradient/statistics sync path).

Semantics are mesh-shape independent: a one-shard mesh reproduces the
single-device engine bit for bit, and more shards, on one device or
many, in one process or several, keep the same per-shard program.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch import obs
from repro_torch.engine.dense import ShardedMirror


def mesh_axis_names(axis) -> list:
    """Normalize a mesh-axis spec (one name or a sequence) to a list.

    >>> mesh_axis_names("data")
    ['data']
    >>> mesh_axis_names(("data", "model"))
    ['data', 'model']
    """
    return [axis] if isinstance(axis, str) else list(axis)


def shard_count(mesh, axis) -> int:
    """Shards across ``axis`` (a name or tuple of names); they must be
    every shard of the mesh, since each holds one block of S.  The
    bucket's ``s_multiple`` on this mesh."""
    n = math.prod(int(mesh.shape[a]) for a in mesh_axis_names(axis))
    if n != mesh.size:
        raise ValueError(f"axis {axis!r} spans {n} of the mesh's "
                         f"{mesh.size} shards; the slab rows are split "
                         "over every shard")
    return n


def describe_mesh(mesh, axis) -> str:
    """The ``mesh=`` label of spans: the shard counts along ``axis``,
    joined by "x" (``"2x1"``)."""
    return "x".join(str(int(mesh.shape[a])) for a in mesh_axis_names(axis))


def _comm_device(mesh) -> torch.device:
    """Where a collective's tensors live: the card for NCCL, else the
    CPU (gloo)."""
    import torch.distributed as dist

    if dist.get_backend(mesh.group) == "nccl":
        return mesh.devices[0]
    return torch.device("cpu")


def make_refine_fn(mesh, axis=("data", "model"), backend=None):
    """(adj [S,z,z], dist0 [S,J,z], bv, so, bn [S,J,z], cap [S,J]) →
    (dist [S,J,z], parent [S,J,z]) with S split over the mesh's shards.

    ``backend`` (a :class:`repro_torch.engine.backend.SolverBackend`;
    default the plain PyTorch one) solves each shard's row block with
    its own ``solve_grouped``: every [s, j] problem converges on its own,
    so a shard needs nothing from the others, and the result is
    byte-identical to the single-device solve of the same backend.
    Apart from the gather across processes it reads nothing back to the
    host, so it keeps ``solve_grouped``'s async contract.

    S must be a multiple of the shard count (``pack_round``'s
    ``s_multiple``).  Shard g of ``size`` takes rows [g·S/size,
    (g+1)·S/size) to its device; this process runs only its own shards,
    and with a process group the blocks are gathered from every process.
    The result lands on ``dist0``'s device.  Each call records one
    ``solve_grouped`` span with the ``mesh=`` label around the shards'
    own spans.
    """
    if backend is None:
        from repro_torch.engine.backend import TorchBackend

        backend = TorchBackend()
    n_shards = shard_count(mesh, axis)
    desc = describe_mesh(mesh, axis)

    def refine(adj, dist0, bv, so, bn, cap):
        S, J, z = dist0.shape
        if S % n_shards:
            raise ValueError(f"S={S} is not a multiple of the mesh's "
                             f"{n_shards} shards")
        t0 = obs.clock()
        rows = S // n_shards
        home = dist0.device
        blocks = []
        for i, dev in enumerate(mesh.devices):
            g = mesh.first_shard + i
            blocks.append(backend.solve_grouped(
                *(t[g * rows:(g + 1) * rows].to(dev)
                  for t in (adj, dist0, bv, so, bn, cap))))
        dist_out = torch.cat([d.to(home) for d, _ in blocks])
        parent = torch.cat([p.to(home) for _, p in blocks])
        if mesh.group is not None:
            dist_out, parent = _gather(mesh, dist_out), _gather(mesh, parent)
        obs.span_at("solve_grouped", t0, obs.clock() - t0,
                    backend=backend.name, S=S, J=J, z=z, mesh=desc)
        return dist_out, parent

    return refine


def _gather(mesh, local: torch.Tensor) -> torch.Tensor:
    """Concatenate every process's blocks, in process order, on
    ``local``'s device."""
    import torch.distributed as dist

    comm = _comm_device(mesh)
    parts = [torch.empty_like(local, device=comm)
             for _ in range(mesh.n_processes)]
    dist.all_gather(parts, local.to(comm), group=mesh.group)
    return torch.cat(parts).to(local.device)


def make_update_fn(mesh, axis=("data", "model")):
    """Scatter a weight-update batch into the sharded adjacency copy.

    Returns ``update(adj, slab_idx, uu, vv, ww) -> adj'`` where
    ``slab_idx[i]`` is the GLOBAL slab row of update i (-1 marks a
    padding entry and is ignored), ``uu/vv`` local vertex ids and ``ww``
    the new float32 weight.  ``adj`` is a
    :class:`~repro_torch.engine.dense.ShardedMirror` (each part applies
    only the rows it holds — a scatter, not an all-to-all) or one tensor;
    the result is a new copy of the same kind, and ``adj`` is never
    written.

    Contract: ``ww[i]`` must be the EFFECTIVE slab value for cell
    (slab_idx, uu, vv) — i.e. the min over parallel edges between the
    pair, as ``dist.cluster.Worker._min_weight`` computes host-side —
    and a batch must not carry duplicate cells (which write wins is
    unspecified).  The host dispatch owns both.
    """
    shard_count(mesh, axis)

    def update(adj, slab_idx, uu, vv, ww):
        sharded = isinstance(adj, ShardedMirror)
        parts = adj.parts if sharded else (adj,)
        rows = int(parts[0].shape[0])
        idx = np.asarray(slab_idx, dtype=np.int64)
        uu = np.asarray(uu, dtype=np.int64)
        vv = np.asarray(vv, dtype=np.int64)
        ww = np.asarray(ww, dtype=np.float32)
        out = []
        for i, part in enumerate(parts):
            local = idx - i * rows
            keep = (idx >= 0) & (local >= 0) & (local < rows)
            if not keep.any():
                out.append(part)  # unchanged: shared with ``adj``
                continue
            dev = part.device
            new = part.clone()
            new[torch.from_numpy(local[keep]).to(dev),
                torch.from_numpy(uu[keep]).to(dev),
                torch.from_numpy(vv[keep]).to(dev)] = \
                torch.from_numpy(ww[keep]).to(dev)
            out.append(new)
        return ShardedMirror(tuple(out)) if sharded else out[0]

    return update


def make_allreduce_fn(mesh, compressed: bool = True, axis=("data", "model")):
    """Mean all-reduce of a per-device vector, optionally int8-compressed.

    Returns ``ar(x, resid) -> (avg, new_resid)``.  Every shard of this
    process contributes ``x`` (replicated over the local shards, as the
    reference's replicated inputs); other processes contribute theirs.
    Compressed mode quantizes ``x + resid`` to int8 (symmetric, scale =
    max/127, rounding half to even), reduces the dequantized values, and
    keeps the quantization error y − q·scale (rounded once) as the next
    call's error-feedback residual — unbiased over time, 4x less wire
    traffic.  Uncompressed
    mode is a plain mean with zero residual.
    """
    n = shard_count(mesh, axis)

    def total(v):
        acc = v
        for _ in range(len(mesh.devices) - 1):
            acc = acc + v
        if mesh.group is not None:
            import torch.distributed as dist

            acc = acc.to(_comm_device(mesh))
            dist.all_reduce(acc, op=dist.ReduceOp.SUM, group=mesh.group)
            acc = acc.to(v.device)
        return acc

    def ar(x, resid):
        x = torch.as_tensor(x, dtype=torch.float32)
        resid = torch.as_tensor(resid, dtype=torch.float32)
        if not compressed:
            return total(x) / n, torch.zeros_like(x)
        y = x + resid
        scale = torch.clamp(y.abs().max() / 127.0, min=1e-30)
        q = torch.clamp(torch.round(y / scale), -127, 127).to(torch.int8)
        deq = q.to(torch.float32) * scale
        # y - q·scale rounded once, as the compiled reference fuses it
        # into one multiply-add (exact in float64: q has 8 bits)
        resid = (y.double() - q.double() * scale.double()).float()
        return total(deq) / n, resid

    return ar
