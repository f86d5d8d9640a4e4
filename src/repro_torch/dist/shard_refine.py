"""Multi-device production paths over a device mesh.

Three factories, each returning a function whose per-shard body runs on
the shard's own block of the owner-aligned [S, ...] slab layout (the
mesh is a :class:`repro_torch.launch.mesh.DeviceMesh`: this process's
devices, one per shard, and optionally a ``torch.distributed`` group of
processes that each hold as many):

* ``make_refine_fn``    — grouped masked BF refine (solve + parents),
  subgraph rows split over the mesh's shards.  The per-iteration
  relaxation is communication-free (problems are co-located with their
  subgraph's slab row), but the FIXED POINT is global: the convergence
  flag is an OR over the shards (and an ``all_reduce(MAX)`` over the
  processes), so every shard keeps stepping until the whole batch has
  converged.  Extra steps on an already-converged shard are bitwise
  no-ops (BF relaxation is idempotent at its fixed point), so the mesh
  solve is byte-identical to the single-device backends.  The
  relaxation body comes from a
  :class:`repro_torch.engine.backend.SolverBackend` (``mesh_relax``) —
  both the plain ``bf_step_grouped`` path and the ``bf_relax_step``
  kernel run under the same loop;
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

from repro_torch.engine.dense import INF, ShardedMirror


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


def make_refine_fn(mesh, axis=("data", "model"), max_iters: int | None = None,
                   backend=None):
    """(adj [S,z,z], dist0 [S,J,z], bv, so, bn [S,J,z], cap [S,J]) →
    (dist [S,J,z], parent [S,J,z]) with S split over the mesh's shards.

    ``backend`` supplies the per-iteration relaxation body via
    ``SolverBackend.mesh_relax`` (default: the plain PyTorch backend) —
    this is how BOTH ``dense_bf`` and ``cuda_bf`` get a mesh path from
    one wrapper.  Each relaxation step is purely local (problems were
    grouped next to their subgraph's slab row by the host dispatch);
    the only collective is the per-iteration OR of the convergence flag,
    read on the host once per iteration, which keeps every shard relaxing
    until the GLOBAL fixed point is reached, at most ``max_iters``
    (default z) iterations.  Shards that converged early relax
    idempotently, so the result is byte-identical to the single-device
    ``solve_grouped`` of the same backend.

    S must be a multiple of the shard count (``pack_round``'s
    ``s_multiple``).  Shard g of ``size`` takes rows [g·S/size,
    (g+1)·S/size) to its device; this process runs only its own shards,
    and with a process group the blocks are gathered from every process.
    The result lands on ``dist0``'s device.
    """
    if backend is None:
        from repro_torch.engine.backend import TorchBackend

        backend = TorchBackend()
    prep, step, parents = backend.mesh_relax()
    n_shards = shard_count(mesh, axis)

    def refine(adj, dist0, bv, so, bn, cap):
        S, J, z = dist0.shape
        if S % n_shards:
            raise ValueError(f"S={S} is not a multiple of the mesh's "
                             f"{n_shards} shards")
        rows = S // n_shards
        iters = z if max_iters is None else int(max_iters)
        home = dist0.device
        blocks = []
        for i, dev in enumerate(mesh.devices):
            g = mesh.first_shard + i
            a, d0, b, s_, n_, c = (t[g * rows:(g + 1) * rows].to(dev)
                                   for t in (adj, dist0, bv, so, bn, cap))
            so_p, bn_p = prep(s_, n_)
            blocks.append([a, torch.where(b, INF, d0), b, s_, n_, c,
                           so_p, bn_p])
        changed, it = True, 0
        while changed and it < iters:
            flags = []
            for blk in blocks:
                a, d, b, _, _, c, so_p, bn_p = blk
                new = step(d, a, b, so_p, bn_p, c)
                flags.append((new < d).any().to(home))
                blk[1] = new
            # one host read per iteration: converged shards keep relaxing
            # (idempotent) until the slowest shard's problems converge
            flag = torch.stack(flags).any().to(torch.int32)
            if mesh.group is not None:
                import torch.distributed as dist

                flag = flag.to(_comm_device(mesh))
                dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=mesh.group)
            changed = bool(flag.item())
            it += 1
        dist_out = torch.cat([blk[1].to(home) for blk in blocks])
        parent = torch.cat([parents(blk[0], blk[1], *blk[2:6]).to(home)
                            for blk in blocks])
        if mesh.group is None:
            return dist_out, parent
        return _gather(mesh, dist_out), _gather(mesh, parent)

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
