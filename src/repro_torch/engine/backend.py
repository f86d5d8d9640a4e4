"""SolverBackend: the pluggable grouped-solve execution layer.

One backend = one way to run the hot loop — a converged masked grouped
Bellman–Ford over the owner-aligned [S, J, z] slab layout — plus the
:class:`~repro_torch.engine.layout.SlabLayout` geometry that execution
wants:

* :class:`TorchBackend` — the plain PyTorch path on any device
  (``engine.yen_engine.grouped_solver``), tight lane=8 slabs.
* :class:`CudaBackend` — the fused Hopper kernel ``bf_solve_grouped``
  (``csrc/bf_relax.cu``): the whole fixed point and the parents in one
  launch, on 32-lane slabs; on a mesh it iterates the one-relaxation
  kernel ``bf_relax_step`` instead.  On CPU tensors it runs the kernels'
  plain versions (``kernels/ref.py``).

Both implement the same contract —

    solve_grouped(adj, init, banned_v, spur_onehot, banned_next, cap)
        -> (dist [S, J, z], parents [S, J, z])

— the exact signature ``dist.grouped_yen._dispatch_round`` calls (and
that a ``shard_refine.make_refine_fn`` mesh solver overrides).  The
two relax the same candidate set with exact f32 min-plus arithmetic, so
their fixed points — and every path served through them — are
byte-identical.
"""

from __future__ import annotations

import torch

from repro_torch import obs

from .layout import HOPPER_LAYOUT, PLAIN_LAYOUT, SlabLayout

__all__ = ["SolverBackend", "TorchBackend", "CudaBackend"]


class SolverBackend:
    """Interface: grouped-solve execution + the slab geometry it wants."""

    name: str = "abstract"
    layout: SlabLayout

    def solve_grouped(self, adj, init, banned_v, spur_onehot, banned_next,
                      cap):
        """Converged (dist [S,J,z], parents [S,J,z] int32) for one bucket.

        ``adj`` [S,z,z] min-plus slab; ``init`` [S,J,z] f32 (+INF except
        sources/warm starts); ``banned_v``/``spur_onehot``/
        ``banned_next`` [S,J,z] bool masks; ``cap`` [S,J] f32 distance
        caps (early termination).  All-INF padding rows must no-op.

        The call is ASYNC: it returns tensors on the inputs' device with
        no ``.item()``, ``.cpu()`` or synchronize, so a pipelined caller
        overlaps the device solve with host-side splicing and only waits
        when it copies the result to the host.
        """
        raise NotImplementedError

    def mesh_relax(self):
        """``(prep, step, parents)``: the building blocks a mesh fixed
        point (``repro_torch.dist.shard_refine.make_refine_fn``) runs per
        shard.

        ``prep(spur_onehot, banned_next)`` converts the bool masks once,
        outside the loop.  ``step(dist, adj, banned_v, so_p, bn_p, cap)``
        is ONE full loop iteration — the relaxation, the banned-vertex
        re-mask, and the cap clamp — in exactly the op order this
        backend's single-device ``solve_grouped`` uses.  BF relaxation is
        idempotent at its fixed point, so a mesh loop that runs extra
        iterations on an already-converged shard (while the OR of the
        change flags says some OTHER shard still changes) lands on the
        same bytes as the single-device solve.  ``parents(adj, dist,
        banned_v, spur_onehot, banned_next, cap)`` recovers the
        backpointers [S,J,z] int32 of the converged field.
        """
        raise NotImplementedError

    def __repr__(self):  # pragma: no cover - debugging nicety
        return f"{type(self).__name__}(layout={self.layout.name!r})"


class TorchBackend(SolverBackend):
    """The plain PyTorch solver on tight lane=8 slabs, on any device."""

    name = "torch"
    layout = PLAIN_LAYOUT

    def solve_grouped(self, adj, init, banned_v, spur_onehot, banned_next,
                      cap):
        from .yen_engine import grouped_solver

        S, J, z = init.shape
        t0 = obs.clock()
        out = grouped_solver(adj, init, banned_v, spur_onehot, banned_next,
                             cap)
        # dispatch cost only on the card: the wait shows up in the
        # caller's "solve" (future.step) span when the result is copied
        obs.span_at("solve_grouped", t0, obs.clock() - t0,
                    backend=self.name, S=S, J=J, z=z)
        return out

    def mesh_relax(self):
        from .dense import INF, bf_parents_grouped, bf_step_grouped

        def prep(so, bn):
            return so, bn

        def step(dist, adj, bv, so, bn, cap):
            # mirrors bf_solve_grouped's body: relax → banned-vertex
            # re-mask → cap clamp, in that order
            new = bf_step_grouped(dist, adj, so, bn)
            new = torch.where(bv, INF, new)
            return torch.where(new > cap[:, :, None], INF, new)

        def parents(adj, dist, bv, so, bn, cap):
            return bf_parents_grouped(adj, dist, so, bn)

        return prep, step, parents


class CudaBackend(SolverBackend):
    """The fused Hopper kernel: one ``bf_solve_grouped`` launch per solve
    (relaxation, cap clamp, banned-vertex re-mask and change test per
    iteration, then parents).  CPU tensors run its plain version."""

    name = "cuda"
    layout = HOPPER_LAYOUT

    def solve_grouped(self, adj, init, banned_v, spur_onehot, banned_next,
                      cap):
        from repro_torch.kernels import ops

        S, J, z = init.shape
        t0 = obs.clock()
        out = ops.bf_solve_grouped(adj, init, banned_v, spur_onehot,
                                   banned_next, cap)
        obs.span_at("solve_grouped", t0, obs.clock() - t0,
                    backend=self.name, S=S, J=J, z=z,
                    device=init.device.type)
        return out

    def mesh_relax(self):
        from repro_torch.kernels import ops

        from .dense import INF

        def prep(so, bn):
            return so, bn  # the kernel takes the bool masks as they are

        def step(dist, adj, bv, so, bn, cap):
            # mirrors the fused solve's iteration: the bf_relax_step
            # kernel applies the spur cut and cap clamp, then the bv
            # re-mask
            new = ops.bf_relax_step(dist, adj, so, bn, cap)
            return torch.where(bv, INF, new)

        def parents(adj, dist, bv, so, bn, cap):
            # the fused kernel's own epilogue, with no iteration: its
            # parents are bf_parents_grouped's, bit for bit, and it never
            # builds the [S,J,z,z] candidates the plain version does
            return ops.bf_solve_grouped(adj, dist, bv, so, bn, cap,
                                        max_iters=0)[1]

        return prep, step, parents
