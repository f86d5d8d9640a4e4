"""SolverBackend: the pluggable grouped-solve execution layer.

One backend = one way to run the hot loop — a converged masked grouped
Bellman–Ford over the owner-aligned [S, J, z] slab layout — plus the
:class:`~repro_torch.engine.layout.SlabLayout` geometry that execution
wants:

* :class:`TorchBackend` — the plain PyTorch path on any device
  (``engine.yen_engine.grouped_solver``), tight lane=8 slabs.
* :class:`CudaBackend` — the fused Hopper kernel ``bf_solve_grouped``
  (``csrc/bf_relax.cu``): the whole fixed point and the parents in one
  launch, on 32-lane slabs.  On CPU tensors it runs the kernel's plain
  version (``kernels/ref.py``).

Both implement the same contract —

    solve_grouped(adj, init, banned_v, spur_onehot, banned_next, cap)
        -> (dist [S, J, z], parents [S, J, z])

— the exact signature ``dist.grouped_yen._dispatch_round`` calls.  The
two relax the same candidate set with exact f32 min-plus arithmetic, so
their fixed points — and every path served through them — are
byte-identical.
"""

from __future__ import annotations

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
        """The per-shard relaxation a multi-device fixed point iterates.
        Not ported: multi-GPU serving is queued in ROADMAP.md."""
        raise NotImplementedError(
            f"{type(self).__name__} has no multi-device path yet; "
            "see ROADMAP.md (queue 1, multi-GPU)"
        )

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
