"""Public wrappers around the Hopper kernels, with launch counters.

On a CUDA tensor a wrapper launches its kernel (``kernels/bf_relax.py``)
or raises; on a CPU tensor it runs the kernel's plain PyTorch version
(``kernels/ref.py``), only because the tensor lies on the CPU.  There is
no fallback from one to the other.

``LAUNCHES`` counts kernel launches per wrapper, so a run can show that
its main path went through the kernels (``reset_launches`` zeroes it).
"""

from __future__ import annotations

import torch

from . import bf_relax, ref

INF = ref.INF

LAUNCHES = {"bf_relax_step": 0, "bf_solve_grouped": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _on_cpu(t: torch.Tensor) -> bool:
    return t.device.type == "cpu"


def bf_relax_step(dist, adj, spur_onehot, banned_next, cap=None):
    """One fused masked BF relaxation (the Pallas ``bf_relax`` contract):
    dist [S,J,z], adj [S,z,z], spur_onehot/banned_next [S,J,z] 0/1 masks
    (any dtype; nonzero = set), cap [S,J] (default INF) → [S,J,z] f32."""
    S, J, _ = dist.shape
    if cap is None:
        cap = torch.full((S, J), INF, dtype=torch.float32, device=dist.device)
    args = (dist.float().contiguous(), adj.float().contiguous(),
            spur_onehot.bool().contiguous(), banned_next.bool().contiguous(),
            cap.float().contiguous())
    if _on_cpu(dist):
        return ref.bf_relax_ref(*args)
    out = bf_relax.relax_step(*args)
    LAUNCHES["bf_relax_step"] += 1
    return out


def bf_solve_grouped(adj, init, banned_v, spur_onehot, banned_next, cap):
    """Converged masked grouped Bellman–Ford plus parents: (dist [S,J,z]
    f32, parents [S,J,z] int32), the ``SolverBackend.solve_grouped``
    contract, in one kernel launch on the card."""
    args = (adj.float().contiguous(), init.float().contiguous(),
            banned_v.bool().contiguous(), spur_onehot.bool().contiguous(),
            banned_next.bool().contiguous(), cap.float().contiguous())
    if _on_cpu(init):
        return ref.bf_solve_grouped_ref(*args)
    dist, parent, _ = bf_relax.solve_grouped(*args)
    LAUNCHES["bf_solve_grouped"] += 1
    return dist, parent
