"""Plain PyTorch versions of the Hopper kernels in ``csrc/``.

They are the ground truth the kernels are held to on the card, and what
the wrappers in :mod:`repro_torch.kernels.ops` run on CPU tensors.  Both
use only f32 add, min and compare, so the kernels must match them bit for
bit.
"""

from __future__ import annotations

import numpy as np
import torch

INF = float(np.float32(3.0e38))  # finite "infinity": keeps min-plus NaN-free


def bf_relax_ref(dist, adj, spur_onehot, banned_next, cap):
    """One fused masked min-plus relaxation (grouped layout).

    dist [S,J,z] f32; adj [S,z,z] f32; spur_onehot/banned_next [S,J,z]
    bool; cap [S,J] f32 → new dist [S,J,z].  A term d[u]+adj[u,v] is cut
    where spur[u] and ban[v] are both set; values above the cap become
    INF."""
    contrib = dist[:, :, :, None] + adj[:, None, :, :]
    cut = spur_onehot[:, :, :, None] & banned_next[:, :, None, :]
    contrib = torch.where(cut, INF, contrib)
    new = torch.minimum(dist, contrib.amin(dim=2))
    return torch.where(new > cap[:, :, None], INF, new)


def bf_solve_grouped_ref(adj, init, banned_v, spur_onehot, banned_next, cap):
    """The fused solve kernel's plain version: (dist [S,J,z], parents
    [S,J,z] int32).

    Iterates :func:`bf_relax_ref` (cap clamp inside) with the
    banned-vertex re-mask after each step, then recovers parents with
    ``engine.dense.bf_parents_grouped``.  It runs z relaxations (the
    reference's iteration cap) and never reads the change flag on the host: a
    relaxation that decreases nothing returns the same values again, so
    the extra iterations leave the reference's early-exit fixed point
    unchanged, bit for bit."""
    from ..engine.dense import bf_parents_grouped

    dist = torch.where(banned_v, INF, init)
    for _ in range(init.shape[-1]):
        new = bf_relax_ref(dist, adj, spur_onehot, banned_next, cap)
        dist = torch.where(banned_v, INF, new)
    return dist, bf_parents_grouped(adj, dist, spur_onehot, banned_next)
