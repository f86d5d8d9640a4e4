"""Plain PyTorch versions of the Hopper kernels in ``csrc/``.

They are the ground truth the kernels are held to on the card, and what
the wrappers in :mod:`repro_torch.kernels.ops` run on CPU tensors.  The
min-plus ones (``bf_*``, ``ktrop_*``) use only f32 add, min, compare and
sort, so the kernels must match them bit for bit; ``bound_dist_ref``
sums floats, so its kernel is held to a tolerance.
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


def bf_solve_grouped_ref(adj, init, banned_v, spur_onehot, banned_next, cap,
                         max_iters: int | None = None, with_iters: bool = False):
    """The fused solve kernel's plain version: (dist [S,J,z], parents
    [S,J,z] int32), and with ``with_iters`` also iters [S] int32.

    Iterates :func:`bf_relax_ref` (cap clamp inside) with the
    banned-vertex re-mask after each step, then recovers parents with
    ``engine.dense.bf_parents_grouped``.  It runs ``max_iters`` (default
    z, the reference's iteration cap) relaxations and never reads the
    change flag on the host: a relaxation that decreases nothing returns
    the same values again, so the extra iterations leave the reference's
    early-exit fixed point unchanged, bit for bit.  ``iters`` counts, per
    slab row, the relaxations up to and including the first that
    decreased nothing in that row (where the kernel stops the row); its
    maximum over rows is the reference's global count."""
    from ..engine.dense import bf_parents_grouped

    S = init.shape[0]
    dist = torch.where(banned_v, INF, init)
    iters = torch.zeros(S, dtype=torch.int32, device=init.device)
    active = torch.ones(S, dtype=torch.bool, device=init.device)
    for _ in range(init.shape[-1] if max_iters is None else max_iters):
        new = bf_relax_ref(dist, adj, spur_onehot, banned_next, cap)
        new = torch.where(banned_v, INF, new)
        iters += active
        active &= (new < dist).flatten(1).any(dim=1)
        dist = new
    parent = bf_parents_grouped(adj, dist, spur_onehot, banned_next)
    return (dist, parent, iters) if with_iters else (dist, parent)


def ktrop_relax_ref(D, adj):
    """One k-distinct tropical relaxation (k smallest DISTINCT values
    among existing levels and one-step extensions):
    ``engine.dense.ktrop_step(distinct=True)``.

    D [S,k,z] ascending per (s,:,v) → new D [S,k,z]: the k smallest
    distinct values below INF, padded with INF."""
    from ..engine.dense import ktrop_step

    return ktrop_step(D, adj, distinct=True)


def ktrop_solve_ref(adj, src, k: int, max_iters: int | None = None):
    """The fused ``ktrop_solve`` kernel's plain version: (D [S,k,z],
    iters [S] int32), ``engine.dense.ktrop_solve`` with the per-row
    iteration count the kernel reports."""
    from ..engine.dense import ktrop_solve_iters

    return ktrop_solve_iters(adj, src, k, max_iters)


def bound_dist_ref(w_sorted, n_sorted, cum_before, sub, phi):
    """BD(φ) = Σ_e w_e · clip(φ − cum_before_e, 0, n_e) over the φ
    smallest unit weights (ascending-sorted profile).

    w_sorted/n_sorted/cum_before [S,E] f32; sub [B] int; phi [B] f32 →
    [B] f32.  Padded entries (w = INF, n = 0) add INF·0 = 0."""
    sub = sub.long()
    take = torch.minimum(
        torch.clamp(phi[:, None] - cum_before[sub], min=0.0), n_sorted[sub])
    return (w_sorted[sub] * take).sum(dim=-1)
