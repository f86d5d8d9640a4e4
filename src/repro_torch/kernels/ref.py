"""Plain PyTorch versions of the Hopper kernels in ``csrc/``.

They are the ground truth the kernels are held to on the card, and what
the wrappers in :mod:`repro_torch.kernels.ops` run on CPU tensors.  The
min-plus ones (``bf_*``, ``ktrop_*``) use only f32 add, min, compare and
sort, so the kernels must match them bit for bit.  ``level_walks_ref`` only subtracts and compares integer-valued
f32, so the walk kernel must match it bit for bit too.  ``bound_dist_ref``
sums floats in torch's order, so the kernel is held to it by a tolerance
and to ``bound_dist_seq_ref``, the same sum in the kernel's order, bit
for bit; ``group_by_subgraph`` is the kernel's grouping of the queries.
"""

from __future__ import annotations

import numpy as np
import torch

INF = float(np.float32(3.0e38))  # finite "infinity": keeps min-plus NaN-free


def bf_relax_ref(dist, adj, spur_onehot, banned_next, cap):
    """One fused masked min-plus relaxation (grouped layout).

    dist [S,J,z] f32; adj [S,z,z] f32; spur_onehot/banned_next [S,J,z]
    bool; cap [S,J] f32 → new dist [S,J,z].  A term d[u]+adj[u,v] is cut
    where spur[u] and ban[v] are both set; the minimum over the terms
    starts at INF, as the Pallas kernel's accumulator does (so +inf, from
    a +inf distance or an INF+INF overflow, never comes out above a cap
    of +inf); values above the cap become INF.

    On +inf inputs under a cap of +inf this follows the reference's
    Pallas kernel, not its plain ``ref.bf_relax_ref``, whose minimum
    starts at +inf and so returns +inf there.  The plain engine's step
    (``engine.dense.bf_step_grouped``, the ``dense_bf`` mesh body) keeps
    that +inf start, as the reference's ``dense_bf`` does; the two
    engines agree on every input with distances <= INF or caps <= INF,
    which is all that serving gives them."""
    contrib = dist[:, :, :, None] + adj[:, None, :, :]
    cut = spur_onehot[:, :, :, None] & banned_next[:, :, None, :]
    contrib = torch.where(cut, INF, contrib)
    new = torch.minimum(dist, contrib.amin(dim=2).clamp(max=INF))
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


def level_walks_ref(D, row_sub, row_src, row_max_len, in_ptr, in_src, in_w,
                    in_eid, walk_ptr, walk_dst, walk_level):
    """Every walk of ``core.bounding.extract_level_path`` for a batch, in
    lockstep: (verts [W,z] int32, eids [W,z] int32, n [W] int32).

    Walk w belongs to row s (``walk_ptr`` [S+1]: row s owns walks
    walk_ptr[s] to walk_ptr[s+1]); it runs from row_src[s] to walk_dst[w]
    over the in-edges of subgraph row_sub[s] (``in_ptr`` [G,z+1]: the
    in-edges of v are entries in_ptr[g,v] to in_ptr[g,v+1] of in_src,
    in_w, in_eid, ascending half-edge order) with total weight
    walk_level[w], found backwards from the target: of v's in-edges u->v
    whose remainder rem = need - w is >= 0 and one of u's levels D[s,:,u],
    the smallest rem wins, the first of equals a tie.  No such step, a
    step onto a seen vertex, or more than row_max_len[s] vertices gives
    n = 0.  Otherwise verts[w,:n] is the walk from the source and
    eids[w,:n-1] the in_eid of its steps; entries past them are -1."""
    S, k, z = D.shape
    W = walk_dst.shape[0]
    dev = D.device
    lw = torch.arange(W, device=dev)
    row = torch.repeat_interleave(torch.arange(S, device=dev),
                                  walk_ptr.long().diff(), output_size=W)
    g, src = row_sub.long()[row], row_src.long()[row]
    max_len = row_max_len.long()[row]
    ptr = in_ptr.long()
    deg = ptr[:, 1:] - ptr[:, :-1]  # [G,z]
    slot = torch.arange(max(int(deg.max()) if deg.numel() else 0, 1),
                        device=dev)
    if in_src.shape[0] == 0:  # one entry that no step can take
        in_src, in_eid = (torch.zeros(1, dtype=t.dtype, device=dev)
                          for t in (in_src, in_eid))
        in_w = torch.zeros(1, dtype=in_w.dtype, device=dev)
    H = in_src.shape[0]
    v, need = walk_dst.long(), walk_level.clone()
    verts = torch.full((W, z), -1, dtype=torch.int64, device=dev)
    eids = torch.full((W, z), -1, dtype=torch.int64, device=dev)
    seen = torch.zeros((W, z), dtype=torch.bool, device=dev)
    verts[lw, 0] = v
    seen[lw, v] = True
    n = torch.ones(W, dtype=torch.int64, device=dev)
    walking = torch.ones(W, dtype=torch.bool, device=dev)
    simple = torch.ones(W, dtype=torch.bool, device=dev)
    while True:
        walking &= (v != src) | (need > 0)
        if not bool(walking.any()):
            break
        p = ptr[g, v][:, None] + slot  # [W,slots]
        has = slot < deg[g, v][:, None]
        p = torch.where(has, p, 0).clamp(max=H - 1)
        u = in_src.long()[p]
        rem = need[:, None] - in_w[p]
        levels = D[row[:, None], :, u]  # [W,slots,k]
        step = has & (rem >= 0) & (levels == rem[..., None]).any(-1)
        best = torch.where(step, rem, torch.inf).argmin(dim=1, keepdim=True)
        bu = u.gather(1, best)[:, 0]
        fail = walking & (~step.any(dim=1) | seen[lw, bu])
        simple &= ~fail
        walking &= ~fail
        at = lw[walking]
        bu, pos = bu[walking], n[walking]
        verts[at, pos] = bu
        eids[at, pos - 1] = in_eid.long()[p.gather(1, best)[walking, 0]]
        seen[at, bu] = True
        n[walking] += 1
        need = torch.where(walking, rem.gather(1, best)[:, 0], need)
        v = torch.where(walking, u.gather(1, best)[:, 0], v)
        over = walking & (n > max_len)
        simple &= ~over
        walking &= ~over
    n = torch.where(simple, n, 0)
    # reverse each walk in place: source first
    j = torch.arange(z, device=dev)
    back_v = (n[:, None] - 1 - j).clamp(min=0)
    back_e = (n[:, None] - 2 - j).clamp(min=0)
    verts = torch.where(j < n[:, None], verts.gather(1, back_v), -1)
    eids = torch.where(j < n[:, None] - 1, eids.gather(1, back_e), -1)
    return verts.to(torch.int32), eids.to(torch.int32), n.to(torch.int32)


def bound_dist_ref(w_sorted, n_sorted, cum_before, sub, phi):
    """BD(φ) = Σ_e w_e · clip(φ − cum_before_e, 0, n_e) over the φ
    smallest unit weights (ascending-sorted profile).

    w_sorted/n_sorted/cum_before [S,E] f32; sub [B] int; phi [B] f32 →
    [B] f32.  Padded entries (w = INF, n = 0) add INF·0 = 0."""
    sub = sub.long()
    take = torch.minimum(
        torch.clamp(phi[:, None] - cum_before[sub], min=0.0), n_sorted[sub])
    return (w_sorted[sub] * take).sum(dim=-1)


def bound_dist_seq_ref(w_sorted, n_sorted, cum_before, sub, phi):
    """``bound_dist_ref`` in the Hopper kernel's order: per query, the
    clip-sum over ascending e, each step rounded on its own (subtract,
    clamp, multiply, add), stopping at the first e with
    cum_before[e] ≥ φ.  Same signature and shapes.

    Where cum_before is the exclusive running count of n ≥ 0 and w ≥ 0,
    every term after the stop is w·(+0) = +0, so the stop gives the loop
    run to E, bit for bit."""
    sub = sub.long()
    acc = torch.zeros(phi.shape, dtype=torch.float32, device=phi.device)
    alive = torch.ones(phi.shape, dtype=torch.bool, device=phi.device)
    for e in range(w_sorted.shape[-1]):
        c = cum_before[sub, e]
        alive &= ~(c >= phi)
        take = torch.minimum(torch.clamp(phi - c, min=0.0), n_sorted[sub, e])
        acc = torch.where(alive, acc + w_sorted[sub, e] * take, acc)
        if e % 64 == 63 and not bool(alive.any()):
            break
    return acc


def group_by_subgraph(sub, S: int):
    """The kernel's grouping of B queries by subgraph: (counts [S],
    offsets [S+1] (each bucket's first position), order [B]: query ids
    by subgraph, stable), all int32.  The kernel's order inside a bucket
    is not stable; its counts and offsets are these."""
    sub = sub.long()
    counts = torch.bincount(sub, minlength=S).to(torch.int32)
    offsets = torch.zeros(S + 1, dtype=torch.int32, device=sub.device)
    offsets[1:] = counts.cumsum(0)
    order = torch.sort(sub, stable=True).indices.to(torch.int32)
    return counts, offsets, order
