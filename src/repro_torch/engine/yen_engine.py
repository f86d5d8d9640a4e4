"""Engine-level KSP: Yen's loopless outer loop, device-batched inner loop.

The host drives Yen's deviation paradigm; every iteration's spur searches
(one per deviation vertex) become ONE masked batched Bellman–Ford call —
PYen's "parallel deviation path identification" with SIMD instead of
threads.  PYen's A_D/A_P reuse appears as warm-start initialization, and
its early termination as the distance-cap clamp (both inside bf_solve).
``engine_ksp`` runs Yen on one slab with the plain flat solve (on any
device); the grouped Yen loop (``dist.grouped_yen``) dispatches its
rounds through :func:`grouped_solver` or the fused kernel.

Exactness: identical to core.yen (tested); the batching changes schedule,
not math.
"""

from __future__ import annotations

import numpy as np
import torch

from .dense import (
    INF,
    bf_parents,
    bf_parents_grouped,
    bf_solve,
    bf_solve_grouped,
    to_device,
)


def _extract(parent_row, src, dst):
    path = [dst]
    v = dst
    hops = 0
    while v != src:
        v = int(parent_row[v])
        if v < 0 or hops > parent_row.shape[0]:
            return None
        path.append(v)
        hops += 1
    return path[::-1]


def grouped_solver(adj, init, bv, so, bn, cap):
    """The plain grouped (solve + parents) over the owner-aligned
    [S, J, z] slab layout: J spur problems per subgraph relaxed against
    adj [S, z, z] with zero gather.  Any device; returns device tensors
    without waiting on them."""
    dist, _ = bf_solve_grouped(adj, init, bv, so, bn, cap=cap)
    return dist, bf_parents_grouped(adj, dist, so, bn)


def _spur_batch(adj_np, jobs, warm=None, caps=None, device="cuda"):
    """jobs: list of (spur, banned_v bool[z], banned_next bool[z]).
    Returns (dist [P,z] np, parent [P,z] np), solved on ``device``.
    P is padded to a power of two, as the reference buckets its shapes;
    padding rows have all-INF init, so relaxation no-ops on them."""
    P = len(jobs)
    z = adj_np.shape[0]
    P_pad = 1 << (P - 1).bit_length() if P > 1 else 1
    init = np.full((P_pad, z), INF, np.float32)
    bv = np.zeros((P_pad, z), bool)
    so = np.zeros((P_pad, z), bool)
    bn = np.zeros((P_pad, z), bool)
    cap = np.full(P_pad, INF, np.float32)
    for i, (spur, banned_v, banned_next) in enumerate(jobs):
        init[i, spur] = 0.0
        bv[i] = banned_v
        so[i, spur] = True
        bn[i] = banned_next
        if warm is not None and warm[i] is not None:
            init[i] = np.minimum(init[i], warm[i])
    if caps is not None:
        cap[:P] = caps
    dev = torch.device(device)
    adj = to_device(np.ascontiguousarray(adj_np, dtype=np.float32), dev)
    adj = adj[None].expand(P_pad, z, z)
    init, bv, so, bn, cap = (to_device(a, dev) for a in (init, bv, so, bn, cap))
    dist, _ = bf_solve(adj, init, bv, so, bn, cap=cap)
    parent = bf_parents(adj, dist, so, bn)
    return dist.cpu().numpy()[:P], parent.cpu().numpy()[:P]


def engine_ksp(adj_np: np.ndarray, src: int, dst: int, k: int,
               use_cap: bool = True, device="cuda"):
    """K shortest simple paths on a dense adjacency via batched BF.

    adj_np: float32[z,z] min-plus adjacency (INF off-edges, 0 diagonal).
    The spur searches run on ``device``.  Returns [(dist, path-tuple)],
    ascending."""
    z = adj_np.shape[0]
    # P1 by a single-problem solve
    dist, parent = _spur_batch(
        adj_np, [(src, np.zeros(z, bool), np.zeros(z, bool))], device=device)
    if dist[0, dst] >= INF / 2:
        return []
    p1 = _extract(parent[0], src, dst)
    found = [(float(dist[0, dst]), tuple(p1))]
    found_set = {tuple(p1)}
    cand: list = []
    cand_set: set = set()

    while len(found) < k:
        prev_dist, prev = found[-1]
        # prefix distances along prev
        pre = [0.0]
        for a, b in zip(prev, prev[1:]):
            pre.append(pre[-1] + float(adj_np[a, b]))
        jobs, meta, caps = [], [], []
        for l in range(len(prev) - 1):
            spur = prev[l]
            root = prev[: l + 1]
            banned_next = np.zeros(z, bool)
            for fd, fp in found:
                if len(fp) > l and fp[: l + 1] == root:
                    banned_next[fp[l + 1]] = True
            banned_v = np.zeros(z, bool)
            for v in root[:-1]:
                banned_v[v] = True
            cap = INF
            if use_cap:
                need = k - len(found)
                if len(cand) >= need:
                    cap = cand[need - 1][0] - pre[l] + 1e-9
            jobs.append((spur, banned_v, banned_next))
            meta.append((l, spur))
            caps.append(cap)
        dist, parent = _spur_batch(adj_np, jobs, caps=np.array(caps),
                                   device=device)
        for i, (l, spur) in enumerate(meta):
            if dist[i, dst] >= INF / 2:
                continue
            tail = _extract(parent[i], spur, dst)
            if tail is None:
                continue
            full = tuple(prev[:l]) + tuple(tail)
            if full in found_set or full in cand_set:
                continue
            if len(set(full)) != len(full):
                continue
            cand_set.add(full)
            cand.append((pre[l] + float(dist[i, dst]), full))
        if not cand:
            break
        cand.sort(key=lambda x: (x[0], x[1]))
        best = cand.pop(0)
        cand_set.discard(best[1])
        found.append(best)
        found_set.add(best[1])
    return found
