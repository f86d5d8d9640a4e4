"""Bounding paths, bound distances and lower bound distances (Secs 3.4–3.5).

Bounding paths between two boundary vertices are the paths with the ξ
*fewest distinct* vfrag counts (same-count paths "counted as only one").
We enumerate distinct vfrag levels with a k-level min-plus DP over walks
(the numpy reference of the ``ktrop`` Pallas kernel) and extract one
simple representative path per level via backpointer reconstruction.
The minimal level's walk is always simple (vfrags ≥ 1, so dropping a
loop strictly reduces the count); higher levels whose representative
turns out non-simple keep their BD (which depends only on φ) but carry
no actual-distance representative (D = +inf).

Bound distance (Example 2): BD(φ) = sum of the φ smallest *unit weights*
in the subgraph, where edge e contributes vfrag[e] copies of w[e]/vfrag[e].

Lower bound distance (Theorem 1, Definitions 5/6):
    D_u  = min over representatives of current actual distance
    BD_r = max over levels of bound distance
    LBD_paper = D_u  if D_u ≤ BD_r  else BD_r.

``lbd_mode="safe"`` instead returns min(D_u, BD_min): Theorem 1's claim 1
is leaky when two distinct paths share a vfrag level (the stored
representative may stop being the level's minimum-distance path as
weights drift), in which case LBD_paper can exceed the true shortest
distance.  The safe bound only uses the minimal level's BD, which is
unconditionally a lower bound.  See DESIGN.md §10.
"""

from __future__ import annotations

import dataclasses

import numpy as np

INF = np.inf


# --------------------------------------------------------------------------
# k-distinct-level walk DP (numpy reference of kernels/ktrop)
# --------------------------------------------------------------------------
def kdistinct_walk_dp(
    indptr: np.ndarray,
    nbr: np.ndarray,
    hw: np.ndarray,
    src: int,
    xi: int,
    max_iter: int | None = None,
) -> np.ndarray:
    """Distinct k smallest walk distances from ``src`` to every vertex.

    Returns D[xi, nv] ascending per column, +inf padded.  ``hw`` are the
    half-edge weights (vfrag counts when enumerating bounding paths).
    """
    nv = indptr.shape[0] - 1
    # dense incoming-edge layout: for each v, the list of (u, w) pairs
    src_of = np.repeat(np.arange(nv), np.diff(indptr))
    in_deg = np.bincount(nbr, minlength=nv)
    max_deg = int(in_deg.max()) if nv else 0
    in_u = np.full((nv, max_deg), -1, dtype=np.int64)
    in_w = np.full((nv, max_deg), INF)
    slot = np.zeros(nv, dtype=np.int64)
    for p in range(nbr.shape[0]):
        v = int(nbr[p])
        in_u[v, slot[v]] = src_of[p]
        in_w[v, slot[v]] = hw[p]
        slot[v] += 1

    D = np.full((xi, nv), INF)
    D[0, src] = 0.0
    it = 0
    cap = max_iter if max_iter is not None else nv * xi + 8
    while it < cap:
        it += 1
        # candidates from every incoming edge and every level
        safe_u = np.maximum(in_u, 0)
        cand = D[:, safe_u] + in_w[None, :, :]  # [xi, nv, max_deg]
        cand = np.where(in_u[None, :, :] >= 0, cand, INF)
        flat = cand.transpose(0, 2, 1).reshape(xi * max_deg, nv) if max_deg else D[:0]
        allv = np.concatenate([D, flat], axis=0)
        allv = np.sort(allv, axis=0)
        # dedupe: mask entries equal to their predecessor
        dup = np.zeros_like(allv, dtype=bool)
        dup[1:] = allv[1:] == allv[:-1]
        allv = np.where(dup, INF, allv)
        allv = np.sort(allv, axis=0)
        new = allv[:xi]
        if np.array_equal(new, D):
            break
        D = new
    return D


def extract_level_path(
    indptr: np.ndarray,
    nbr: np.ndarray,
    hw: np.ndarray,
    D: np.ndarray,
    src: int,
    dst: int,
    level_dist: float,
    max_len: int | None = None,
) -> list[int] | None:
    """Reconstruct one walk src→dst of total weight ``level_dist``.

    Walks backward greedily; returns None if the walk is not simple
    (or reconstruction fails, which only happens for non-simple levels).
    """
    nv = indptr.shape[0] - 1
    # reverse adjacency for backward steps
    src_of = np.repeat(np.arange(nv), np.diff(indptr))
    max_len = max_len if max_len is not None else nv + D.shape[0] + 2
    path = [dst]
    need = level_dist
    v = dst
    seen = {dst}
    while v != src or need > 1e-9:
        lo_list = np.nonzero(nbr == v)[0]  # half-edges u→v
        stepped = False
        best = None
        for p in lo_list:
            u = int(src_of[p])
            w = float(hw[p])
            rem = need - w
            if rem < -1e-9:
                continue
            # is rem a walk distance at u?
            if np.any(np.abs(D[:, u] - rem) <= 1e-9):
                if best is None or rem < best[1]:
                    best = (u, rem)
        if best is None:
            return None
        u, rem = best
        if u in seen:
            return None  # non-simple walk

        path.append(u)
        seen.add(u)
        need = rem
        v = u
        if len(path) > max_len:
            return None
    return path[::-1]


# --------------------------------------------------------------------------
# bound distances (numpy reference of kernels/bound_dist)
# --------------------------------------------------------------------------
@dataclasses.dataclass
class UnitWeightProfile:
    """Sorted unit-weight prefix structure of one subgraph."""

    cum_vfrag: np.ndarray  # int64[ne] cumulative vfrag counts (sorted by unit w)
    cum_wsum: np.ndarray  # float64[ne] cumulative unit-weight mass
    unit_sorted: np.ndarray  # float64[ne]


def unit_weight_profile(w: np.ndarray, vfrag: np.ndarray) -> UnitWeightProfile:
    unit = w / vfrag
    order = np.argsort(unit, kind="stable")
    u_sorted = unit[order]
    vf_sorted = vfrag[order].astype(np.int64)
    cum_vf = np.cumsum(vf_sorted)
    cum_ws = np.cumsum(u_sorted * vf_sorted)
    return UnitWeightProfile(cum_vfrag=cum_vf, cum_wsum=cum_ws, unit_sorted=u_sorted)


def bound_distances(profile: UnitWeightProfile, phi: np.ndarray) -> np.ndarray:
    """BD(φ) = sum of the φ smallest unit weights (vectorized over φ)."""
    phi = np.asarray(phi, dtype=np.int64)
    idx = np.searchsorted(profile.cum_vfrag, phi, side="left")
    idx = np.minimum(idx, profile.cum_vfrag.shape[0] - 1)
    prev_vf = np.where(idx > 0, profile.cum_vfrag[idx - 1], 0)
    prev_ws = np.where(idx > 0, profile.cum_wsum[idx - 1], 0.0)
    out = prev_ws + (phi - prev_vf) * profile.unit_sorted[idx]
    # φ beyond the subgraph's total vfrags: clamp to the full mass
    total_vf = profile.cum_vfrag[-1]
    out = np.where(phi > total_vf, profile.cum_wsum[-1], out)
    return out


# --------------------------------------------------------------------------
# lower bound distances (Theorem 1)
# --------------------------------------------------------------------------
def lower_bound_distances(
    pair_ptr: np.ndarray,
    path_D: np.ndarray,
    path_BD: np.ndarray,
    mode: str = "paper",
) -> np.ndarray:
    """Per-pair LBD from per-path current distances and bound distances.

    pair_ptr : CSR [n_pairs+1] into the path arrays.
    """
    n_pairs = pair_ptr.shape[0] - 1
    out = np.full(n_pairs, INF)
    for i in range(n_pairs):
        lo, hi = pair_ptr[i], pair_ptr[i + 1]
        if hi <= lo:
            continue
        d_u = float(np.min(path_D[lo:hi]))
        bd_r = float(np.max(path_BD[lo:hi]))
        bd_1 = float(np.min(path_BD[lo:hi]))
        if mode == "paper":
            out[i] = d_u if d_u <= bd_r else bd_r
        else:  # safe
            out[i] = min(d_u, bd_1)
    return out


def lower_bound_distances_vec(
    pair_ptr: np.ndarray,
    path_D: np.ndarray,
    path_BD: np.ndarray,
    mode: str = "paper",
) -> np.ndarray:
    """Vectorized variant (segment min/max via np.minimum.at)."""
    n_pairs = pair_ptr.shape[0] - 1
    n_paths = path_D.shape[0]
    seg = np.repeat(np.arange(n_pairs), np.diff(pair_ptr))
    d_u = np.full(n_pairs, INF)
    np.minimum.at(d_u, seg, path_D[:n_paths])
    bd_r = np.full(n_pairs, -INF)
    np.maximum.at(bd_r, seg, path_BD[:n_paths])
    bd_1 = np.full(n_pairs, INF)
    np.minimum.at(bd_1, seg, path_BD[:n_paths])
    if mode == "paper":
        out = np.where(d_u <= bd_r, d_u, bd_r)
    else:
        out = np.minimum(d_u, bd_1)
    out = np.where(np.diff(pair_ptr) > 0, out, INF)
    return out
