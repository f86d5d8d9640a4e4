"""Batched dense min-plus relaxation over padded subgraphs, in PyTorch.

The paper's hot loop — Dijkstra inside Yen's spur-path computation — is
pointer-chasing and priority queues.  Here it becomes:

  * subgraphs → padded dense [S, z, z] adjacency slabs (min-plus semiring)
  * one Yen iteration's deviation vertices → ONE batch of masked
    multi-source Bellman–Ford problems, grouped by owning subgraph as
    [S, J, z] against adj [S, z, z] (zero gather)
  * early termination → distance-cap clamping inside the relaxation

The functions here are the plain PyTorch versions (any device); the
fused Hopper kernel of the same solve lives in ``kernels/`` and is held
to them bit for bit.  ``pack_subgraphs`` produces the same bytes as the
reference package's.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

INF = float(np.float32(3.0e38))  # finite "infinity": keeps min-plus NaN-free

# the parent tolerance factor as f32, as the reference multiplies it
_REL_TOL = torch.tensor(1e-6, dtype=torch.float32)


# ---------------------------------------------------------------------------
# packing
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class SubgraphSlab:
    """Padded dense subgraph batch + bookkeeping (host side).

    ``adj_dev`` is the DEVICE-RESIDENT copy of ``adj`` (:func:`place_slab`
    creates it): the per-round dispatch gathers adjacency rows from it on
    the device (:func:`gather_slab_rows`) instead of copying the slab
    host→device every grouped solve.  Patches keep it in sync
    FUNCTIONALLY — each update produces a new tensor, never writes into
    the old one — so a streaming epoch swap stays a pure pointer swap and
    in-flight queries keep reading the previous epoch's buffer.
    """

    adj: np.ndarray        # float32[S, z, z] min-plus adjacency (INF padded)
    nv: np.ndarray         # int32[S] true vertex counts
    gids: np.ndarray       # int64[S] original subgraph ids
    z: int
    epoch: int = 0         # graph epoch the adj entries were packed/patched at
    adj_dev: torch.Tensor | None = None  # device copy [S, z, z]

    @property
    def n_sub(self) -> int:
        return int(self.adj.shape[0])


def pack_subgraphs(
    partition, weights, z_pad: int | None = None, gids=None,
    lane: int = 128, epoch: int = 0, layout=None,
) -> SubgraphSlab:
    """Dense-pack subgraphs of a core Partition under `weights`.

    ``gids`` selects a subset (a worker packs only the subgraphs it owns
    in the distributed runtime); default packs every subgraph.  Geometry
    comes from ``layout`` (a :class:`repro_torch.engine.layout.SlabLayout`
    — the distributed worker passes its engine backend's) when given;
    otherwise from ``lane``, the bare z-alignment.
    """
    subs = partition.subgraphs
    if gids is not None:
        subs = [partition.subgraphs[g] for g in gids]
    if not subs:
        raise ValueError("pack_subgraphs needs at least one subgraph")
    z = max(sg.nv for sg in subs)
    if z_pad is not None:
        z = max(z, z_pad)
    if layout is not None:
        z = layout.align_z(z)
    else:
        z = int(lane * ((z + lane - 1) // lane))
    S = len(subs)
    adj = np.full((S, z, z), INF, dtype=np.float32)
    nv = np.zeros(S, dtype=np.int32)
    for i, sg in enumerate(subs):
        a = sg.local_adjacency(weights, inf=INF)
        adj[i, : sg.nv, : sg.nv] = a
        adj[i, np.arange(sg.nv), np.arange(sg.nv)] = 0.0
        nv[i] = sg.nv
    return SubgraphSlab(
        adj=adj, nv=nv, gids=np.array([sg.gid for sg in subs]), z=z,
        epoch=int(epoch),
    )


def to_device(array, device) -> torch.Tensor:
    """A host array as a tensor on ``device``.  Host→card copies go
    through pinned memory with ``non_blocking``, so they queue behind the
    card's work instead of waiting for it."""
    t = torch.as_tensor(array)
    device = torch.device(device)
    if device.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def place_slab(slab: SubgraphSlab, device="cuda") -> SubgraphSlab:
    """Stage a slab's adjacency on ``device`` ONCE (the resident copy
    ``pack_round`` gathers from every round thereafter).  The copy never
    aliases the host buffer.  Updates the slab in place and returns it."""
    slab.adj_dev = torch.from_numpy(slab.adj).to(device, copy=True)
    return slab


def gather_slab_rows(slab: SubgraphSlab, rows) -> torch.Tensor:
    """On-device [len(rows), z, z] adjacency gather from the resident
    copy — the zero-transfer replacement for the host row copy in
    ``SlabLayout.pack_round``."""
    idx = to_device(np.asarray(rows, dtype=np.int64), slab.adj_dev.device)
    return slab.adj_dev.index_select(0, idx)


def scatter_slab_cells(adj_dev: torch.Tensor, rows, uu, vv, ww):
    """Functionally patch cells of a device copy: returns a NEW tensor and
    never writes into ``adj_dev`` (in-flight queries of the previous
    epoch may still read it).  ``rows`` is -1-padded; padded entries are
    dropped.  ``ww`` holds the EFFECTIVE (min over parallel edges) new
    weights."""
    rows = np.asarray(rows, dtype=np.int64)
    keep = rows >= 0
    dev = adj_dev.device
    r = to_device(rows[keep], dev)
    u = to_device(np.asarray(uu, dtype=np.int64)[keep], dev)
    v = to_device(np.asarray(vv, dtype=np.int64)[keep], dev)
    w = to_device(np.asarray(ww, dtype=np.float32)[keep], dev)
    out = adj_dev.clone()
    out[r, u, v] = w
    return out


# ---------------------------------------------------------------------------
# grouped layout: problems co-located with their subgraph slab
# ---------------------------------------------------------------------------
def bf_step_grouped(dist, adj, spur_onehot, banned_next):
    """dist [S,J,z], adj [S,z,z], masks [S,J,z] bool → one relaxation.

    Yen's spur-row cut is applied without a [S,J,z,z] mask.  The banned
    edges all leave the (single) spur vertex, so:
        min over allowed u  =  min( min_{u≠spur} (d[u]+A[u,·]),
                                    d[spur]+A[spur,·] where not banned )
    """
    z = adj.shape[-1]
    d_no_spur = torch.where(spur_onehot, INF, dist)
    base = (d_no_spur[:, :, :, None] + adj[:, None, :, :]).amin(dim=2)
    d_spur = torch.where(spur_onehot, dist, INF).amin(dim=2)  # [S,J]
    spur_idx = spur_onehot.to(torch.uint8).argmax(dim=2)  # first set, 0 if none
    spur_row = adj.gather(1, spur_idx[:, :, None].expand(-1, -1, z))
    spur_part = torch.where(banned_next, INF, d_spur[:, :, None] + spur_row)
    has_spur = spur_onehot.any(dim=2, keepdim=True)
    spur_part = torch.where(has_spur, spur_part, INF)
    return torch.minimum(dist, torch.minimum(base, spur_part))


def bf_solve_grouped(
    adj, init_dist, banned_v=None, spur_onehot=None, banned_next=None,
    cap=None, max_iters: int | None = None,
):
    """Grouped masked BF: returns (dist [S,J,z], iters).

    Runs ``max_iters`` (default z) relaxations.  The change flag stays on
    the device and the host never reads it: once a relaxation decreases
    nothing it returns the same values again (cap-clamped values stay
    clamped), so the result equals the reference's early-exit loop bit
    for bit.  ``iters`` (an int32 device scalar) counts the relaxations
    that loop would have run."""
    S, J, z = init_dist.shape
    zeros = torch.zeros((S, J, z), dtype=torch.bool, device=init_dist.device)
    banned_v = zeros if banned_v is None else banned_v
    spur_onehot = zeros if spur_onehot is None else spur_onehot
    banned_next = zeros if banned_next is None else banned_next
    dist = torch.where(banned_v, INF, init_dist)
    iters = torch.zeros((), dtype=torch.int32, device=init_dist.device)
    active = torch.ones((), dtype=torch.bool, device=init_dist.device)
    for _ in range(z if max_iters is None else max_iters):
        new = bf_step_grouped(dist, adj, spur_onehot, banned_next)
        new = torch.where(banned_v, INF, new)
        if cap is not None:
            new = torch.where(new > cap[:, :, None], INF, new)
        iters += active
        active &= (new < dist).any()
        dist = new
    return dist, iters


def bf_parents_grouped(adj, dist, spur_onehot, banned_next):
    """Backpointers from a converged distance field: parent[s,j,v] =
    argmin_u d[u] + A[u,v] (first index of the min; the 0-diagonal is not
    a hop), with the spur row's allowed edges as a candidate that wins
    only on a strict <.  A parent is kept within a relative 1e-6 of
    ``dist``; -1 at sources and unreached vertices.  int32."""
    z = adj.shape[-1]
    eye = torch.eye(z, dtype=torch.bool, device=adj.device)
    adj_nd = torch.where(eye, INF, adj)
    d_no_spur = torch.where(spur_onehot, INF, dist)
    contrib = d_no_spur[:, :, :, None] + adj_nd[:, None, :, :]
    best_u = contrib.argmin(dim=2)  # [S,J,z]
    best_val = contrib.amin(dim=2)
    # spur-row candidate (allowed edges only)
    d_spur = torch.where(spur_onehot, dist, INF).amin(dim=2)
    spur_idx = spur_onehot.to(torch.uint8).argmax(dim=2)  # [S,J]
    spur_row = adj_nd.gather(1, spur_idx[:, :, None].expand(-1, -1, z))
    spur_part = torch.where(banned_next, INF, d_spur[:, :, None] + spur_row)
    has_spur = spur_onehot.any(dim=2, keepdim=True)
    spur_part = torch.where(has_spur, spur_part, INF)
    use_spur = spur_part < best_val
    best_u = torch.where(use_spur, spur_idx[:, :, None], best_u)
    best_val = torch.minimum(best_val, spur_part)
    tol = _REL_TOL * torch.clamp(dist.abs(), min=1.0)  # 0-dim: any device
    ok = (best_val - dist).abs() <= tol
    reached = dist < INF / 2
    src = dist <= 0.0
    return torch.where(ok & reached & ~src, best_u, -1).to(torch.int32)
