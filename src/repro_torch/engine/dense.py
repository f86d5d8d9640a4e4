"""Batched dense min-plus relaxation over padded subgraphs, in PyTorch.

The paper's hot loop — Dijkstra inside Yen's spur-path computation — is
pointer-chasing and priority queues.  Here it becomes:

  * subgraphs → padded dense [S, z, z] adjacency slabs (min-plus semiring)
  * one Yen iteration's deviation vertices → ONE batch of masked
    multi-source Bellman–Ford problems, grouped by owning subgraph as
    [S, J, z] against adj [S, z, z] (zero gather)
  * early termination → distance-cap clamping inside the relaxation

The functions here are the plain PyTorch versions (any device); the
Hopper kernels of the same solves (``kernels/``) are held to them, bit
for bit where only min, compare and add are involved.  ``pack_subgraphs``
produces the same bytes as the reference package's.
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
    creates it: one tensor, or a :class:`ShardedMirror` over a mesh's
    shards): the per-round dispatch gathers adjacency rows from it on
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
    adj_dev: torch.Tensor | ShardedMirror | None = None  # [S_dev, z, z]

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


@dataclasses.dataclass(frozen=True)
class ShardedMirror:
    """A slab's device copy split by rows over a mesh's shards:
    ``parts[i]`` holds rows [i·rows, (i+1)·rows) of the padded slab on
    shard i's device (one device may hold several parts).  Patched
    functionally, as a plain copy is: an update makes new parts where it
    writes and shares the others."""

    parts: tuple

    @property
    def rows(self) -> int:
        return int(self.parts[0].shape[0])

    @property
    def device(self) -> torch.device:
        """The first shard's device, where gathers land."""
        return self.parts[0].device

    @property
    def shape(self) -> tuple:
        return (self.rows * len(self.parts),) + tuple(self.parts[0].shape[1:])

    def full(self) -> torch.Tensor:
        """The whole padded slab as one tensor on :attr:`device`."""
        return torch.cat([p.to(self.device) for p in self.parts])


def place_slab(slab: SubgraphSlab, device="cuda", shards=None,
               s_multiple: int = 1) -> SubgraphSlab:
    """Stage a slab's adjacency on ``device`` ONCE (the resident copy
    ``pack_round`` gathers from every round thereafter).  The copy never
    aliases the host buffer.

    ``shards`` (a mesh's devices, one per shard) splits the copy by rows
    over them as a :class:`ShardedMirror`; a single shard keeps one
    tensor on its device.  S is padded up to a multiple of ``s_multiple``
    (the mesh's shard count) with copies of row 0, so the rows divide
    evenly, as the round buckets do — filler rows are never gathered and
    never patched.  Updates the slab in place and returns it."""
    S = slab.adj.shape[0]
    s_multiple = max(1, int(s_multiple))
    S_dev = -(-S // s_multiple) * s_multiple
    buf = slab.adj
    if S_dev != S:
        buf = np.concatenate(
            [slab.adj, np.repeat(slab.adj[:1], S_dev - S, axis=0)], axis=0)
    if shards is None or len(shards) == 1:
        dev = device if shards is None else shards[0]
        slab.adj_dev = torch.from_numpy(buf).to(dev, copy=True)
        return slab
    if S_dev % len(shards):
        raise ValueError(f"{S_dev} slab rows do not split over "
                         f"{len(shards)} shards (s_multiple={s_multiple})")
    rows = S_dev // len(shards)
    slab.adj_dev = ShardedMirror(tuple(
        torch.from_numpy(buf[i * rows:(i + 1) * rows]).to(d, copy=True)
        for i, d in enumerate(shards)))
    return slab


def gather_slab_rows(slab: SubgraphSlab, rows) -> torch.Tensor:
    """On-device [len(rows), z, z] adjacency gather from the resident
    copy — the zero-transfer replacement for the host row copy in
    ``SlabLayout.pack_round``.  From a :class:`ShardedMirror` each shard
    gives the rows it holds, gathered on the first shard's device."""
    rows = np.asarray(rows, dtype=np.int64)
    mirror = slab.adj_dev
    if not isinstance(mirror, ShardedMirror):
        return mirror.index_select(0, to_device(rows, mirror.device))
    home = mirror.device
    out = torch.empty((rows.shape[0],) + mirror.shape[1:],
                      dtype=mirror.parts[0].dtype, device=home)
    for i, part in enumerate(mirror.parts):
        local = rows - i * mirror.rows
        pick = np.nonzero((local >= 0) & (local < mirror.rows))[0]
        if pick.size:
            got = part.index_select(0, to_device(local[pick], part.device))
            out[to_device(pick, home)] = got.to(home)
    return out


def scatter_slab_cells(adj_dev, rows, uu, vv, ww, update_fn=None):
    """Functionally patch cells of a device copy: returns a NEW copy and
    never writes into ``adj_dev`` (in-flight queries of the previous
    epoch may still read it).  ``rows`` is -1-padded; padded entries are
    dropped.  ``ww`` holds the EFFECTIVE (min over parallel edges) new
    weights.  ``update_fn`` (a ``shard_refine.make_update_fn`` product)
    routes the scatter through the mesh path, where each shard applies
    the rows it holds; default is the single-device form."""
    if update_fn is not None:
        return update_fn(adj_dev, rows, uu, vv, ww)
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


# ---------------------------------------------------------------------------
# flat layout: one problem per adjacency row (the grouped layout at J=1)
# ---------------------------------------------------------------------------
def _one_problem(m):
    return None if m is None else m[:, None]


def bf_step(dist, adj, spur_onehot, banned_next):
    """One min-plus relaxation of P independent problems: dist [P,z],
    adj [P,z,z], spur_onehot/banned_next [P,z] bool → [P,z].  The grouped
    step with one problem per row (the same arithmetic per element)."""
    return bf_step_grouped(dist[:, None], adj, spur_onehot[:, None],
                           banned_next[:, None])[:, 0]


def bf_solve(adj, init_dist, banned_v=None, spur_onehot=None,
             banned_next=None, cap=None, max_iters: int | None = None):
    """Converged multi-source distances [P,z] and the iteration count
    (an int32 device scalar): :func:`bf_solve_grouped` at J=1, so cap is
    [P] and ``max_iters`` defaults to z."""
    dist, iters = bf_solve_grouped(
        adj, init_dist[:, None], _one_problem(banned_v),
        _one_problem(spur_onehot), _one_problem(banned_next),
        cap=_one_problem(cap), max_iters=max_iters)
    return dist[:, 0], iters


def bf_parents(adj, dist, spur_onehot, banned_next):
    """Backpointers [P,z] int32 of a converged flat distance field
    (:func:`bf_parents_grouped` at J=1)."""
    return bf_parents_grouped(adj, dist[:, None], spur_onehot[:, None],
                              banned_next[:, None])[:, 0]


# ---------------------------------------------------------------------------
# k-tropical relaxation: k distinct smallest walk distances
# ---------------------------------------------------------------------------
def ktrop_step(D, adj, distinct: bool = True):
    """D [P,k,z] ascending per (p,:,v) → one relaxation round [P,k,z].

    Per v: sort D[:,v] with every one-step extension D[j,u]+A[u,v], and
    (``distinct``) mask each value equal to its predecessor as INF and
    sort again; keep the k smallest.  With ``distinct`` the result is the
    k smallest distinct values below INF, padded with INF (a value
    overflowing to +inf is never among them)."""
    P, k, z = D.shape
    cand = D[:, :, :, None] + adj[:, None, :, :]  # [P,k,z,z]
    cand = cand.permute(0, 3, 1, 2).reshape(P, z, k * z)
    allv = torch.cat([D.transpose(1, 2), cand], dim=-1).sort(dim=-1).values
    if distinct:
        dup = torch.zeros_like(allv, dtype=torch.bool)
        dup[..., 1:] = allv[..., 1:] == allv[..., :-1]
        allv = torch.where(dup, INF, allv).sort(dim=-1).values
    return allv[..., :k].transpose(1, 2).contiguous()


def ktrop_solve_iters(adj, src, k: int, max_iters: int | None = None,
                      distinct: bool = True):
    """:func:`ktrop_solve` and, per row, the relaxations it ran (int32
    [P]: up to and including the first that decreased nothing in the
    row, at most ``max_iters``).  A relaxation keeps D's own levels, so
    no value grows; one that decreases nothing returns D again.  The
    loop therefore stops once every row has stopped (one host read per
    relaxation: this plain version is off the serving path), and its
    result equals the reference's global early-exit loop bit for bit."""
    P, z, _ = adj.shape
    D = torch.full((P, k, z), INF, dtype=torch.float32, device=adj.device)
    D[torch.arange(P, device=adj.device), 0, src.long()] = 0.0
    iters = torch.zeros(P, dtype=torch.int32, device=adj.device)
    active = torch.ones(P, dtype=torch.bool, device=adj.device)
    for _ in range(z * k + 8 if max_iters is None else max_iters):
        new = ktrop_step(D, adj, distinct)
        iters += active
        active &= (new < D).flatten(1).any(dim=1)
        D = new
        if not bool(active.any()):
            break
    return D, iters


def ktrop_solve(adj, src, k: int, max_iters: int | None = None,
                distinct: bool = True):
    """k distinct smallest walk distances from src to every vertex.

    adj [P,z,z]; src int [P] → D [P,k,z] ascending (INF padded);
    ``max_iters`` defaults to z·k+8, as in the reference."""
    return ktrop_solve_iters(adj, src, k, max_iters, distinct)[0]


# ---------------------------------------------------------------------------
# bound distances: BD(φ) = sum of the φ smallest unit weights
# ---------------------------------------------------------------------------
def sort_profile(unit_w, unit_n):
    """The ascending unit-weight profile: (w_sorted, n_sorted, cum_n),
    sorted along the last axis (stable, as ``jnp.argsort``), with
    cum_n the running fragment count.  Padding (w = INF, n = 0) sorts
    last and adds no fragments."""
    w_sorted, order = torch.sort(unit_w, dim=-1, stable=True)
    n_sorted = unit_n.gather(-1, order)
    return w_sorted, n_sorted, n_sorted.cumsum(dim=-1)


def bound_dist(unit_w, unit_n, phi):
    """BD over one subgraph's profile: unit_w [E] unit weights (INF
    pad), unit_n [E] vfrag counts, phi [B] fragment counts → [B]
    (:func:`bound_dist_batch` with every path on that subgraph)."""
    sub = torch.zeros(phi.shape[0], dtype=torch.long, device=phi.device)
    return bound_dist_batch(unit_w[None], unit_n[None], sub, phi)


def bound_dist_batch(unit_w, unit_n, sub_of_path, phi):
    """Vectorized BD for a batch of bounding paths: unit_w/unit_n [S,E],
    sub_of_path [B] int, phi [B] → [B].  Sort + weighted prefix sums +
    searchsorted over a [B,E] prefix row gathered per path, as the
    reference: BD = prev_w + (φ - prev_n)·w[i] at the block i holding
    the φ-th fragment."""
    w_sorted, n_sorted, cum_n = sort_profile(unit_w, unit_n)
    cum_w = (n_sorted * w_sorted).cumsum(dim=-1)
    sub = sub_of_path.long()
    cn, cw, ws = cum_n[sub], cum_w[sub], w_sorted[sub]
    i = torch.searchsorted(cn, phi[:, None].contiguous(), side="left")
    i = i.clamp(0, cn.shape[-1] - 1)
    prev = (i - 1).clamp(min=0)
    prev_n = torch.where(i > 0, cn.gather(1, prev), 0.0)[:, 0]
    prev_w = torch.where(i > 0, cw.gather(1, prev), 0.0)[:, 0]
    return prev_w + (phi - prev_n) * ws.gather(1, i)[:, 0]
