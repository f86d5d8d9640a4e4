"""The bounding stage of the DTLP build as one batched pass on a device.

The host build (``dtlp.source_paths``) runs, per boundary source, the
ξ-distinct walk DP (``bounding.kdistinct_walk_dp``) and then one greedy
backward walk per (target, level) (``bounding.extract_level_path``).  Here
every boundary source of every subgraph is one row of a slab:

1. the DP of all rows in one ``ops.ktrop_solve`` launch, over a dense
   adjacency of vfrag counts built on the device by indexing a
   ``[subgraphs, z, z]`` slab with each row's subgraph;
2. the host reads the levels back and lists the walks, in the host's
   order (source, target, level);
3. every walk in one ``ops.level_walks`` launch, which follows the host's
   rule step for step and gives each step's edge id by
   ``dtlp._path_edge_ids``'s rule (the first CSR half-edge u->v);
4. the walks come back as two flat arrays and are cut into the blocks
   ``dtlp.source_paths`` returns, so ``dtlp.finish_subgraph_index``
   assembles the same index, bit for bit.

Levels are sums of integer vfrag counts, exact in f32 below 2^24, so the
host's 1e-9 tolerances are equalities on the card.  A source takes the
host path instead in two cases, both decided from the input: its
subgraph has two half-edges u->v of different weights (no dense matrix
holds both), or its DP ran past the host's cap of nv·ξ+8 relaxations
(the solve's per-row ``iters``).  Anything else the batch cannot hold
raises: values that could reach 2^24, edge ids past int32, and (in the
kernels' launchers) widths over the kernels' limits.  On a CPU device the
same pass runs the kernels' plain versions (the tests' route);
``DTLP.build`` takes it only for a card.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels import ops

#: integers below it are exact in f32
F32_EXACT = 2 ** 24


def _dense_ok(sg, vf_hw: np.ndarray) -> bool:
    """False where two half-edges u->v carry different weights."""
    nv = sg.nv
    src_of = np.repeat(np.arange(nv), np.diff(sg.indptr))
    key = src_of * nv + sg.nbr
    order = np.argsort(key, kind="stable")
    same = key[order][1:] == key[order][:-1]
    return bool(np.all(vf_hw[order][1:][same] == vf_hw[order][:-1][same]))


def _in_edges(sg, vf_hw: np.ndarray, z: int):
    """Subgraph ``sg``'s in-edges in ascending half-edge order per target:
    (in-degree [z], source [H], weight [H], edge id by the first-CSR-hit
    rule [H])."""
    nv = sg.nv
    src_of = np.repeat(np.arange(nv), np.diff(sg.indptr))
    order = np.argsort(sg.nbr, kind="stable")
    _, first, inv = np.unique(src_of * nv + sg.nbr, return_index=True,
                              return_inverse=True)
    eid_first = sg.eid[first[inv.reshape(-1)]]
    deg = np.bincount(sg.nbr, minlength=z)
    return deg, src_of[order], vf_hw[order], eid_first[order]


def source_paths_batched(graph, subgraphs: list, xi: int, device, stats,
                         max_iter: int | None = None) -> list:
    """Per subgraph, per boundary source, the block ``dtlp.source_paths``
    would return, or None where the source takes the host path.  Adds to
    ``stats`` (a ``dtlp.BuildStats``) the sources batched
    (``device_sources``), the Nones (``host_sources``), the walks the
    kernel rebuilt (``device_walks``) and the simple ones among them
    (``simple_walks``).  ``max_iter`` is a test seam: it replaces every
    subgraph's DP cap of nv·ξ+8, so that a test can make rows hit it.

    Raises ValueError where f32 or int32 cannot hold the batch exactly;
    the kernels' launchers raise where a width is over their limits."""
    dev = torch.device(device)
    vf = [graph.vfrag[sg.eid].astype(np.float64) for sg in subgraphs]
    nb = [int(sg.boundary_local.shape[0]) for sg in subgraphs]
    blocks = [[None] * n for n in nb]
    z = max((sg.nv for sg in subgraphs), default=0)
    caps = [(sg.nv * xi + 8) if max_iter is None else int(max_iter)
            for sg in subgraphs]
    max_iters = max(caps, default=0) + 1  # one over: a capped row shows
    on = [nb[i] > 0 and _dense_ok(sg, vf[i])
          for i, sg in enumerate(subgraphs)]
    # every DP value is a walk of at most max_iters + 1 edges
    top = max((float(vf[i].max(initial=0.0)) for i in range(len(on))
               if on[i]), default=0.0)
    if top * (max_iters + 1) >= F32_EXACT:
        raise ValueError(
            f"the batched bounding pass keeps levels in f32: a vfrag of "
            f"{top:g} over walks of up to {max_iters + 1} edges can reach "
            f"2^24, past f32's exact integers")
    if graph.m >= 2 ** 31:
        raise ValueError(f"the batched bounding pass keeps edge ids in "
                         f"int32: the graph has {graph.m} edges")
    dsub = [i for i in range(len(subgraphs)) if on[i]]
    stats.host_sources += sum(n for i, n in enumerate(nb) if not on[i])
    if not dsub:
        return blocks

    # ---- rows: every boundary source of the batched subgraphs
    row_g = np.repeat(np.arange(len(dsub)), [nb[i] for i in dsub])
    row_src = np.concatenate([subgraphs[i].boundary_local for i in dsub])
    row_cap = np.repeat([caps[i] for i in dsub], [nb[i] for i in dsub])
    row_max_len = np.repeat([subgraphs[i].nv + xi + 2 for i in dsub],
                            [nb[i] for i in dsub])
    S = row_g.shape[0]

    # ---- the level DP: one dense slab per subgraph, indexed per row
    gi, ui, vi, wi = [], [], [], []
    for j, i in enumerate(dsub):
        sg = subgraphs[i]
        gi.append(np.full(sg.nbr.shape[0], j))
        ui.append(np.repeat(np.arange(sg.nv), np.diff(sg.indptr)))
        vi.append(sg.nbr)
        wi.append(vf[i])
    slab = torch.full((len(dsub), z, z), ops.INF, dtype=torch.float32,
                      device=dev)
    slab[tuple(torch.from_numpy(np.concatenate(a).astype(np.int64)).to(dev)
               for a in (gi, ui, vi))] = torch.from_numpy(
        np.concatenate(wi).astype(np.float32)).to(dev)
    row_g_d = torch.from_numpy(row_g.astype(np.int32)).to(dev)
    row_src_d = torch.from_numpy(row_src.astype(np.int32)).to(dev)
    D, iters = ops.ktrop_solve(slab[row_g_d.long()], row_src_d, xi,
                               max_iters=max_iters, with_iters=True)
    del slab
    row_ok = iters.cpu().numpy() <= row_cap
    Dh = D.cpu().numpy()

    # ---- the walks, in the host's order: source, target, level
    row_lo = np.concatenate([[0], np.cumsum([nb[i] for i in dsub])])
    walk_row, walk_dst, walk_level, pair_parts = [], [], [], []
    for j, i in enumerate(dsub):
        sg = subgraphs[i]
        B = sg.boundary_local
        r0, r1 = row_lo[j], row_lo[j + 1]
        Db = Dh[r0:r1][:, :, B]  # [source, level, target]
        tgt = (~np.eye(nb[i], dtype=bool) if graph.directed
               else np.triu(np.ones((nb[i], nb[i]), dtype=bool), 1))
        valid = ((Db < ops.INF).transpose(0, 2, 1) & tgt[:, :, None]
                 & row_ok[r0:r1, None, None])  # [source, target, level]
        a, t, lv = np.nonzero(valid)
        walk_row.append(r0 + a)
        walk_dst.append(B[t])
        walk_level.append(Db[a, lv, t])
        pa, pt = np.nonzero(valid.any(axis=2))
        pair_parts.append((pa, B[pa], B[pt], valid.sum(axis=2)[pa, pt]))
    walk_row = np.concatenate(walk_row)
    W = walk_row.shape[0]
    walk_ptr = np.zeros(S + 1, dtype=np.int64)
    np.cumsum(np.bincount(walk_row, minlength=S), out=walk_ptr[1:])

    # ---- every walk in one launch, then the simple ones back as flat runs
    tables = [_in_edges(subgraphs[i], vf[i], z) for i in dsub]
    ptr = np.zeros((len(dsub), z + 1), dtype=np.int64)
    ptr[:, 1:] = np.cumsum([deg for deg, *_ in tables], axis=1)
    ptr += np.concatenate(
        [[0], np.cumsum([src.shape[0] for _, src, _, _ in tables])[:-1]]
    )[:, None]

    def put(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(dev)

    verts, eids, length = ops.level_walks(
        D, row_g_d, row_src_d, put(row_max_len, np.int32),
        put(ptr, np.int32),
        put(np.concatenate([src for _, src, _, _ in tables]), np.int32),
        put(np.concatenate([w for _, _, w, _ in tables]), np.float32),
        put(np.concatenate([e for _, _, _, e in tables]), np.int32),
        put(walk_ptr, np.int32), put(np.concatenate(walk_dst), np.int32),
        put(np.concatenate(walk_level), np.float32))
    col = torch.arange(z, device=dev)
    length = length.long()
    flat_v = verts[col < length[:, None]].cpu().numpy().astype(np.int64)
    flat_e = eids[col < (length - 1)[:, None]].cpu().numpy().astype(np.int64)
    length = length.cpu().numpy()
    stats.device_walks += W
    stats.simple_walks += int(np.count_nonzero(length))

    path_v: list = [None] * W
    path_e: list = [None] * W
    simple = np.nonzero(length)[0]
    cuts_v = np.cumsum(length[simple])[:-1]
    cuts_e = np.cumsum(length[simple] - 1)[:-1]
    for w, pv, pe in zip(simple.tolist(), np.split(flat_v, cuts_v),
                         np.split(flat_e, cuts_e)):
        path_v[w] = pv.tolist()
        path_e[w] = pe
    phi = np.concatenate(walk_level).astype(np.int64).tolist()

    # ---- cut into per-source blocks
    for j, i in enumerate(dsub):
        r0 = row_lo[j]
        pa, ps, pt, pc = pair_parts[j]
        pair_cut = np.searchsorted(pa, np.arange(nb[i] + 1))
        for a in range(nb[i]):
            if not row_ok[r0 + a]:
                stats.host_sources += 1
                continue
            stats.device_sources += 1
            p0, p1 = pair_cut[a], pair_cut[a + 1]
            w0, w1 = walk_ptr[r0 + a], walk_ptr[r0 + a + 1]
            blocks[i][a] = (list(zip(ps[p0:p1].tolist(), pt[p0:p1].tolist())),
                            pc[p0:p1].tolist(), phi[w0:w1], path_v[w0:w1],
                            path_e[w0:w1])
    return blocks
