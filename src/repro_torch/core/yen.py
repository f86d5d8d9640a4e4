"""K shortest loopless paths: Yen, Para-Yen, PYen, FindKSP (Sections 5.3, 6.5).

All four share Yen's deviation paradigm; they differ in how spur paths
are computed:

* ``yen``       — classic Yen: one Dijkstra per deviation vertex. [6]
* ``para_yen``  — Yen with the spur searches submitted to a thread pool
                  (Para-Yen [28]); results identical to ``yen``.
* ``pyen``      — the paper's Progressive Yen: (1) deviation paths of one
                  iteration computed as a batch (thread pool here; the TPU
                  engine lowers the whole batch to ONE dense Bellman–Ford,
                  see repro/engine), (2) A_D/A_P reuse of shortest paths
                  consistent with the unmasked subgraph, (3) early
                  termination via the (k−i)-th deviation-distance cap.
* ``findksp``   — SPT-guided baseline in the spirit of FindKSP [5]/Feng
                  [29]: one reverse SPT per query used as an admissible A*
                  heuristic for every spur search.

Paths are returned as tuples of vertex ids, ascending by distance.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .sssp import INF, CSRView, dijkstra, extract_path, reverse_spt


def _path_dist_prefix(view: CSRView, path):
    """Prefix distances along ``path`` using current view weights."""
    pre = [0.0]
    for a, b in zip(path, path[1:]):
        lo, hi = view.indptr[a], view.indptr[a + 1]
        seg = view.nbr[lo:hi]
        hits = np.nonzero(seg == b)[0]
        w = float(np.min(view.hw[lo:hi][hits]))
        pre.append(pre[-1] + w)
    return pre


def _spur_job(view, spur, dst, banned_v, banned_e, cap, heuristic, reuse):
    dist, parent, best = dijkstra(
        view,
        spur,
        dst,
        banned_vertices=banned_v,
        banned_edges=banned_e,
        cap=cap,
        heuristic=heuristic,
        reuse=reuse,
    )
    if best >= INF:
        return None
    return best, extract_path(parent, spur, dst)


def ksp(
    view: CSRView,
    src: int,
    dst: int,
    k: int,
    *,
    directed: bool = False,
    mode: str = "yen",
    pool: ThreadPoolExecutor | None = None,
    max_pool_workers: int = 4,
) -> list[tuple[float, tuple]]:
    """K shortest simple paths from src to dst; [(dist, path), ...]."""
    out = []
    for item in ksp_stream(
        view,
        src,
        dst,
        k=k,
        directed=directed,
        mode=mode,
        pool=pool,
        max_pool_workers=max_pool_workers,
    ):
        out.append(item)
        if len(out) >= k:
            break
    return out


def ksp_stream(
    view: CSRView,
    src: int,
    dst: int,
    k: int | None = None,
    *,
    directed: bool = False,
    mode: str = "yen",
    pool: ThreadPoolExecutor | None = None,
    max_pool_workers: int = 4,
):
    """Lazily yield (dist, path) in ascending order.

    ``k=None`` streams until exhaustion (PYen's cap pruning needs a
    finite k and is disabled in that case).
    """
    if mode not in ("yen", "para_yen", "pyen", "findksp"):
        raise ValueError(mode)
    if src == dst:
        yield (0.0, (src,))
        return

    heuristic = None
    a_d = a_p = None
    if mode == "findksp":
        a_d, a_p = reverse_spt(view, dst, directed)
        heuristic = lambda v: a_d[v] if a_d[v] < INF else 0.0  # noqa: E731
    if mode == "pyen":
        # A_D/A_P: exact dist/next-hop to dst in the UNMASKED subgraph —
        # entries are by construction "consistent with the original
        # subgraph" (Section 5.3.2) and valid across all iterations.
        a_d, a_p = reverse_spt(view, dst, directed)

    dist0, parent0, best0 = dijkstra(view, src, dst, heuristic=heuristic)
    if best0 >= INF:
        return
    p1 = extract_path(parent0, src, dst)
    found: list[tuple[float, tuple]] = [(best0, tuple(p1))]
    found_set = {tuple(p1)}
    cand: list[tuple[float, tuple]] = []
    cand_set = set()
    yield found[0]

    own_pool = None
    if mode in ("para_yen", "pyen") and pool is None:
        own_pool = pool = ThreadPoolExecutor(max_workers=max_pool_workers)

    try:
        while k is None or len(found) < k:
            prev_dist, prev = found[-1]
            pre = _path_dist_prefix(view, prev)
            jobs = []
            for l in range(len(prev) - 1):
                spur = prev[l]
                root = prev[: l + 1]
                # classic Yen bans: next-edges of already-FOUND paths that
                # share this root (candidates are deduped, not banned).
                banned_e = set()
                for fd, fp in found:
                    if len(fp) > l and fp[: l + 1] == root:
                        banned_e.add((fp[l], fp[l + 1]))
                banned_v = np.zeros(view.n, dtype=bool)
                for v in root[:-1]:
                    banned_v[v] = True

                cap = INF
                if mode == "pyen" and k is not None:
                    # early termination: only (k - len(found)) more paths are
                    # needed; the (k-i)-th best candidate distance prunes.
                    need = k - len(found)
                    if len(cand) >= need:
                        cap = cand[need - 1][0] - pre[l]
                r = None
                if mode == "pyen":
                    root_set = set(root[:-1])

                    def valid_fn(u, tree_set, _rs=root_set, _be=banned_e):
                        """Cached suffix u→dst usable iff it avoids banned
                        vertices/edges AND the in-progress tree path."""
                        v = u
                        while v != dst:
                            nxt = int(a_p[v])
                            if nxt < 0:
                                return False
                            if nxt in _rs or nxt in tree_set:
                                return False
                            if (v, nxt) in _be:
                                return False
                            v = nxt
                        return True

                    r = (a_d, a_p, valid_fn)
                jobs.append((l, spur, banned_v, banned_e, cap, r))

            def run(job):
                l, spur, bv, be, cap, r = job
                out = _spur_job(view, spur, dst, bv, be, cap, heuristic, r)
                return l, out

            if pool is not None:
                results = list(pool.map(run, jobs))
            else:
                results = [run(j) for j in jobs]

            for l, out in results:
                if out is None:
                    continue
                spur_dist, spur_path = out
                total = pre[l] + spur_dist
                full = tuple(prev[:l]) + tuple(spur_path)
                if full in found_set or full in cand_set:
                    continue
                if len(set(full)) != len(full):
                    continue  # defensive loop guard
                cand_set.add(full)
                cand.append((total, full))
            if not cand:
                break
            cand.sort(key=lambda x: (x[0], x[1]))
            if mode == "pyen" and k is not None:
                keep = max(k - len(found), 1)
                for d_, p_ in cand[keep:]:
                    cand_set.discard(p_)
                cand = cand[:keep]
            best = cand.pop(0)
            cand_set.discard(best[1])
            found.append(best)
            found_set.add(best[1])
            yield best
    finally:
        if own_pool is not None:
            own_pool.shutdown(wait=False)
