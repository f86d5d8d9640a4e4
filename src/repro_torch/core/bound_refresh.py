"""Exact boundary-pair distances: the lower bounds an index keeps once
its weights have moved.

Theorem 1's lower bound (``bounding.lower_bound_distances_vec``, mode
"paper") is D_u, the current length of the shortest stored
representative path, whenever D_u is at most the largest bound distance
of the pair's levels.  That is a lower bound only while each stored
representative is the shortest path of its vfrag level.  Once weights
drift, two paths of one level trade places, D_u passes the true
distance, and Theorem 3's stop fires before every answer is found.  On a
fresh build of integer weights every unit weight is 1, so D_u is the
exact distance and the build keeps the paper's bound.

After an update batch every subgraph the batch touched caps each pair's
bound at the pair's exact shortest distance inside the subgraph under
the new weights (``dtlp.capped_bounds``).  Theorem 1's bound stays where
it is sound, so the index and the answers stay those of the paper's
rule there, and the cap lowers it where it leaked.  All pairs of all
subgraphs are one Bellman–Ford in float64 over a row per (subgraph,
boundary source), in sparse half-edge form, on the index's device (a
card, or the CPU).  Each candidate is d[u] + w(u, v), so the
fixed point is, bit for bit, the least over paths of their length summed
from the source: what a Dijkstra from the pair's source gives.
"""

from __future__ import annotations

import numpy as np


class PairDistances:
    """Exact in-subgraph distance of every boundary pair of an index's
    subgraphs, as one flat float64 array in ``sub_indexes`` order
    (subgraph ``gid``'s pairs at ``ptr[gid]:ptr[gid + 1]``, aligned with
    its ``pairs``).  The topology is fixed, so the row layout is built
    once and each call ships only the weights."""

    def __init__(self, sub_indexes: list, device=None):
        import torch

        self.device = torch.device(device or "cpu")
        src, dst, eid, init, out = [], [], [], [], []
        ptr = [0]
        base = self.steps = 0
        for si in sub_indexes:
            sg = si.sg
            nv = sg.nv
            sources, row = np.unique(si.pairs[:, 0], return_inverse=True)
            off = base + nv * np.arange(sources.shape[0])[:, None]
            tail = np.repeat(np.arange(nv), np.diff(sg.indptr))
            src.append((off + tail).ravel())
            dst.append((off + sg.nbr).ravel())
            eid.append(np.tile(sg.eid, sources.shape[0]))
            init.append(off[:, 0] + sources)
            out.append(base + nv * row.ravel() + si.pairs[:, 1])
            ptr.append(ptr[-1] + si.pairs.shape[0])
            base += nv * sources.shape[0]
            self.steps = max(self.steps, nv - 1)
        self.size = base
        self.ptr = np.asarray(ptr, dtype=np.int64)

        def dev(parts):
            flat = np.concatenate(parts) if parts else np.empty(0)
            return torch.as_tensor(flat.astype(np.int64), device=self.device)

        self.src, self.dst, self.eid = dev(src), dev(dst), dev(eid)
        self.init, self.out = dev(init), dev(out)
        self.relaxations = 0  # of the last call

    def __call__(self, w: np.ndarray) -> np.ndarray:
        """Every pair's exact distance under edge weights ``w``."""
        import torch

        d = torch.full((self.size,), float("inf"), dtype=torch.float64,
                       device=self.device)
        d[self.init] = 0.0
        hw = torch.as_tensor(np.asarray(w, dtype=np.float64),
                             device=self.device)[self.eid]
        self.relaxations = 0
        # a simple path has at most nv - 1 edges, and no walk sums below
        # the path it contains: nv - 1 relaxations reach the fixed point
        for _ in range(self.steps):
            new = d.scatter_reduce(0, self.dst, d[self.src] + hw, "amin")
            self.relaxations += 1
            if torch.equal(new, d):
                break
            d = new
        return d[self.out].cpu().numpy()
