"""Carry the reference package's state into the port.

``repro`` has no model weights: its state is the road graph and the
packed subgraph slabs.  Both cross as plain numpy arrays, so this module
needs nothing of ``repro`` itself.

    g_port = graph_from_numpy({"n": g.n, "edge_u": g.edge_u,
                               "edge_v": g.edge_v, "w": g.w,
                               "directed": g.directed})
    slab = slab_from_numpy(ref_slab.adj, ref_slab.nv, ref_slab.gids,
                           ref_slab.z, ref_slab.epoch, device="cuda")
"""

from __future__ import annotations

import numpy as np

from .core.graph import Graph
from .engine.dense import SubgraphSlab, place_slab


def graph_from_numpy(arrays: dict) -> Graph:
    """The port's :class:`Graph` from ``{"n", "edge_u", "edge_v", "w",
    "directed"}`` — the arguments of the reference ``Graph`` (``w`` is
    taken as the weights at epoch 0)."""
    return Graph(
        int(arrays["n"]),
        np.asarray(arrays["edge_u"], dtype=np.int64),
        np.asarray(arrays["edge_v"], dtype=np.int64),
        np.asarray(arrays["w"], dtype=np.float64),
        directed=bool(arrays["directed"]),
    )


def slab_from_numpy(adj, nv, gids, z: int, epoch: int = 0,
                    device="cuda") -> SubgraphSlab:
    """A packed slab (``adj`` float32 [S, z, z], ``nv`` int32 [S],
    ``gids`` int64 [S]) placed on ``device``."""
    adj = np.ascontiguousarray(adj, dtype=np.float32)
    if adj.ndim != 3 or adj.shape[1:] != (int(z), int(z)):
        raise ValueError(f"adj must be [S, {z}, {z}], got {adj.shape}")
    slab = SubgraphSlab(
        adj=adj.copy(), nv=np.asarray(nv, dtype=np.int32).copy(),
        gids=np.asarray(gids, dtype=np.int64).copy(), z=int(z),
        epoch=int(epoch),
    )
    return place_slab(slab, device)
