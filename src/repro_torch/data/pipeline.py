"""Deterministic, restartable synthetic data pipelines for every family.

All pipelines are seeded + stateless-per-step (batch i is a pure function
of (seed, step)) so a restarted job resumes mid-epoch with zero drift —
the data-side half of fault tolerance.
"""

from __future__ import annotations

import dataclasses

import numpy as np


# ---------------------------------------------------------------------------
# LM token stream
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class TokenPipeline:
    """Markov-ish synthetic token stream (deterministic per (seed, step))."""

    vocab: int
    batch: int
    seq_len: int
    seed: int = 0

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng((self.seed, step))
        # zipf-distributed ids (realistic vocab skew), clipped to vocab
        toks = rng.zipf(1.3, size=(self.batch, self.seq_len)).astype(np.int64)
        toks = np.minimum(toks, self.vocab - 1).astype(np.int32)
        return {
            "tokens": toks,
            "loss_mask": np.ones((self.batch, self.seq_len), np.float32),
        }


# ---------------------------------------------------------------------------
# GNN graphs
# ---------------------------------------------------------------------------
def random_gnn_graph(n, m, d_feat, n_classes, seed=0, with_pos=False,
                     edge_feat_dim=0):
    """A connected random graph as a GNN batch (directed half-edges both ways)."""
    rng = np.random.default_rng(seed)
    src = np.concatenate([np.arange(n - 1), rng.integers(0, n, m)])
    dst = np.concatenate([np.arange(1, n), rng.integers(0, n, m)])
    keep = src != dst
    src, dst = src[keep], dst[keep]
    src2 = np.concatenate([src, dst]).astype(np.int32)
    dst2 = np.concatenate([dst, src]).astype(np.int32)
    batch = {
        "node_feat": rng.normal(size=(n, d_feat)).astype(np.float32),
        "edge_src": src2,
        "edge_dst": dst2,
        "labels": rng.integers(0, n_classes, n).astype(np.int32),
        "train_mask": (rng.random(n) < 0.7).astype(np.float32),
    }
    if with_pos:
        batch["positions"] = rng.normal(size=(n, 3)).astype(np.float32)
    if edge_feat_dim:
        batch["edge_feat"] = rng.normal(size=(src2.shape[0], edge_feat_dim)).astype(
            np.float32
        )
    return batch


def build_triplets(edge_src, edge_dst, max_triplets=None):
    """DimeNet triplet index lists: pairs (kj, ji) with k→j and j→i, k≠i."""
    E = edge_src.shape[0]
    by_dst: dict = {}
    for e in range(E):
        by_dst.setdefault(int(edge_dst[e]), []).append(e)
    t_kj, t_ji = [], []
    for ji in range(E):
        j = int(edge_src[ji])
        for kj in by_dst.get(j, []):
            if int(edge_src[kj]) != int(edge_dst[ji]):
                t_kj.append(kj)
                t_ji.append(ji)
                if max_triplets and len(t_kj) >= max_triplets:
                    break
        if max_triplets and len(t_kj) >= max_triplets:
            break
    if not t_kj:  # degenerate small graphs
        t_kj, t_ji = [0], [0]
    return np.array(t_kj, np.int32), np.array(t_ji, np.int32)


def molecule_batch(n_graphs, n_atoms, n_edges_per, n_species=32, seed=0):
    """Batched small molecules, flattened with graph_idx."""
    rng = np.random.default_rng(seed)
    srcs, dsts, gidx, species, pos = [], [], [], [], []
    for g in range(n_graphs):
        base = g * n_atoms
        s = rng.integers(0, n_atoms, n_edges_per)
        d = (s + 1 + rng.integers(0, n_atoms - 1, n_edges_per)) % n_atoms
        srcs.append(base + s)
        dsts.append(base + d)
        gidx.append(np.full(n_atoms, g))
        species.append(rng.integers(0, n_species, n_atoms))
        pos.append(rng.normal(size=(n_atoms, 3)))
    edge_src = np.concatenate(srcs).astype(np.int32)
    edge_dst = np.concatenate(dsts).astype(np.int32)
    t_kj, t_ji = build_triplets(edge_src, edge_dst)
    return {
        "species": np.concatenate(species).astype(np.int32),
        "positions": np.concatenate(pos).astype(np.float32),
        "edge_src": edge_src,
        "edge_dst": edge_dst,
        "graph_idx": np.concatenate(gidx).astype(np.int32),
        "t_kj": t_kj,
        "t_ji": t_ji,
        "labels": rng.normal(size=n_graphs).astype(np.float32),
    }


# ---------------------------------------------------------------------------
# GraphSAGE fanout neighbor sampler (a REAL sampler, not a stub)
# ---------------------------------------------------------------------------
class NeighborSampler:
    """Layered fanout sampling over a CSR graph (GraphSAGE §3.1 minibatch).

    sample(seeds) returns a flattened block graph: the union of sampled
    nodes (seeds first), edges pointing child→parent for aggregation, and
    the mapping back to global ids.
    """

    def __init__(self, indptr, nbr, fanouts, seed=0):
        self.indptr = indptr
        self.nbr = nbr
        self.fanouts = tuple(fanouts)
        self.rng = np.random.default_rng(seed)

    def sample(self, seeds: np.ndarray):
        seeds = np.asarray(seeds, dtype=np.int64)
        nodes = list(seeds)
        node_pos = {int(v): i for i, v in enumerate(seeds)}
        edge_src, edge_dst = [], []
        frontier = seeds
        for fanout in self.fanouts:
            nxt = []
            for v in frontier:
                lo, hi = self.indptr[v], self.indptr[v + 1]
                deg = hi - lo
                if deg == 0:
                    continue
                take = min(fanout, deg)
                picks = self.rng.choice(deg, size=take, replace=False)
                for p in picks:
                    u = int(self.nbr[lo + p])
                    if u not in node_pos:
                        node_pos[u] = len(nodes)
                        nodes.append(u)
                        nxt.append(u)
                    edge_src.append(node_pos[u])
                    edge_dst.append(node_pos[int(v)])
            frontier = np.array(nxt, dtype=np.int64) if nxt else np.empty(0, np.int64)
        return {
            "nodes": np.array(nodes, dtype=np.int64),
            "edge_src": np.array(edge_src, dtype=np.int32),
            "edge_dst": np.array(edge_dst, dtype=np.int32),
            "n_seeds": len(seeds),
        }


# ---------------------------------------------------------------------------
# recsys click stream
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class ClickStream:
    n_items: int
    n_profile: int
    seq_len: int
    batch: int
    bag_nnz: int
    n_dense: int
    seed: int = 0

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng((self.seed, step))
        B = self.batch
        hist = np.minimum(
            rng.zipf(1.2, size=(B, self.seq_len)), self.n_items - 1
        ).astype(np.int32)
        target = np.minimum(rng.zipf(1.2, size=B), self.n_items - 1).astype(
            np.int32
        )
        bag_ids = np.minimum(
            rng.zipf(1.5, size=B * self.bag_nnz), self.n_profile - 1
        ).astype(np.int32)
        bag_seg = np.repeat(np.arange(B, dtype=np.int32), self.bag_nnz)
        return {
            "hist": hist,
            "target": target,
            "bag_ids": bag_ids,
            "bag_seg": bag_seg,
            "dense": rng.normal(size=(B, self.n_dense)).astype(np.float32),
            "labels": (rng.random(B) < 0.2).astype(np.float32),
        }
