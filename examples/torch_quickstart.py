"""Quickstart on the PyTorch port: build a dynamic road network, index it
with DTLP, answer KSP queries exactly, update weights, query again, then
serve the same queries through the ``cuda_bf`` engine on the card.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""

import argparse

import numpy as np

from repro_torch.core.dtlp import DTLP
from repro_torch.core.kspdg import ksp_dg
from repro_torch.core.sssp import graph_view
from repro_torch.core.yen import ksp
from repro_torch.data.roadnet import WeightUpdateStream, grid_road_network
from repro_torch.service import KSPService, ServiceConfig

ap = argparse.ArgumentParser()
ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                help="where the cuda_bf engine runs (no fallback)")
args = ap.parse_args()

# 1. a road-like dynamic graph (grid + diagonal shortcuts, travel-time
#    weights) — stands in for the DIMACS networks
g = grid_road_network(14, 14, seed=0)
print(f"graph: {g.n} vertices / {g.m} edges")

# 2. the DTLP index: BFS partition (z≤24), ξ=6 bounding paths per
#    boundary pair, MinHash/LSH-compacted G-MPTree storage
d = DTLP.build(g, z=24, xi=6)
s = d.stats
print(
    f"DTLP: {d.partition.n_subgraphs} subgraphs, skeleton |V|={d.skeleton.n}, "
    f"{s.n_paths} bounding paths, built in {s.total_s:.2f}s"
)
print(
    f"storage: EBP-II {s.ebp_slots} slots → G-MPTree {s.mptree_slots} slots "
    f"({s.ebp_slots / s.mptree_slots:.2f}x compaction)"
)

# 3. KSP queries (exact — verified against Yen on the full graph)
rng = np.random.default_rng(1)
pairs = [tuple(map(int, rng.choice(g.n, size=2, replace=False)))
         for _ in range(3)]
for src, dst in pairs:
    paths, stats = ksp_dg(d, src, dst, k=3, return_stats=True)
    oracle = ksp(graph_view(g), src, dst, 3)
    assert [round(p, 6) for p, _ in paths] == [round(p, 6) for p, _ in oracle]
    print(f"q({src},{dst}) k=3 → dists {[round(float(p), 1) for p, _ in paths]} "
          f"({stats.iterations} filter-refine iterations)")

# 4. traffic changes: α=40% of edges shift by up to ±50%
stream = WeightUpdateStream(g, alpha=0.4, tau=0.5, seed=2)
eids, new_w = stream.next_batch()
dt = d.apply_updates(eids, new_w)
print(f"applied {len(eids)} weight updates; index maintained in {dt*1e3:.1f}ms "
      "(bounding paths unchanged — only bounds refreshed)")

src, dst = 5, g.n - 3
paths = ksp_dg(d, src, dst, k=3)
oracle = ksp(graph_view(g), src, dst, 3)
assert [round(p, 6) for p, _ in paths] == [round(p, 6) for p, _ in oracle]
print(f"post-update q({src},{dst}) still exact: "
      f"{[round(float(p), 1) for p, _ in paths]}")

# 5. the same queries served by the grouped Bellman–Ford kernel engine
svc = KSPService(d, ServiceConfig(engine="cuda_bf", n_workers=4,
                                  device=args.device))
for src, dst in pairs + [(5, g.n - 3)]:
    res = svc.query(src, dst, 3)
    oracle = ksp(graph_view(g), src, dst, 3)
    # the slab solves add in float32: exact up to its rounding
    np.testing.assert_allclose([p for p, _ in res.paths],
                               [p for p, _ in oracle], rtol=1e-5)
print(f"cuda_bf on {args.device} serves the same answers at epoch {svc.epoch}")
print("quickstart OK")
