"""End-to-end driver on the PyTorch port (the paper's kind: SERVING
batched requests): a KSPService on the ``cuda_bf`` engine answers
concurrent KSP queries over a dynamic road network while weights stream
in, a worker dies mid-run and is later revived (re-syncing the update
batches it missed), an elastic rescale adds capacity, and a checkpoint
round-trips — all queries stay exact and every answer names the graph
epoch that served it.

    PYTHONPATH=src python examples/torch_serve_ksp_cluster.py [--device cpu]
"""

import argparse

import numpy as np

from repro_torch.core.sssp import graph_view
from repro_torch.core.yen import ksp
from repro_torch.data.roadnet import WeightUpdateStream, grid_road_network
from repro_torch.service import (KSPService, QueryRequest, ServiceConfig,
                                 UpdateBatch)

ap = argparse.ArgumentParser()
ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                help="where the workers' slabs live and solve (no fallback)")
args = ap.parse_args()


def config(n_workers):
    return ServiceConfig(engine="cuda_bf", n_workers=n_workers, z=20, xi=5,
                         device=args.device)


g = grid_road_network(12, 12, seed=3)
svc = KSPService.build(g, config(6))
res = svc.query(3, g.n - 2, k=3)          # exact [(dist, path), ...]
print(f"k=3 answer at epoch {res.epoch}: best {res.paths[0][0]:.1f}")
svc.update(UpdateBatch(eids=np.array([0]),  # Δw stream, epoch barrier
                       new_w=np.array([g.w[0] * 1.5])))
res = svc.query(3, g.n - 2, k=3)          # now answered at epoch 1
assert res.epoch == 1
print(f"same query at epoch {res.epoch}: best {res.paths[0][0]:.1f}")

stream = WeightUpdateStream(g, alpha=0.4, tau=0.5, seed=4)
rng = np.random.default_rng(5)
print(f"{g.n}-vertex network on 6 workers "
      f"({svc.dtlp.partition.n_subgraphs} subgraphs, LPT-balanced, "
      f"slabs on {args.device})")

for round_ in range(4):
    if round_ == 1:
        svc.kill(2)
        print("-- worker 2 killed: replica owners take over --")
    if round_ == 2:
        svc.revive(2)
        print("-- worker 2 revived: it re-syncs the batch it missed "
              "before serving again --")
    if round_ == 3:
        svc.rescale(9)
        print("-- elastic rescale 6 → 9 workers (no index rebuild) --")
    view = graph_view(g)
    reqs = [
        QueryRequest(*map(int, rng.choice(g.n, size=2, replace=False)), k=3)
        for _ in range(15)
    ]
    tickets = svc.replay(reqs)
    for tk in tickets:
        # the slab solves add in float32: exact up to its rounding
        want = ksp(view, tk.request.s, tk.request.t, 3)
        np.testing.assert_allclose([x for x, _ in tk.result.paths],
                                   [x for x, _ in want], rtol=1e-5)
        assert tk.result.epoch == svc.epoch
    lat = sorted(tk.result.latency_ms for tk in tickets)
    print(f"round {round_} (epoch {svc.epoch}): {len(tickets)} queries "
          f"match host Yen, p50 {lat[len(lat) // 2]:.1f}ms, "
          f"reissues={svc.reissues}, resyncs={svc.resyncs}")
    svc.update(UpdateBatch(*stream.next_batch()))

snap = svc.checkpoint()
restored = KSPService.restore(
    snap, lambda: grid_road_network(12, 12, seed=3), config(9))
s, t = 3, g.n - 2
a, b = restored.query(s, t, 2), svc.query(s, t, 2)
# the same paths; their lengths agree up to float32 rounding (the restored
# index joins the partial paths' float32 distances in its own order)
assert [p for _, p in a.paths] == [p for _, p in b.paths]
np.testing.assert_allclose([x for x, _ in a.paths], [x for x, _ in b.paths],
                           rtol=1e-5)
assert a.epoch == b.epoch
print(f"checkpoint → restore → the same answers at epoch {a.epoch}. "
      "serving driver OK")
