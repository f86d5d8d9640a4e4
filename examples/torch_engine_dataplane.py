"""The GPU data plane in isolation: pack real subgraphs into dense slabs,
run one Yen iteration's deviation searches as a single batched masked
Bellman–Ford, and cross-check the Hopper kernels (``kernels.ops``)
against the plain PyTorch engine and ``cuda_bf`` against ``dense_bf``.

    PYTHONPATH=src python examples/torch_engine_dataplane.py [--device cpu]

On CPU tensors the kernel wrappers run their plain versions.
"""

import argparse

import numpy as np
import torch

from repro_torch.core.dtlp import DTLP
from repro_torch.core.sssp import subgraph_view
from repro_torch.core.yen import ksp
from repro_torch.data.roadnet import grid_road_network
from repro_torch.dist.cluster import resolve_device
from repro_torch.engine import dense as E
from repro_torch.engine.yen_engine import engine_ksp
from repro_torch.kernels import ops
from repro_torch.service import KSPService, ServiceConfig

ap = argparse.ArgumentParser()
ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                help="where the slab and the solves live (no fallback)")
args = ap.parse_args()
dev = resolve_device(args.device)  # no card: raise, never fall back

g = grid_road_network(10, 10, seed=11)
d = DTLP.build(g, z=18, xi=4)
slab = E.pack_subgraphs(d.partition, g.w, lane=32)
print(f"packed {slab.n_sub} subgraphs into a [{slab.n_sub},{slab.z},{slab.z}] "
      f"dense min-plus slab")

# one batched multi-source BF over every subgraph at once (grouped layout)
S, z = slab.n_sub, slab.z
J = 4
init = np.full((S, J, z), E.INF, np.float32)
rng = np.random.default_rng(0)
for s in range(S):
    for j in range(J):
        init[s, j, rng.integers(0, max(1, slab.nv[s]))] = 0.0
adj = torch.from_numpy(slab.adj).to(dev)
d0 = torch.from_numpy(init).to(dev)
no = torch.zeros_like(d0, dtype=torch.bool)
cap = torch.full((S, J), E.INF, device=dev)
dist, iters = E.bf_solve_grouped(adj, d0)
print(f"plain grouped BF converged in {int(iters)} relaxations for "
      f"{S * J} simultaneous SSSP problems")

# the kernels compute the same relaxation step and the same fixed point
ops.reset_launches()
step_kernel = ops.bf_relax_step(d0, adj, no, no)
step_ref = E.bf_step_grouped(d0, adj, no, no)
assert torch.equal(step_kernel, step_ref)
kd, kp = ops.bf_solve_grouped(adj, d0, no, no, no, cap)
assert torch.equal(kd, dist)
assert torch.equal(kp, E.bf_parents_grouped(adj, dist, no, no))
print(f"bf_relax_step and bf_solve_grouped == the plain engine, bitwise "
      f"(kernel launches {ops.LAUNCHES})")

# engine KSP (host Yen + batched BF spur searches) vs host PYen
si = d.sub_indexes[0]
view = subgraph_view(si.sg, g.w)
got = engine_ksp(slab.adj[si.sg.gid], 0, si.sg.nv - 1, 4, device=dev)
want = ksp(view, 0, si.sg.nv - 1, 4, mode="pyen")
assert [round(x, 5) for x, _ in got] == [round(x, 5) for x, _ in want]
print(f"engine KSP == PYen on subgraph 0: dists "
      f"{[round(x, 2) for x, _ in got]}")

# the service on the kernel engine vs the plain engine: same answers
answers = {}
for engine in ("cuda_bf", "dense_bf"):
    svc = KSPService(d, ServiceConfig(engine=engine, n_workers=2,
                                      device=args.device))
    answers[engine] = [svc.query(s, t, 3).paths
                       for s, t in ((0, g.n - 1), (3, g.n - 7), (12, 40))]
assert answers["cuda_bf"] == answers["dense_bf"]
print("cuda_bf serves dense_bf's answers on 3 queries")
print("GPU data-plane example OK")
