"""kspdg — the paper's own architecture: the refine/maintain/index data
plane, as a shape inventory for the card.

Shapes (sized from the paper's CUSA deployment, Table 1: 121,725 subgraphs
at z=1000, 1,000 concurrent queries):

    refine_cusa   S=122,880 slabs z=1024, J=4 problems/slab  (query refine)
    refine_dense  S=8,192  slabs z=256,  J=32                 (hot spot mix)
    maintain      bound-distance refresh for 4M bounding paths (α=50% batch)
    levels        ktrop bounding-path level enumeration (index build)

Each step runs where its arguments lie: through the Hopper kernels on the
card (``kernels.ops``), through their plain versions on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.engine import dense as E
from repro_torch.kernels import ops

from .base import Arch, Cell, TensorSpec, register


def _refine_step(adj, init_dist, banned_v, spur_onehot, banned_next, cap):
    """The distributed refine batch: grouped masked BF + backpointers →
    (dist, parent, iters [S]: relaxations per slab row; their maximum is
    the reference's global count)."""
    return ops.bf_solve_grouped(
        adj, init_dist, banned_v, spur_onehot, banned_next, cap,
        max_iters=64,  # ≥ observed road-subgraph diameter at z≤1024
        with_iters=True,
    )


def _maintain_step(unit_w, unit_n, sub_of_path, phi):
    """BD of every bounding path: the sorted profile (outside any kernel,
    as the reference builds it), then the ``bound_dist`` clip-sum per
    path (its plain version on CPU tensors)."""
    w_sorted, n_sorted, cum_n = E.sort_profile(unit_w, unit_n)
    cum_before = cum_n.sub_(n_sorted)  # in place: one [S,E] array fewer
    return ops.bound_dist(w_sorted, n_sorted, cum_before, sub_of_path, phi)


def _levels_step(adj, src):
    return ops.ktrop_solve(adj, src, k=10, max_iters=48)


def _f32(s):
    return TensorSpec(s, torch.float32)


def _i32(s):
    return TensorSpec(s, torch.int32)


def _b(s):
    return TensorSpec(s, torch.bool)


def kspdg_cells():
    cells = []
    for shape, (S, z, J) in {
        "refine_cusa": (122_880, 1024, 4),
        "refine_dense": (8_192, 256, 32),
    }.items():
        specs = (
            _f32((S, z, z)),      # adj
            _f32((S, J, z)),      # init_dist (warm-startable)
            _b((S, J, z)),        # banned_v
            _b((S, J, z)),        # spur_onehot
            _b((S, J, z)),        # banned_next
            _f32((S, J)),         # cap
        )
        axes = (
            ("subgraphs", None, None),
            ("subgraphs", None, None),
            ("subgraphs", None, None),
            ("subgraphs", None, None),
            ("subgraphs", None, None),
            ("subgraphs", None),
        )
        skip = None
        if shape == "refine_cusa":
            skip = (f"{specs[0].nbytes / 1e9:.0f} GB of adjacency: a "
                    "cluster's worth, not one card's")
        cells.append(
            Cell(
                arch="kspdg", shape=shape, kind="serve",
                step_fn=_refine_step, arg_specs=specs, arg_axes=axes,
                note=f"S={S} z={z} J={J}", skip=skip,
            )
        )
    # maintenance: α=50% of CUSA edges → BD refresh over all touched paths
    S, Ez, B = 122_880, 2048, 4_000_000
    cells.append(
        Cell(
            arch="kspdg", shape="maintain", kind="serve",
            step_fn=_maintain_step,
            arg_specs=(_f32((S, Ez)), _f32((S, Ez)), _i32((B,)), _f32((B,))),
            arg_axes=(
                ("subgraphs", None),
                ("subgraphs", None),
                ("problems",),
                ("problems",),
            ),
            note=f"S={S} E_z={Ez} B={B}",
        )
    )
    # index build: ξ=10 distinct vfrag levels per boundary source
    S2, z2 = 8_192, 256
    cells.append(
        Cell(
            arch="kspdg", shape="levels", kind="serve",
            step_fn=_levels_step,
            arg_specs=(_f32((S2, z2, z2)), _i32((S2,))),
            arg_axes=(("subgraphs", None, None), ("subgraphs",)),
            note=f"S={S2} z={z2} k=10",
        )
    )
    return cells


def kspdg_smoke(device="cuda"):
    """Engine exactness vs host Yen on a real small road net, with the
    spur searches on ``device``."""
    from repro_torch.core.dtlp import DTLP
    from repro_torch.core.sssp import subgraph_view
    from repro_torch.core.yen import ksp
    from repro_torch.data.roadnet import grid_road_network
    from repro_torch.engine.yen_engine import engine_ksp

    g = grid_road_network(8, 8, seed=7)
    d = DTLP.build(g, z=14, xi=3)
    slab = E.pack_subgraphs(d.partition, g.w)
    rng = np.random.default_rng(0)
    checked = 0
    for si in d.sub_indexes[:3]:
        sg = si.sg
        adj = slab.adj[sg.gid, : slab.z, : slab.z]
        view = subgraph_view(sg, g.w)
        for _ in range(2):
            a, b = rng.choice(sg.nv, size=2, replace=False)
            got = engine_ksp(adj, int(a), int(b), 3, device=device)
            want = ksp(view, int(a), int(b), 3)
            gd = [round(x, 5) for x, _ in got]
            wd = [round(x, 5) for x, _ in want]
            if gd != wd:
                raise AssertionError((sg.gid, a, b, gd, wd))
            checked += 1
    return {"engine_ksp_checked": checked}


ARCH = register(
    Arch(
        name="kspdg",
        family="ksp",
        cells_fn=kspdg_cells,
        smoke_fn=kspdg_smoke,
        describe="the paper's refine/maintain/index data plane on the card",
    )
)
