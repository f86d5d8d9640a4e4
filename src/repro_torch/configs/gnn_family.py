"""Cells of the GNN family (4 archs × 4 shapes).

GNN shapes (assigned):
    full_graph_sm   n=2,708  e=10,556   d_feat=1,433  (full-batch; Cora-like)
    minibatch_lg    total graph 232,965 nodes / 114,615,892 edges;
                    sampled batch: 1,024 seeds, fanout 15-10  (Reddit-like)
    ogb_products    n=2,449,029 e=61,859,140 d_feat=100 (full-batch-large)
    molecule        30 nodes / 64 edges per graph, batch=128

The sampled minibatch cell sizes are derived from (seeds, fanout):
nodes = 1024·(1 + 15 + 15·10) = 169,984 padded; edges = 1024·15 + 15,360·10.
DimeNet triplet counts are budgeted at TRIPLET_FACTOR × edges (real
deployments downsample triplets by cutoff; DESIGN.md §6).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch.data import pipeline as dp
from repro_torch.dist.cluster import resolve_device
from repro_torch.models import gnn as G
from repro_torch.train.optim import OptConfig, init_opt
from repro_torch.train.steps import make_train_step

from .base import Arch, Cell, TensorSpec, register, spec_tree

TRIPLET_FACTOR = 4

# physical sizes are the assigned logical sizes padded up to multiples of
# 512 (2 pods × 16 × 16) so node/edge axes shard evenly — the jraph-style
# padding a production graph system always applies (padding nodes/edges
# carry zero masks).
def _pad512(n):
    return ((n + 511) // 512) * 512


GNN_SHAPES = {
    "full_graph_sm": dict(
        n=_pad512(2_708), e=_pad512(10_556), d_feat=1_433, classes=7,
        logical="n=2708 e=10556",
    ),
    "minibatch_lg": dict(
        n=1_024 * (1 + 15 + 150),          # 169,984 = 332×512
        e=1_024 * 15 + 15_360 * 10,        # 168,960 = 330×512
        d_feat=602,
        classes=41,
        seeds=1_024,
        logical="seeds=1024 fanout=15-10",
    ),
    "ogb_products": dict(
        n=_pad512(2_449_029), e=_pad512(61_859_140), d_feat=100, classes=47,
        logical="n=2449029 e=61859140",
    ),
    "molecule": dict(
        n=_pad512(30 * 128), e=64 * 128 * 2, d_feat=16, classes=1,
        graphs=128, logical="30 nodes × 64 edges × batch 128",
    ),
}


def _f32(shape):
    return TensorSpec(tuple(shape), torch.float32)


def _i32(shape):
    return TensorSpec(tuple(shape), torch.int32)


def gnn_batch_specs(kind: str, meta: dict, cfg: G.GNNConfig):
    """TensorSpec batch + logical axes for one shape."""
    n, e = meta["n"], meta["e"]
    specs = {"edge_src": _i32((e,)), "edge_dst": _i32((e,))}
    axes = {"edge_src": ("edges",), "edge_dst": ("edges",)}
    graphs = meta.get("graphs")
    if kind == "dimenet":
        t = TRIPLET_FACTOR * e
        specs.update(
            species=_i32((n,)),
            positions=_f32((n, 3)),
            t_kj=_i32((t,)),
            t_ji=_i32((t,)),
        )
        axes.update(
            species=("nodes",),
            positions=("nodes", "feat"),
            t_kj=("edges",),
            t_ji=("edges",),
        )
        if graphs:
            specs.update(graph_idx=_i32((n,)), labels=_f32((graphs,)))
            axes.update(graph_idx=("nodes",), labels=(None,))
        else:
            specs.update(graph_idx=_i32((n,)), labels=_f32((1,)))
            axes.update(graph_idx=("nodes",), labels=(None,))
    else:
        specs.update(node_feat=_f32((n, meta["d_feat"])))
        axes.update(node_feat=("nodes", "feat"))
        if kind == "mgn":
            specs.update(
                edge_feat=_f32((e, cfg.edge_in_dim)),
                labels=_f32((n, cfg.out_dim)),
                train_mask=_f32((n,)),
            )
            axes.update(
                edge_feat=("edges", "feat"),
                labels=("nodes", "feat"),
                train_mask=("nodes",),
            )
        elif graphs and kind == "gin":
            specs.update(graph_idx=_i32((n,)), labels=_f32((graphs, 1)))
            axes.update(graph_idx=("nodes",), labels=(None, None))
        else:
            specs.update(labels=_i32((n,)), train_mask=_f32((n,)))
            axes.update(labels=("nodes",), train_mask=("nodes",))
    return specs, axes


def shape_cfg(base: G.GNNConfig, shape: str) -> G.GNNConfig:
    """Adapt in/out dims to the shape's feature/class geometry."""
    meta = GNN_SHAPES[shape]
    kw = {}
    if base.kind == "dimenet":
        kw["task"] = "graph_reg"
    elif base.kind == "mgn":
        kw["in_dim"] = meta["d_feat"]
        kw["out_dim"] = 3
        kw["task"] = "node_reg"
    elif base.kind == "gin" and shape == "molecule":
        kw["in_dim"] = meta["d_feat"]
        kw["out_dim"] = 1
        kw["task"] = "graph_reg"
    else:
        kw["in_dim"] = meta["d_feat"]
        kw["out_dim"] = meta["classes"]
    return dataclasses.replace(base, **kw)


def gnn_cells(name: str, base_cfg: G.GNNConfig):
    cells = []
    opt_cfg = OptConfig()
    for shape, meta in GNN_SHAPES.items():
        cfg = shape_cfg(base_cfg, shape)
        if base_cfg.kind == "sage" and shape == "molecule":
            cfg = dataclasses.replace(cfg, in_dim=meta["d_feat"])
        params = G.init_gnn(0, cfg, device="meta")
        p_axes = G.gnn_axes(params)
        o_axes = {"m": p_axes, "v": p_axes, "step": ()}
        b_specs, b_axes = gnn_batch_specs(base_cfg.kind, meta, cfg)
        # sage/gin on molecule need float node feats
        if base_cfg.kind in ("sage", "gin") and shape == "molecule":
            b_specs["node_feat"] = _f32((meta["n"], meta["d_feat"]))
            b_axes["node_feat"] = ("nodes", "feat")
        cells.append(
            Cell(
                arch=name,
                shape=shape,
                kind="train",
                step_fn=make_train_step(
                    functools.partial(G.gnn_loss, cfg=cfg), opt_cfg),
                arg_specs=(spec_tree(params),
                           spec_tree(init_opt(params, opt_cfg)), b_specs),
                arg_axes=(p_axes, o_axes, b_axes),
                note=f"task={cfg.task}",
            )
        )
    return cells


def gnn_smoke(base_cfg: G.GNNConfig, device="cuda"):
    """Reduced-config real train steps (shapes + no NaNs) on ``device``."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    if base_cfg.kind == "dimenet":
        cfg = dataclasses.replace(
            base_cfg, n_layers=2, d_hidden=32, task="graph_reg"
        )
        batch = dp.molecule_batch(4, 8, 12, seed=1)
    elif base_cfg.kind == "mgn":
        cfg = dataclasses.replace(
            base_cfg, n_layers=3, d_hidden=32, in_dim=8, out_dim=3,
            task="node_reg",
        )
        batch = dp.random_gnn_graph(40, 80, 8, 3, seed=1, edge_feat_dim=4)
        batch["labels"] = rng.normal(size=(40, 3)).astype(np.float32)
    else:
        cfg = dataclasses.replace(
            base_cfg, d_hidden=32, in_dim=12, out_dim=5
        )
        batch = dp.random_gnn_graph(50, 100, 12, 5, seed=1)
    params = G.init_gnn(0, cfg, device=dev)
    opt_cfg = OptConfig(peak_lr=1e-3, warmup_steps=2)
    opt = init_opt(params, opt_cfg)
    step = make_train_step(functools.partial(G.gnn_loss, cfg=cfg), opt_cfg)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    losses = []
    for _ in range(4):
        params, opt, metrics = step(params, opt, batch)
        losses.append(float(metrics["loss"]))
        if not np.isfinite(losses[-1]):
            raise RuntimeError(f"{cfg.name}: NaN loss")
    return {"losses": losses, "loss_drop": losses[0] - losses[-1]}


def make_gnn_arch(name, cfg, describe=""):
    return register(
        Arch(
            name=name,
            family="gnn",
            cells_fn=functools.partial(gnn_cells, name, cfg),
            smoke_fn=functools.partial(gnn_smoke, cfg),
            describe=describe,
        )
    )
