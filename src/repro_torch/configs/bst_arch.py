"""bst [arXiv:1905.06874]: Behavior Sequence Transformer + its 4 shapes."""

from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.data.pipeline import ClickStream
from repro_torch.dist.cluster import resolve_device
from repro_torch.models import bst as B
from repro_torch.train.optim import OptConfig, init_opt
from repro_torch.train.steps import make_train_step

from .base import Arch, Cell, TensorSpec, register, spec_tree

CFG = B.BSTConfig(
    name="bst",
    embed_dim=32,
    seq_len=20,
    n_blocks=1,
    n_heads=8,
    mlp=(1024, 512, 256),
    n_items=10_000_000,
    n_profile=1_000_000,
)

SMOKE = B.BSTConfig(
    name="bst-smoke",
    embed_dim=16,
    seq_len=8,
    n_blocks=1,
    n_heads=4,
    mlp=(64, 32),
    n_items=1_000,
    n_profile=500,
    bag_nnz_per_row=8,
    n_dense=4,
)

BST_SHAPES = {
    "train_batch": dict(kind="train", batch=65_536),
    "serve_p99": dict(kind="serve", batch=512),
    "serve_bulk": dict(kind="serve", batch=262_144),
    "retrieval_cand": dict(kind="retrieval", batch=1, candidates=1_000_000),
}


def _batch_specs(cfg: B.BSTConfig, batch: int, with_labels: bool):
    nnz = batch * cfg.bag_nnz_per_row
    specs = {
        "hist": TensorSpec((batch, cfg.seq_len), torch.int32),
        "target": TensorSpec((batch,), torch.int32),
        "bag_ids": TensorSpec((nnz,), torch.int32),
        "bag_seg": TensorSpec((nnz,), torch.int32),
        "dense": TensorSpec((batch, cfg.n_dense), torch.float32),
    }
    axes = {
        "hist": ("batch", "seq"),
        "target": ("batch",),
        "bag_ids": ("batch",),
        "bag_seg": ("batch",),
        "dense": ("batch", "feat"),
    }
    if with_labels:
        specs["labels"] = TensorSpec((batch,), torch.float32)
        axes["labels"] = ("batch",)
    return specs, axes


def bst_cells():
    cells = []
    opt_cfg = OptConfig()
    params = B.init_bst(0, CFG, device="meta")
    p_specs = spec_tree(params)
    p_axes = B.bst_axes(params)
    o_specs = spec_tree(init_opt(params, opt_cfg))
    o_axes = {"m": p_axes, "v": p_axes, "step": ()}
    for shape, meta in BST_SHAPES.items():
        if meta["kind"] == "train":
            b_specs, b_axes = _batch_specs(CFG, meta["batch"], True)
            cells.append(
                Cell(
                    arch="bst", shape=shape, kind="train",
                    step_fn=make_train_step(
                        functools.partial(B.bst_loss, cfg=CFG), opt_cfg),
                    arg_specs=(p_specs, o_specs, b_specs),
                    arg_axes=(p_axes, o_axes, b_axes),
                )
            )
        elif meta["kind"] == "serve":
            b_specs, b_axes = _batch_specs(CFG, meta["batch"], False)
            cells.append(
                Cell(
                    arch="bst", shape=shape, kind="serve",
                    step_fn=functools.partial(B.bst_serve, cfg=CFG),
                    arg_specs=(p_specs, b_specs),
                    arg_axes=(p_axes, b_axes),
                )
            )
        else:  # retrieval
            b_specs, b_axes = _batch_specs(CFG, 1, False)
            b_specs["candidates"] = TensorSpec((meta["candidates"],),
                                               torch.int32)
            b_axes["candidates"] = ("candidates",)
            cells.append(
                Cell(
                    arch="bst", shape=shape, kind="retrieval",
                    step_fn=functools.partial(B.bst_retrieval, cfg=CFG),
                    arg_specs=(p_specs, b_specs),
                    arg_axes=(p_axes, b_axes),
                )
            )
    return cells


def retrieval_batch(batch: dict, nnz: int, n_candidates: int) -> dict:
    """One user of a ``ClickStream`` batch (its first example and its
    first ``nnz`` profile ids) with candidates ``0..n_candidates-1``."""
    out = {k: v[:1] for k, v in batch.items()
           if k in ("hist", "target", "dense", "labels")}
    out["bag_ids"] = batch["bag_ids"][:nnz]
    out["bag_seg"] = np.zeros((nnz,), np.int32)
    out["candidates"] = np.arange(n_candidates, dtype=np.int32)
    return out


def bst_smoke(device="cuda"):
    dev = resolve_device(device)
    cfg = SMOKE
    stream = ClickStream(
        n_items=cfg.n_items,
        n_profile=cfg.n_profile,
        seq_len=cfg.seq_len,
        batch=16,
        bag_nnz=cfg.bag_nnz_per_row,
        n_dense=cfg.n_dense,
    )
    params = B.init_bst(0, cfg, device=dev)
    opt_cfg = OptConfig(peak_lr=1e-3, warmup_steps=2)
    opt = init_opt(params, opt_cfg)
    step = make_train_step(functools.partial(B.bst_loss, cfg=cfg), opt_cfg)

    def on_dev(b):
        return {k: torch.from_numpy(v).to(dev) for k, v in b.items()}

    losses = []
    for i in range(4):
        params, opt, m = step(params, opt, on_dev(stream.batch_at(i)))
        losses.append(float(m["loss"]))
        if not np.isfinite(losses[-1]):
            raise RuntimeError(f"{cfg.name}: NaN loss")
    # retrieval path
    b = on_dev(retrieval_batch(stream.batch_at(9), cfg.bag_nnz_per_row, 64))
    with torch.no_grad():
        scores = B.bst_retrieval(params, b, cfg)
    if tuple(scores.shape) != (64,) or not bool(torch.isfinite(scores).all()):
        raise RuntimeError(f"{cfg.name}: retrieval scores {scores}")
    return {"losses": losses, "loss_drop": losses[0] - losses[-1]}


ARCH = register(
    Arch(
        name="bst",
        family="recsys",
        cells_fn=bst_cells,
        smoke_fn=bst_smoke,
        describe="Behavior Sequence Transformer; row-sharded tables + "
        "EmbeddingBag(row gather + segment sum)",
    )
)
