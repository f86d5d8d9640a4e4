"""Training driver: any registered arch, fault-tolerant, on one device.

    PYTHONPATH=src python -m repro_torch.launch.train --arch starcoder2-3b \\
        --smoke             # reduced config
    PYTHONPATH=src python -m repro_torch.launch.train --arch gin-tu --steps 50

Features exercised end-to-end: deterministic restartable data pipeline,
AdamW + clip + cosine schedule, periodic async checkpointing, resume
(--resume picks up the latest step and the pipeline continues exactly
where it left off).

Runs on the card unless ``--device cpu`` is given; asking for the card
on a host without one fails, nothing falls back.
"""

from __future__ import annotations

import argparse
import functools
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch.ckpt.checkpoint import Checkpointer
from repro_torch.configs.base import all_archs
from repro_torch.dist.cluster import resolve_device
from repro_torch.train.optim import OptConfig, init_opt
from repro_torch.train.steps import make_train_step


def _smoke_setup(arch_name: str, device):
    """(init_fn, loss_fn, batch_at) for the reduced config of an arch:
    ``init_fn(seed)`` gives parameters on ``device``, ``batch_at(step)`` a
    numpy batch."""
    arch = all_archs()[arch_name]
    if arch.family == "lm":
        import repro_torch.configs as C
        from repro_torch.data.pipeline import TokenPipeline
        from repro_torch.models import transformer as T
        from repro_torch.models.common import DEFAULT_POLICY

        mod = {
            "starcoder2-3b": C.starcoder2_3b,
            "deepseek-coder-33b": C.deepseek_coder_33b,
            "gemma3-27b": C.gemma3_27b,
            "deepseek-v3-671b": C.deepseek_v3_671b,
            "moonshot-v1-16b-a3b": C.moonshot_v1_16b_a3b,
        }[arch_name]
        cfg = mod.SMOKE
        pipe = TokenPipeline(vocab=cfg.vocab, batch=4, seq_len=64)
        return (
            lambda seed: T.init_lm(seed, cfg, DEFAULT_POLICY, device=device),
            functools.partial(T.lm_loss, cfg=cfg),
            pipe.batch_at,
        )
    if arch.family == "gnn":
        from repro_torch.data import pipeline as dp
        from repro_torch.models import gnn as G

        cfg0 = {
            "dimenet": G.GNNConfig("dimenet", "dimenet", 2, 32,
                                   task="graph_reg"),
            "meshgraphnet": G.GNNConfig(
                "mgn", "mgn", 3, 32, in_dim=8, out_dim=3, task="node_reg"
            ),
            "graphsage-reddit": G.GNNConfig(
                "sage", "sage", 2, 32, in_dim=12, out_dim=5, aggregator="mean"
            ),
            "gin-tu": G.GNNConfig("gin", "gin", 3, 32, in_dim=12, out_dim=5),
        }[arch_name]

        def batch_at(step):
            rng = np.random.default_rng(step)
            if cfg0.kind == "dimenet":
                return dp.molecule_batch(4, 8, 12, seed=step)
            b = dp.random_gnn_graph(
                50, 100, cfg0.in_dim, cfg0.out_dim, seed=step,
                edge_feat_dim=4 if cfg0.kind == "mgn" else 0,
            )
            if cfg0.kind == "mgn":
                b["labels"] = rng.normal(size=(50, 3)).astype(np.float32)
            return b

        return (
            lambda seed: G.init_gnn(seed, cfg0, device=device),
            functools.partial(G.gnn_loss, cfg=cfg0),
            batch_at,
        )
    if arch.family == "recsys":
        from repro_torch.configs.bst_arch import SMOKE as cfg
        from repro_torch.data.pipeline import ClickStream
        from repro_torch.models import bst as B

        pipe = ClickStream(
            n_items=cfg.n_items, n_profile=cfg.n_profile, seq_len=cfg.seq_len,
            batch=16, bag_nnz=cfg.bag_nnz_per_row, n_dense=cfg.n_dense,
        )
        return (
            lambda seed: B.init_bst(seed, cfg, device=device),
            functools.partial(B.bst_loss, cfg=cfg),
            pipe.batch_at,
        )
    raise ValueError(f"no training path for family {arch.family}")


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_torch-ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where to train (default: the card; no card and "
                    "no --device cpu fails)")
    return ap.parse_args(argv)


def train(args) -> list[float]:
    """Run the steps of ``args`` and return each step's loss."""
    dev = resolve_device(args.device)
    init_fn, loss_fn, batch_at = _smoke_setup(args.arch, dev)
    opt_cfg = OptConfig(peak_lr=args.lr, warmup_steps=5,
                        decay_steps=args.steps)
    params = init_fn(0)
    opt = init_opt(params, opt_cfg)
    start = 0
    ck = Checkpointer(f"{args.ckpt_dir}/{args.arch}")
    if args.resume and ck.latest_step() is not None:
        start, state = ck.restore(device=dev)
        params, opt = state["params"], state["opt"]
        opt["step"] = torch.as_tensor(opt["step"], device=dev)
        print(f"resumed from step {start}")

    step_fn = make_train_step(loss_fn, opt_cfg)
    losses = []
    t0 = time.time()
    try:
        for step in range(start, args.steps):
            batch = {k: torch.from_numpy(np.asarray(v)).to(dev)
                     for k, v in batch_at(step).items()}
            params, opt, metrics = step_fn(params, opt, batch)
            losses.append(float(metrics["loss"]))
            if step % 5 == 0 or step == args.steps - 1:
                print(
                    f"step {step:5d} loss {losses[-1]:.4f} "
                    f"gnorm {float(metrics['grad_norm']):.3f} "
                    f"lr {float(metrics['lr']):.2e} "
                    f"({(time.time() - t0):.1f}s)",
                    flush=True,
                )
            if (step + 1) % args.ckpt_every == 0:
                ck.save(step + 1, {"params": params, "opt": opt},
                        blocking=False)
    finally:
        ck.wait()
    ck.save(args.steps, {"params": params, "opt": opt}, blocking=True)
    print(f"done: {args.steps} steps, checkpoints in {ck.dir}")
    return losses


def main(argv=None):
    train(parse_args(argv))


if __name__ == "__main__":
    main()
