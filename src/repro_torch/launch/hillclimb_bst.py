"""Hill-climb B: bst×train_batch — dense AdamW tables vs sparse
rowwise-Adagrad touched-rows-only updates (H-B1), plus variants.

Traced (``launch.roofline.trace_costs`` on meta tensors, one H100
holding the whole step):

- H-B0  dense AdamW over every parameter (the registry's cell);
- H-B1  sparse rowwise Adagrad on the touched table rows;
- H-B2  H-B1 with the tables' rows over ("data", "model"): the same
        trace on one card; only the per-device argument bytes on the
        16x16 mesh change, and both are recorded;
- H-B3  H-B1 with bf16 activations;
- H-B4  the reference adds buffer donation to H-B3 (XLA reuses the
        input buffers in place).  An eager call cannot ask for that, so
        H-B4 is recorded as the H-B3 trace with that note.

On the card (``--device cuda``, the default; no card fails) the driver
also measures the dense, sparse and bf16-sparse steps at train_batch on
``ClickStream`` batches (seeded weights): median CUDA-event step ms and
the peak memory above what was allocated before the state was made,
and prints the measured ratios beside the traced ones.

    PYTHONPATH=src python -m repro_torch.launch.hillclimb_bst [--device cpu]
"""

import argparse
import dataclasses
import functools
import json
import statistics

import torch

from repro_torch.configs.base import TensorSpec, all_archs, spec_tree
from repro_torch.configs.bst_arch import BST_SHAPES, CFG
from repro_torch.data.pipeline import ClickStream
from repro_torch.dist.cluster import resolve_device
from repro_torch.launch.dryrun import per_device_argument_bytes
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.roofline import trace_costs
from repro_torch.models import bst as B
from repro_torch.train.optim import OptConfig, init_opt
from repro_torch.train.steps import make_train_step

BATCH = BST_SHAPES["train_batch"]["batch"]
ROWS_ALL_AXES = {"rows": ("data", "model")}
DONATION_NOTE = ("buffer donation has no eager counterpart: the H-B3 "
                 "trace, unchanged")
MEASURE_STEPS = 3


def sparse_cell_specs(cfg=CFG):
    """(step, specs, axes) of the sparse step at train_batch."""
    opt_cfg = OptConfig()
    params = B.init_bst(0, cfg, device="meta")
    p_specs = spec_tree(params)
    p_axes = B.bst_axes(params)
    net = B.dense_params(params)
    net_axes = {k: p_axes[k] for k in net}
    t_specs = spec_tree(B.init_bst_sparse_opt(params))
    t_axes = {"item_acc": ("rows",), "profile_acc": ("rows",)}
    no_specs = spec_tree(init_opt(net, opt_cfg))
    no_axes = {"m": net_axes, "v": net_axes, "step": ()}
    nnz = BATCH * cfg.bag_nnz_per_row
    b_specs = {
        "hist": TensorSpec((BATCH, cfg.seq_len), torch.int32),
        "target": TensorSpec((BATCH,), torch.int32),
        "bag_ids": TensorSpec((nnz,), torch.int32),
        "bag_seg": TensorSpec((nnz,), torch.int32),
        "dense": TensorSpec((BATCH, cfg.n_dense), torch.float32),
        "labels": TensorSpec((BATCH,), torch.float32),
    }
    b_axes = {
        "hist": ("batch", "seq"), "target": ("batch",),
        "bag_ids": ("batch",), "bag_seg": ("batch",),
        "dense": ("batch", "feat"), "labels": ("batch",),
    }
    step = functools.partial(B.bst_sparse_train_step, cfg=cfg,
                             opt_cfg=opt_cfg)
    return step, (p_specs, t_specs, no_specs, b_specs), (
        p_axes, t_axes, no_axes, b_axes)


def run(step, specs, axes, mesh, rules=None, label="", note=None):
    costs = trace_costs(step, specs)
    roof = costs.roofline()
    rec = dict(label=label, **roof.as_dict(),
               argument_bytes=costs.argument_bytes,
               temp_bytes=costs.temp_bytes,
               argument_bytes_per_device_16x16=per_device_argument_bytes(
                   specs, axes, mesh, rules))
    if note:
        rec["note"] = note
    print(
        f"{label:32s} Tc={roof.t_compute:.3e} Tm={roof.t_memory:.3e} "
        f"Tcoll={roof.t_collective:.3e} dom={roof.dominant} "
        f"arg/dev(16x16)="
        f"{rec['argument_bytes_per_device_16x16'] / 1e9:.4f} GB",
        flush=True,
    )
    return rec


def measure(device, variant: str, repeats: int = MEASURE_STEPS) -> dict:
    """Median CUDA-event ms of ``repeats`` steps of ``variant`` ("dense",
    "sparse" or "sparse-bf16") on ClickStream batches at train_batch, and
    the peak memory above what was allocated before the state."""
    cfg = (dataclasses.replace(CFG, compute_dtype="bf16")
           if variant == "sparse-bf16" else CFG)
    stream = ClickStream(n_items=cfg.n_items, n_profile=cfg.n_profile,
                         seq_len=cfg.seq_len, batch=BATCH,
                         bag_nnz=cfg.bag_nnz_per_row, n_dense=cfg.n_dense)
    batches = [{k: torch.from_numpy(v).to(device)
                for k, v in stream.batch_at(i).items()}
               for i in range(repeats)]
    torch.cuda.synchronize(device)
    base = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    opt_cfg = OptConfig()
    params = B.init_bst(torch.Generator(device=device).manual_seed(0), cfg,
                        device=device)
    if variant == "dense":
        step = make_train_step(functools.partial(B.bst_loss, cfg=cfg),
                               opt_cfg)
        state = (params, init_opt(params, opt_cfg))
    else:
        step = functools.partial(B.bst_sparse_train_step, cfg=cfg,
                                 opt_cfg=opt_cfg)
        state = (params, B.init_bst_sparse_opt(params),
                 init_opt(B.dense_params(params), opt_cfg))
    times = []
    for batch in batches:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = step(*state, batch)
        end.record()
        torch.cuda.synchronize(device)
        times.append(start.elapsed_time(end))
        state, metrics = out[:-1], out[-1]
        if not bool(torch.isfinite(metrics["loss"])):
            raise RuntimeError(f"{variant}: non-finite loss")
    peak = torch.cuda.max_memory_allocated(device) - base
    del state, out, params
    torch.cuda.empty_cache()
    return {"ms": statistics.median(times), "peak_bytes": peak}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="the card (default: traces and measures; no card "
                         "fails) or the CPU (traces only)")
    ap.add_argument("--out", default="results/torch_hillclimb_B.jsonl")
    args = ap.parse_args()
    dev = resolve_device(args.device)
    mesh = make_production_mesh(multi_pod=False, device=args.device)
    recs = {}
    with open(args.out, "a") as out:
        cell = next(c for c in all_archs()["bst"].cells()
                    if c.shape == "train_batch")
        recs["dense"] = run(cell.step_fn, cell.arg_specs, cell.arg_axes,
                            mesh, label="dense-adamw (baseline)")
        step, specs, axes = sparse_cell_specs()
        recs["sparse"] = run(step, specs, axes, mesh,
                             label="sparse rowwise (H-B1)")
        recs["rows"] = run(step, specs, axes, mesh, rules=ROWS_ALL_AXES,
                           label="sparse + rows@(data,model) (H-B2)")
        step3, specs3, axes3 = sparse_cell_specs(
            dataclasses.replace(CFG, compute_dtype="bf16"))
        recs["sparse-bf16"] = run(step3, specs3, axes3, mesh,
                                  label="sparse + bf16 (H-B3)")
        recs["donate"] = run(step3, specs3, axes3, mesh,
                             label="sparse + bf16 + donate (H-B4)",
                             note=DONATION_NOTE)
        for rec in recs.values():
            out.write(json.dumps(rec) + "\n")
        if dev.type != "cuda":
            return
        name = torch.cuda.get_device_name(dev)
        measured = {v: measure(dev, v)
                    for v in ("dense", "sparse", "sparse-bf16")}
        for v, m in measured.items():
            out.write(json.dumps(dict(label=f"measured {v}", device=name,
                                      measured_ms=m["ms"],
                                      peak_bytes=m["peak_bytes"])) + "\n")
            print(f"measured {v:12s} on {name}: {m['ms']:.3f} ms (median of "
                  f"{MEASURE_STEPS} steps), peak "
                  f"{m['peak_bytes'] / 1e9:.3f} GB; traced Tm "
                  f"{recs[v]['t_memory_s'] * 1e3:.3f} ms, Tc "
                  f"{recs[v]['t_compute_s'] * 1e3:.3f} ms, argument + temp "
                  f"{(recs[v]['argument_bytes'] + recs[v]['temp_bytes']) / 1e9:.3f}"
                  " GB", flush=True)
        for v in ("sparse", "sparse-bf16"):
            print(f"dense / {v}: measured "
                  f"{measured['dense']['ms'] / measured[v]['ms']:.2f}x, "
                  f"traced Tm "
                  f"{recs['dense']['t_memory_s'] / recs[v]['t_memory_s']:.2f}x",
                  flush=True)


if __name__ == "__main__":
    main()
