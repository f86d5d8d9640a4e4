"""Dry-run: trace every (arch × shape) cell on the meta device and cost it
in H100 terms.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch starcoder2-3b
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh all \\
        --out results/torch_dryrun.jsonl

Records are one JSON line per (cell, mesh), with the reference's keys
(``repro/launch/dryrun.py``).  Mesh ``"1"`` is one H100 holding the
whole cell: the cell's own ``step_fn`` runs once on meta tensors built
from its ``arg_specs`` (``launch.roofline.trace_costs``), which gives
``memory`` (argument, output and peak temporary bytes) and the
``roofline`` terms; ``t_lower_s`` is the trace's time.  On the card
(``--device cuda``, the default) the record also carries the card's name,
its power limit and ``fits_card`` (argument plus temporary bytes within
the card's memory); on ``--device cpu`` those are null.  With neither a
card nor ``--device cpu`` the driver fails; nothing falls back.

Meshes ``"16x16"`` and ``"2x16x16"`` are the reference's TPU pods
(``launch.mesh.make_production_mesh``) as logical shards: their records
carry ``memory.argument_bytes`` per device, from ``specs_shardings``
under the logical-axis rules, and ``"partitioned": false`` with
:data:`NOT_PARTITIONED` in place of the other memory fields and the
roofline.
"""

import argparse
import json
import math
import subprocess
import sys
import time
import traceback

import torch

from repro_torch.configs.base import all_archs
from repro_torch.dist.cluster import resolve_device
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.roofline import trace_costs
from repro_torch.models.common import specs_shardings, tree_leaves

CARD_MESH = "1"
NOT_PARTITIONED = ("PyTorch has no SPMD partitioner: per-device compute, "
                   "temporaries and collectives on this mesh are not traced")


def card_info(device) -> dict | None:
    """The card's name, power limit (nvidia-smi) and memory; None on the
    CPU.  Asking for the card on a host without one raises."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return None
    index = dev.index or 0
    smi = subprocess.run(
        ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    return {"name": torch.cuda.get_device_name(index),
            "power_limit": smi.split(",")[-1].strip(),
            "memory_bytes": torch.cuda.get_device_properties(index)
            .total_memory}


def per_device_argument_bytes(arg_specs, arg_axes, mesh, rules=None) -> int:
    """Bytes of one device's shards of a step's arguments on ``mesh``."""
    total = 0
    for specs, axes in zip(arg_specs, arg_axes):
        shardings = specs_shardings(specs, axes, mesh, rules)
        for spec, sh in zip(tree_leaves(specs), tree_leaves(shardings)):
            itemsize = torch.empty((), dtype=spec.dtype).element_size()
            total += math.prod(sh.shard_shape(spec.shape)) * itemsize
    return total


def mesh_name(mesh) -> str:
    if mesh is None:
        return CARD_MESH
    return "x".join(str(s) for s in mesh.shape.values())


def run_cell(cell, mesh=None, rules=None, verbose=True, card=None):
    """Trace one cell (``mesh`` None: one card) or resolve its per-device
    argument bytes on a TPU mesh; returns a result dict."""
    rec = {
        "cell": cell.name,
        "arch": cell.arch,
        "shape": cell.shape,
        "kind": cell.kind,
        "mesh": mesh_name(mesh),
        "note": cell.note,
    }
    if cell.skip:
        rec["status"] = "skipped"
        rec["skip_reason"] = cell.skip
        return rec
    t0 = time.time()
    try:
        if mesh is None:
            costs = trace_costs(cell.step_fn, cell.arg_specs)
            rec["t_lower_s"] = round(time.time() - t0, 2)
            roof = costs.roofline(n_devices=1)
            rec["memory"] = costs.memory()
            rec["roofline"] = roof.as_dict()
            rec["kernels"] = costs.kernels
            rec["card"] = card and card["name"]
            rec["power_limit"] = card and card["power_limit"]
            rec["fits_card"] = card and (
                costs.argument_bytes + costs.temp_bytes
                <= card["memory_bytes"])
            line = (f"trace={rec['t_lower_s']:7.1f}s "
                    f"Tc={roof.t_compute:9.3e} Tm={roof.t_memory:9.3e} "
                    f"Tcoll={roof.t_collective:9.3e} dom={roof.dominant}")
        else:
            arg = per_device_argument_bytes(cell.arg_specs, cell.arg_axes,
                                            mesh, rules)
            rec["t_lower_s"] = round(time.time() - t0, 2)
            rec["memory"] = {"argument_bytes": arg, "output_bytes": None,
                             "temp_bytes": None,
                             "generated_code_bytes": None}
            rec["roofline"] = None
            rec["partitioned"] = False
            rec["reason"] = NOT_PARTITIONED
            line = f"arg/dev={arg / 1e9:9.4f} GB (not partitioned)"
        rec["status"] = "ok"
        if verbose:
            print(f"OK  {cell.name:44s} mesh={rec['mesh']:9s} {line}",
                  flush=True)
    except Exception as e:  # noqa: BLE001 — report, don't crash the sweep
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
        if verbose:
            print(f"ERR {cell.name:44s} {rec['error'][:120]}", flush=True)
    return rec


def meshes_for(choice: str, device) -> list:
    """None stands for the card; the TPU meshes are logical shards of
    ``device``."""
    out = []
    if choice in ("card", "all"):
        out.append(None)
    if choice in ("single", "both", "all"):
        out.append(make_production_mesh(multi_pod=False, device=device))
    if choice in ("multi", "both", "all"):
        out.append(make_production_mesh(multi_pod=True, device=device))
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", action="append", default=None)
    ap.add_argument("--shape", action="append", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument(
        "--mesh", choices=["card", "single", "multi", "both", "all"],
        default="card",
        help="card: one H100 (traced); single/multi/both: the reference's "
             "16x16 / 2x16x16 TPU meshes (per-device argument bytes); "
             "all: card plus both")
    ap.add_argument("--out", default="results/torch_dryrun.jsonl",
                    help="append JSONL here")
    ap.add_argument("--rules", default=None,
                    help="JSON logical-axis rules override")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="the card (default; no card fails) or the CPU "
                         "(traces only)")
    args = ap.parse_args()

    archs = all_archs()
    names = args.arch if args.arch else (sorted(archs) if args.all else [])
    if not names:
        ap.error("pass --arch <name> (repeatable) or --all")
    rules = json.loads(args.rules) if args.rules else None
    card = card_info(args.device)
    meshes = meshes_for(args.mesh, args.device)

    n_ok = n_err = n_skip = 0
    with open(args.out, "a") as out_f:
        for name in names:
            for cell in archs[name].cells():
                if args.shape and cell.shape not in args.shape:
                    continue
                for mesh in meshes:
                    rec = run_cell(cell, mesh, rules, card=card)
                    out_f.write(json.dumps(rec) + "\n")
                    out_f.flush()
                    n_ok += rec["status"] == "ok"
                    n_err += rec["status"] == "error"
                    n_skip += rec["status"] == "skipped"
    print(f"done: {n_ok} ok, {n_skip} skipped (documented), {n_err} errors")
    sys.exit(1 if n_err else 0)


if __name__ == "__main__":
    main()
