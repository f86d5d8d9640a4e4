"""Assemble §Dry-run / §Roofline tables from results/torch_*.jsonl.

    PYTHONPATH=src python -m repro_torch.launch.experiments_md > EXPERIMENTS.gen.md
"""

from __future__ import annotations

import json
import os

from repro_torch.launch.report import MESHES, load, markdown_table, model_flops


def dryrun_summary(recs):
    lines = []
    lines.append(
        "| cell | mesh | status | compile (s) | arg GB/dev | temp GB/dev | "
        "collective ops |"
    )
    lines.append("|---|---|---|---|---|---|---|")
    for r in sorted(recs, key=lambda x: (x["cell"], x["mesh"])):
        if r["status"] == "skipped":
            lines.append(
                f"| {r['cell']} | {r['mesh']} | SKIP (documented) | — | — | — "
                f"| — |"
            )
            continue
        if r["status"] != "ok":
            lines.append(f"| {r['cell']} | {r['mesh']} | ERROR | | | | |")
            continue
        mem = r.get("memory", {})
        arg = (mem.get("argument_bytes") or 0) / 1e9
        if r["roofline"] is None:
            lines.append(
                f"| {r['cell']} | {r['mesh']} | ok (not partitioned) | "
                f"{r.get('t_compile_s', '')} | {arg:.2f} | — | — |"
            )
            continue
        tmp = (mem.get("temp_bytes") or 0) / 1e9
        n_coll = r["roofline"]["coll_counts"]
        coll = ", ".join(f"{k}×{v}" for k, v in sorted(n_coll.items()))
        lines.append(
            f"| {r['cell']} | {r['mesh']} | ok | {r.get('t_compile_s', '')} "
            f"| {arg:.2f} | {tmp:.2f} | {coll or '-'} |"
        )
    return "\n".join(lines)


def rooffit_table(path="results/torch_rooffit.jsonl"):
    if not os.path.exists(path):
        return "(rooffit.jsonl not present)"
    best = {}
    for l in open(path):
        r = json.loads(l)
        best[(r["arch"], r["shape"], r.get("mesh"))] = r
    lines = [
        "| cell | mesh | Tc (s) | Tm (s) | Tcoll (s) | dominant | "
        "MODEL_TF/dev | HLO_TF/dev (fit) | useful |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for (arch, shape, mesh), r in sorted(best.items()):
        if "error" in r:
            lines.append(f"| {arch}×{shape} | {mesh} | fit error: {r['error'][:60]} |")
            continue
        mf = model_flops(arch, shape) / r["n_devices"]
        useful = 100 * mf / r["flops"] if r["flops"] else float("nan")
        lines.append(
            f"| {arch}×{shape} | {mesh} | {r['t_compute_s']:.3e} | "
            f"{r['t_memory_s']:.3e} | {r['t_collective_s']:.3e} | "
            f"{r['dominant']} | {mf / 1e12:.2f} | {r['flops'] / 1e12:.2f} | "
            f"{useful:.0f}% |"
        )
    return "\n".join(lines)


if __name__ == "__main__":
    recs = load("results/torch_dryrun.jsonl")
    print("## §Dry-run (generated)\n")
    n_ok = sum(r["status"] == "ok" for r in recs)
    n_skip = sum(r["status"] == "skipped" for r in recs)
    n_err = sum(r["status"] == "error" for r in recs)
    print(
        f"{n_ok} (arch × shape × mesh) records traced or resolved "
        f"({n_skip} documented skips, {n_err} errors).\n"
    )
    print(dryrun_summary(recs))
    print("\n## §Roofline — one H100 per cell (traced)\n")
    for mesh in MESHES:
        print(f"\n### mesh {mesh}\n")
        print(markdown_table(recs, mesh))
    print("\n## §Roofline — LM cells fitted over depth (rooffit)\n")
    print(rooffit_table())
