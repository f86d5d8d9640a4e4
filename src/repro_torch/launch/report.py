"""Roofline report generator: results/torch_dryrun.jsonl → tables with
the three terms, dominant bottleneck, MODEL_FLOPS ratio and an
improvement note per cell.

MODEL_FLOPS conventions (global per step, divided by the record's
device count for the per-device ratio):
    LM train    6 · N_active · tokens       (fwd 2 + bwd 4)
    LM prefill  2 · N_active · tokens
    LM decode   2 · N_active_attn-adjusted · batch   (+ attention reads)
    GNN train   6 · Σ_layer (edge gathers + node/edge MLP mults)
    BST         6 · (seq transformer + MLP) · batch (train) / 2 · (serve)
    kspdg       2 · S·J·z² · iters  (min-plus relax = 1 add + 1 min)

The traced FLOPs (``launch.roofline``) count products and the kernels'
min-plus operations, not elementwise work, so "useful %" is model FLOPs
over product FLOPs.  Mesh "1" is one H100 holding the whole cell; the
TPU meshes "16x16" and "2x16x16" are not partitioned (their records
carry per-device argument bytes and no roofline), and their rows print
those bytes and "—" for the terms.
"""

from __future__ import annotations

import json


def _lm_cfg(arch):
    from repro_torch.configs import (
        deepseek_coder_33b,
        deepseek_v3_671b,
        gemma3_27b,
        moonshot_v1_16b_a3b,
        starcoder2_3b,
    )

    return {
        "starcoder2-3b": starcoder2_3b.CFG,
        "deepseek-coder-33b": deepseek_coder_33b.CFG,
        "gemma3-27b": gemma3_27b.CFG,
        "deepseek-v3-671b": deepseek_v3_671b.CFG,
        "moonshot-v1-16b-a3b": moonshot_v1_16b_a3b.CFG,
    }[arch]


def model_flops(arch: str, shape: str) -> float:
    """Analytic useful-FLOPs (global, one step) for each cell."""
    if arch in ("starcoder2-3b", "deepseek-coder-33b", "gemma3-27b",
                "deepseek-v3-671b", "moonshot-v1-16b-a3b"):
        cfg = _lm_cfg(arch)
        n_act = cfg.active_param_count()
        hd = cfg.hd if cfg.mla is None else 192
        if shape == "train_4k":
            toks = 256 * 4096
            attn = (
                2 * 3 * cfg.n_layers * 4096 * toks * cfg.n_heads * hd
            ) / 2  # causal halves the score matmuls
            return 6.0 * n_act * toks + attn
        if shape == "prefill_32k":
            toks = 32 * 32768
            attn = (2 * cfg.n_layers * 32768 * toks * cfg.n_heads * hd) / 2
            return 2.0 * n_act * toks + attn
        B, S = (128, 32768) if shape == "decode_32k" else (1, 524288)
        if cfg.window is not None and cfg.global_every is None:
            S_eff = min(S, cfg.window)
        elif cfg.global_every is not None:
            n_glob = cfg.n_layers // cfg.global_every
            S_eff = (
                n_glob * S + (cfg.n_layers - n_glob) * min(S, cfg.window)
            ) / cfg.n_layers
        else:
            S_eff = S
        attn = 2 * 2 * cfg.n_layers * cfg.n_heads * hd * S_eff * B
        return 2.0 * n_act * B + attn
    if arch == "bst":
        from repro_torch.configs.bst_arch import BST_SHAPES, CFG

        meta = BST_SHAPES[shape]
        d, S = CFG.embed_dim, CFG.seq_len + 1
        tr = CFG.n_blocks * (4 * S * d * d + 2 * S * S * d + 2 * S * d * CFG.d_ff)
        mlp_in = S * d + d + CFG.n_dense
        dims = (mlp_in,) + CFG.mlp + (1,)
        mlp = sum(a * b for a, b in zip(dims[:-1], dims[1:]))
        per_ex = 2.0 * (tr + mlp)
        if shape == "train_batch":
            return 3 * per_ex * meta["batch"]
        if shape == "retrieval_cand":
            user = per_ex
            return user + 2.0 * meta["candidates"] * d
        return per_ex * meta["batch"]
    if arch == "kspdg":
        dims = {
            "refine_cusa": (122_880, 1024, 4, 64),
            "refine_dense": (8_192, 256, 32, 64),
        }
        if shape in dims:
            S, z, J, it = dims[shape]
            return 2.0 * S * J * z * z * it
        if shape == "maintain":
            return 2.0 * 4_000_000 * 2048
        if shape == "levels":
            return 2.0 * 8192 * 10 * 256 * 256 * 48
    # GNN family
    from repro_torch.configs.gnn_family import GNN_SHAPES, TRIPLET_FACTOR

    meta = GNN_SHAPES[shape]
    n, e, f = meta["n"], meta["e"], meta["d_feat"]
    if arch == "graphsage-reddit":
        d = 128
        return 6.0 * (n * (f * d + d * d) + 2 * (e * d + n * d * d))
    if arch == "gin-tu":
        d = 64
        return 6.0 * 5 * (e * d + n * 2 * d * d)
    if arch == "meshgraphnet":
        d = 128
        per_layer = e * (3 * d) * d * 2 + n * (2 * d) * d * 2
        return 6.0 * (15 * per_layer + n * f * d + e * 4 * d)
    if arch == "dimenet":
        d, nb = 128, 8
        t = TRIPLET_FACTOR * e
        per_block = t * (d * d + d * nb * d) + e * 2 * d * d
        return 6.0 * (6 * per_block + e * (2 * d + 42) * d)
    raise KeyError((arch, shape))


def load(path="results/torch_dryrun.jsonl"):
    recs = [json.loads(l) for l in open(path)]
    # keep the LAST record per (cell, mesh) — re-runs supersede
    out = {}
    for r in recs:
        out[(r["cell"], r["mesh"])] = r
    return list(out.values())


#: the meshes of a dry-run: one card, then the reference's TPU pods
MESHES = ("1", "16x16", "2x16x16")

IMPROVE_NOTES = {
    "compute": "raise arithmetic intensity (fuse, bf16, bigger tiles)",
    "memory": "cut HLO bytes: less remat recompute, fuse elementwise "
              "chains, bf16 activations",
    "collective": "re-shard to kill resharding collectives; overlap "
                  "all-gathers with compute; compress cross-pod traffic",
}


def markdown_table(recs, mesh="16x16"):
    rows = []
    rows.append(
        "| cell | kind | Tc (s) | Tm (s) | Tcoll (s) | dominant | "
        "MODEL_GF/dev | HLO_GF/dev | useful % | note |"
    )
    rows.append("|---|---|---|---|---|---|---|---|---|---|")
    for r in sorted(recs, key=lambda x: x["cell"]):
        if r["mesh"] != mesh:
            continue
        if r["status"] == "skipped":
            rows.append(
                f"| {r['cell']} | {r['kind']} | — | — | — | skipped | — | — "
                f"| — | {r['skip_reason'][:60]} |"
            )
            continue
        if r["status"] != "ok":
            rows.append(f"| {r['cell']} | {r['kind']} | ERROR: {r['error'][:60]} |")
            continue
        roof = r["roofline"]
        if roof is None:
            arg = r["memory"]["argument_bytes"] / 1e9
            rows.append(
                f"| {r['cell']} | {r['kind']} | — | — | — | not partitioned "
                f"| — | — | — | argument {arg:.3f} GB/dev |"
            )
            continue
        try:
            mf = model_flops(r["arch"], r["shape"]) / roof["n_devices"]
        except Exception:
            mf = float("nan")
        hlo = roof["flops"]
        ratio = 100.0 * mf / hlo if hlo else float("nan")
        rows.append(
            "| {cell} | {kind} | {tc:.3e} | {tm:.3e} | {tco:.3e} | {dom} | "
            "{mf:.1f} | {hf:.1f} | {ratio:.0f}% | {note} |".format(
                cell=r["cell"], kind=r["kind"],
                tc=roof["t_compute_s"], tm=roof["t_memory_s"],
                tco=roof["t_collective_s"], dom=roof["dominant"],
                mf=mf / 1e9, hf=hlo / 1e9, ratio=min(ratio, 999),
                note=IMPROVE_NOTES[roof["dominant"]][:58],
            )
        )
    return "\n".join(rows)


if __name__ == "__main__":
    import sys

    path = sys.argv[1] if len(sys.argv) > 1 else "results/torch_dryrun.jsonl"
    recs = load(path)
    for mesh in MESHES:
        n_ok = sum(r["status"] == "ok" and r["mesh"] == mesh for r in recs)
        print(f"\n### mesh {mesh} ({n_ok} cells ok)\n")
        print(markdown_table(recs, mesh))
