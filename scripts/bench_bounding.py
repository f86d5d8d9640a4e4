#!/usr/bin/env python3
"""The DTLP build's bounding stage on one CUDA card, against the host build.

    python3 scripts/bench_bounding.py [--config NAME] [--no-host] [--out FILE]

Builds the road network of a benchmark configuration
(``kspbench/configs/<NAME>.json``, default ``roadgrid64-barrier``),
partitions it as ``DTLP.build`` does, and runs its bounding stage twice
on the card through ``dtlp.batched_subgraph_indexes`` (the first run
also builds the kernels) and once on the host, source by source
(``dtlp._build_subgraph_index``; ``--no-host`` skips it).  It checks
that the two indexes are equal bit for bit (every array, path and
storage field, and the skeleton's weights), then times, at the shape
the build launched them, ``ktrop_solve`` and ``level_walks`` with CUDA
events (median of 7 launches) and their plain versions on the card,
beside each kernel's bound: its bytes at 3.35 TB/s.  Prints one JSON
object (also written to FILE, default
``chiprun_out/bench_bounding.json``) with the card's name and power
limit.  Without a card it exits non-zero.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet


def cuda_ms(torch, fn, repeats: int = 7) -> float:
    """Median of ``repeats`` CUDA-event timings of ``fn()`` after one
    warm-up call."""
    fn()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def index_diff(g, host, batch) -> list:
    """Names of the fields where two lists of subgraph indexes differ."""
    from repro_torch.core.dtlp import SkeletonGraph

    bad = set()
    for a, b in zip(host, batch):
        for f in ("pairs", "pair_ptr", "path_phi", "path_D", "path_BD",
                  "lbd"):
            x, y = getattr(a, f), getattr(b, f)
            if x.dtype != y.dtype or not np.array_equal(x, y):
                bad.add(f)
        if a.path_vertices != b.path_vertices:
            bad.add("path_vertices")
        if len(a.path_edges) != len(b.path_edges) or any(
                (p is None) != (q is None)
                or (p is not None and (p.dtype != q.dtype
                                       or not np.array_equal(p, q)))
                for p, q in zip(a.path_edges, b.path_edges)):
            bad.add("path_edges")
        for f in ("keys", "indptr", "pids"):
            if not np.array_equal(getattr(a.storage, f),
                                  getattr(b.storage, f)):
                bad.add(f"storage.{f}")
    if len(host) != len(batch):
        bad.add("n_subgraphs")
    skel = []
    for subs in (host, batch):
        s = SkeletonGraph(g.n, g.directed)
        s.finalize(subs)
        s.refresh_weights(subs)
        skel.append(s)
    for f in ("edge_i", "edge_j", "weight"):
        if not np.array_equal(getattr(skel[0], f), getattr(skel[1], f)):
            bad.add(f"skeleton.{f}")
    return sorted(bad)


class Recorder:
    """Keeps the arguments of each call of one ``ops`` wrapper."""

    def __init__(self, ops, name):
        self.ops, self.name = ops, name
        self.orig = getattr(ops, name)
        self.calls = []

        def recording(*args, **kw):
            self.calls.append((args, kw))
            return self.orig(*args, **kw)

        setattr(ops, name, recording)

    def restore(self):
        setattr(self.ops, self.name, self.orig)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="roadgrid64-barrier")
    ap.add_argument("--no-host", action="store_true")
    ap.add_argument("--out", default=str(ROOT / "chiprun_out"
                                         / "bench_bounding.json"))
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("no CUDA card: this script measures the card", file=sys.stderr)
        return 1
    from kspbench import cell
    from repro_torch.core.dtlp import (BuildStats, _build_subgraph_index,
                                       batched_subgraph_indexes)
    from repro_torch.core.graph import Graph
    from repro_torch.core.partition import partition_graph
    from repro_torch.kernels import ops, ref

    cfg = cell.load_json("configs", args.config)
    net = cell.build_net(cfg)
    g = Graph(net.n, net.edge_u, net.edge_v, net.w0, directed=net.directed)
    xi = int(cfg["xi"])
    part = partition_graph(g, int(cfg["z"]), seed=0)
    subs = part.subgraphs
    out = {"config": args.config, "card": torch.cuda.get_device_name(0),
           "n": g.n, "m": g.m, "subgraphs": len(subs),
           "z_max": max(sg.nv for sg in subs)}

    runs = []
    recs = {}
    for i in range(2):
        if i == 1:
            recs = {name: Recorder(ops, name)
                    for name in ("ktrop_solve", "level_walks")}
        stats = BuildStats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batch = batched_subgraph_indexes(g, subs, xi, "paper", stats, "cuda")
        torch.cuda.synchronize()
        runs.append(time.perf_counter() - t0)
    for r in recs.values():
        r.restore()
    out["batched_s"] = runs  # the first run builds the kernels
    out["counts"] = {k: v for k, v in dataclasses.asdict(stats).items()
                     if k in ("device_sources", "host_sources",
                              "device_walks", "simple_walks")}
    if not args.no_host:
        t0 = time.perf_counter()
        host = [_build_subgraph_index(g, sg, xi, "paper") for sg in subs]
        out["host_s"] = time.perf_counter() - t0
        out["differs"] = index_diff(g, host, batch)

    # the two kernels at the shapes the build launched them
    (ka, kkw), = recs["ktrop_solve"].calls
    adj, src, k = ka
    S, z, _ = adj.shape
    kernels = {}
    it = kkw["max_iters"]
    kb = 4 * (S * z * z + S + S * k * z) + 4 * S
    kernels["ktrop_solve"] = {
        "shape": {"S": S, "k": k, "z": z, "max_iters": it},
        "ms": cuda_ms(torch, lambda: ops.ktrop_solve(adj, src, k,
                                                     max_iters=it,
                                                     with_iters=True)),
        "bound_ms": kb / HBM_BYTES_PER_S * 1e3,
        "plain_ms": cuda_ms(torch, lambda: ref.ktrop_solve_ref(
            adj, src, k, it), repeats=3),
    }
    (wa, _), = recs["level_walks"].calls
    D, W = wa[0], wa[9].shape[0]
    n = ops.level_walks(*wa)[2]
    written = int(n.sum()) * 8  # each vertex and edge id of a simple walk
    read = sum(t.numel() * t.element_size() for t in wa)
    kernels["level_walks"] = {
        "shape": {"S": D.shape[0], "k": D.shape[1], "z": D.shape[2],
                  "walks": W, "in_edges": wa[5].shape[0]},
        "ms": cuda_ms(torch, lambda: ops.level_walks(*wa)),
        "bound_ms": (read + written + 4 * W) / HBM_BYTES_PER_S * 1e3,
        "plain_ms": cuda_ms(torch, lambda: ref.level_walks_ref(*wa),
                            repeats=3),
    }
    out["kernels"] = kernels
    try:
        out["power_limit"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        out["power_limit"] = f"unread: {e}"
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    print(json.dumps(out))
    return 1 if out.get("differs") else 0


if __name__ == "__main__":
    sys.exit(main())
