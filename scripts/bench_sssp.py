#!/usr/bin/env python3
"""The lazy stream's reverse shortest-path tree, native against Python.

    python3 scripts/bench_sssp.py [--config NAME] [--traffic NAME]
        [--trips N] [--device cuda|cpu] [--out FILE]

Builds the DTLP index of a benchmark configuration
(``kspbench/configs/<NAME>.json``, default ``roadgrid64-barrier``) as the
service does (on the card where ``--device cuda``, the default when one
is present; the host build takes about 40 s), takes the first ``N``
trips (default 60) of the traffic mix's fixed trace
(``kspbench/traffic/<NAME>.json``, default ``city-open``), and for each
builds the query's extended skeleton and times ``reverse_spt`` to its
target twice: on the native route (``csrc/sssp_host.cpp``) and on the
Python loop.  It checks that ``dist`` agrees byte for byte and
``parent`` exactly, and prints one JSON object (also written to FILE,
default ``chiprun_out/bench_sssp.json``): the skeleton's size, each
route's median and mean milliseconds a tree, the library's build
seconds, the host's CPU and, on a card machine, the card's name and
power limit.  Exits non-zero where a tree differs or the native route
is missing.
"""

from __future__ import annotations

import argparse
import json
import platform
import statistics
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def cpu_name() -> str:
    try:
        for line in Path("/proc/cpuinfo").read_text().splitlines():
            if line.startswith("model name"):
                return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.processor() or "unknown"


def timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, (time.perf_counter() - t0) * 1e3


def summary(ms: list) -> dict:
    return {"median_ms": statistics.median(ms),
            "mean_ms": statistics.fmean(ms), "max_ms": max(ms)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="roadgrid64-barrier")
    ap.add_argument("--traffic", default="city-open")
    ap.add_argument("--trips", type=int, default=60)
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None)
    ap.add_argument("--out", default=str(ROOT / "chiprun_out"
                                         / "bench_sssp.json"))
    args = ap.parse_args(argv)

    import torch

    from kspbench import cell, roadgen
    from repro_torch.core import sssp
    from repro_torch.core.dtlp import DTLP
    from repro_torch.core.graph import Graph
    from repro_torch.core.kspdg import _extended_skeleton
    from repro_torch.kernels import _build

    device = args.device or ("cuda" if torch.cuda.is_available() else "cpu")
    cfg = cell.load_json("configs", args.config)
    stream = next(s for s in cell.load_json("traffic", args.traffic)["streams"]
                  if "trace_seed" in s)
    net = cell.build_net(cfg)
    g = Graph(net.n, net.edge_u, net.edge_v, net.w0, directed=net.directed)
    t0 = time.perf_counter()
    dtlp = DTLP.build(g, z=int(cfg["z"]), xi=int(cfg["xi"]),
                      device=device if device == "cuda" else None)
    out = {"config": args.config, "traffic": args.traffic,
           "build_device": device, "dtlp_build_s": time.perf_counter() - t0,
           "cpu": cpu_name()}
    if sssp._native_fn() is None:
        print(f"no native route: {_build.BUILD_INFO.get('sssp_host')}",
              file=sys.stderr)
        return 1
    out["library_build_s"] = _build.BUILD_INFO.get(
        "sssp_host", {}).get("seconds", 0.0)  # 0: an earlier build served

    trips = roadgen.local_trips(
        net, args.trips, np.random.default_rng(int(stream["trace_seed"])),
        int(stream["lo"]), int(stream["hi"]))
    ms = {"native": [], "python": []}
    differs, vertices, half_edges = [], [], []
    for s, t in trips:
        view, ext_id, _, _ = _extended_skeleton(dtlp, s, t)
        vertices.append(view.n)
        half_edges.append(int(view.indptr[-1]))
        et = ext_id(t)
        (d_n, p_n), t_n = timed(lambda: sssp.reverse_spt(view, et, g.directed))
        with mock.patch.object(sssp, "_native_fn", lambda: None):
            (d_p, p_p), t_p = timed(
                lambda: sssp.reverse_spt(view, et, g.directed))
        ms["native"].append(t_n)
        ms["python"].append(t_p)
        if d_n.tobytes() != d_p.tobytes() or not np.array_equal(p_n, p_p):
            differs.append([s, t])
    out["trips"] = len(trips)
    out["skeleton"] = {"vertices": [min(vertices), max(vertices)],
                       "half_edges": [min(half_edges), max(half_edges)]}
    out["routes"] = {r: summary(v) for r, v in ms.items()}
    out["speedup_median"] = (out["routes"]["python"]["median_ms"]
                             / out["routes"]["native"]["median_ms"])
    out["differs"] = differs
    if torch.cuda.is_available():
        try:
            out["card"] = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"], capture_output=True, text=True,
                timeout=20).stdout.strip()
        except (OSError, subprocess.SubprocessError) as e:
            out["card"] = f"unread: {e}"
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    print(json.dumps(out))
    return 1 if differs else 0


if __name__ == "__main__":
    sys.exit(main())
