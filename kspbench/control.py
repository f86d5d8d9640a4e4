#!/usr/bin/env python3
"""The control of the correctness check: the plain reference put in the
program's place with one guarantee of the configuration broken (its
paths need not be simple: the k shortest walks), on a cell's own traffic
and size.  The check must call it not correct.

    python3 kspbench/control.py --workload city-open --seeds 1 2 3 [--sound]

For each seed it draws the cell's traffic for one window of
``run_seconds``, answers the queries a run would answer (every query due
in the window), each at the epoch of every update batch due before it,
and prints the numbers the check compares.  ``--sound`` puts the
reference itself in the program's place instead (it must read 0).  It
runs on the host alone and imports nothing of the program; the cells'
own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from kspbench import cell, reference  # noqa: E402


def control_answers(net, sources, batches, *, sound: bool, w_base,
                    epoch_base: int = 0) -> list:
    """The control's answers to the queries one window sends."""
    evs = [e for src in sources for e in src.initial()
           if e["kind"] == "query"]
    update_dues = [e["due"] for src in sources for e in src.initial()
                   if e["kind"] == "update"]
    adj = reference.Adjacency(net.n, net.edge_u, net.edge_v, net.directed)
    solve = reference.ksp if sound else reference.k_shortest_walks
    out = []
    cache: dict = {}
    for e in evs:
        applied = sum(1 for d in update_dues if d <= e["due"])
        if applied not in cache:
            cache[applied] = reference.weights_at(
                w_base, batches, applied).tolist()
        paths = solve(adj, cache[applied], e["s"], e["t"], e["k"])
        epoch = epoch_base + applied
        out.append({"s": e["s"], "t": e["t"], "k": e["k"], "paths": paths,
                    "epoch": epoch, "epoch_lo": epoch, "epoch_hi": epoch})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--sound", action="store_true")
    args = ap.parse_args(argv)
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    wl = next(w for w in bench["workloads"] if w["name"] == args.workload)
    cfg = cell.load_json("configs", wl["config"])
    traffic = cell.load_json("traffic", wl["traffic"])
    net = cell.build_net(cfg)
    adj = reference.Adjacency(net.n, net.edge_u, net.edge_v, net.directed)
    for seed in args.seeds:
        sources = cell.make_sources(traffic, net, seed, bench["run_seconds"])
        warm = [b for s in sources for b in s.warm_batches]
        w_base = reference.weights_at(net.w0, warm, len(warm))
        batches = [(e["eids"], e["new_w"]) for s in sources
                   for e in s.initial() if e["kind"] == "update"]
        answers = control_answers(net, sources, batches, sound=args.sound,
                                  w_base=w_base)
        v = reference.judge(adj, w_base, batches, answers)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "sound": args.sound, "answers": len(answers),
                          "wrong_answers": v["wrong_answers"],
                          "dist_gap": v["dist_gap"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
