#!/usr/bin/env python3
"""Find the highest rate a configuration sustains: one process, one
build, then one open-loop window per rate on the same warmed service.

    python3 kspbench/sweep.py --config roadgrid64-barrier \
        --traffic city-open --rates 4 6 8 10 --seconds 30

Prints one JSON line per window: the offered rate, the queries due and
answered inside the window, p50/p95 latency (ms, from each query's due
instant), the drain after the window and whether every answer matched
the reference.  A rate is sustained when the drain stays short and p95
does not grow with the window.  The rates a cell runs at are fixed in
its traffic file from one such sweep; the cells never run this.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import copy  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(REPO), str(REPO / "src")]

from kspbench import cell, record, reference  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--traffic", required=True)
    ap.add_argument("--rates", type=float, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    cfg = cell.load_json("configs", args.config)
    traffic = cell.load_json("traffic", args.traffic)
    qstream = next(s for s in traffic["streams"] if "k" in s)
    net = cell.build_net(cfg)
    srv = cell.set_up(cfg, net, qstream, [], args.device, log)
    adj = reference.Adjacency(net.n, net.edge_u, net.edge_v, net.directed)
    for i, rate in enumerate(args.rates):
        stream = {**copy.deepcopy(qstream), "rate_qps": rate}
        sources = cell.make_sources({"streams": [stream]}, net,
                                    args.seed + i, args.seconds)
        rec = cell.serve(srv, sources, seconds=args.seconds, trace=False,
                         device=args.device)
        verdict = reference.judge(adj, srv.w_base, [], rec["answers"],
                                  epoch_base=srv.epoch_base)
        lat = record.latencies_ms(rec)
        inside = sum(1 for q in record.answered(rec)
                     if q["done"] <= args.seconds)
        print(json.dumps({
            "rate_qps": rate, "seconds": args.seconds,
            "due": len(rec["queries"]), "answered_in_window": inside,
            "answered_qps": inside / args.seconds,
            "p50_ms": record.percentile(lat, 50),
            "p95_ms": record.percentile(lat, 95),
            "max_ms": max(lat) if lat else None,
            "drain_s": rec["drain_s"],
            "late_max_ms": max(rec["lateness"]) * 1e3,
            "wrong_answers": verdict["wrong_answers"],
            "dist_gap": verdict["dist_gap"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
