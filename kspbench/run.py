#!/usr/bin/env python3
"""The benchmark of ``repro_torch``: one cell, one run.

    python3 kspbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1> [--device cuda|cpu]

Reads the cell from ``BENCHMARK.json``, its configuration from
``kspbench/configs/<config>.json`` and its traffic mix from
``kspbench/traffic/<traffic>.json``, runs it once (``kspbench/cell.py``)
and prints, as the last line of standard output, one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics with ``--trace 0``, its per-layer metrics with
``--trace 1``; each read by ``kspbench/metrics/<name>.py``), ``device``,
with ``--trace 1`` ``breakdown``, then ``generator`` (how late arrivals
were sent) and last ``checks``: each number the correctness check
compares, beside its limit.  The same checks are the last lines of
standard error.

Exits non-zero and prints no result when the card (or as many cards as
the cell asks for) is missing, or when JAX or the JAX package was loaded
by the time the window closed.  ``--device cpu`` is a rehearsal on the
CPU with the program's plain ``dense_bf`` engine: device metrics read
"not measured", and no cell is measured that way.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import collections  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# one process, few threads: the service is single-threaded host code
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(_var, "1")

REPO = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(REPO), str(REPO / "src")]

from kspbench import cell, devtrace, record, reference  # noqa: E402

#: top-level module names that may not be loaded in a run
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return ap.parse_args(argv)


def cell_metrics(bench: dict, name: str, trace: bool) -> list[dict]:
    """The metrics the cell reports: its end-to-end ones, or (traced) its
    per-layer ones."""
    if trace:
        return [m for m in bench["per_layer"]
                if name in m.get("workloads", [name])]
    return [m for m in bench["end_to_end"]
            if name in m.get("workloads", [name])]


def read_metrics(metrics, rec, device) -> dict:
    out = {}
    for m in metrics:
        mod = cell.load_module(cell.ROOT / "metrics" / f"{m['name']}.py")
        if mod.UNIT != m["unit"]:
            raise SystemExit(f"metric {m['name']}: unit {mod.UNIT!r} in its "
                             f"reader, {m['unit']!r} in BENCHMARK.json")
        if getattr(mod, "DEVICE", False) and device != "cuda":
            out[m["name"]] = {"value": "not measured", "unit": m["unit"]}
            continue
        value = mod.read(rec)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def compared(rec) -> dict:
    """Each number the correctness check compares, beside its limit."""
    verdict = rec["verdict"]
    unanswered = sum(1 for q in rec["queries"] if q["failed"] == "unanswered")
    return {name: {"value": value, "limit": reference.LIMITS[name]}
            for name, value in (("wrong_answers", verdict["wrong_answers"]),
                                ("dist_gap", verdict["dist_gap"]),
                                ("unanswered", unanswered))}


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)


def main(argv=None) -> int:
    args = parse(argv)
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    wl = next((w for w in bench["workloads"] if w["name"] == args.workload),
              None)
    if wl is None:
        log(f"no workload {args.workload!r} in BENCHMARK.json")
        return 2
    cfg = cell.load_json("configs", wl["config"])
    traffic = cell.load_json("traffic", wl["traffic"])

    import torch

    if args.device == "cuda":
        if not torch.cuda.is_available():
            log("no CUDA device: this benchmark measures the card")
            return 3
        if torch.cuda.device_count() < wl["chips"]:
            log(f"{wl['chips']} card(s) asked for, "
                f"{torch.cuda.device_count()} present")
            return 3
    rec = cell.run_cell(cfg, traffic, seed=args.seed, seconds=args.seconds,
                        trace=bool(args.trace), device=args.device,
                        t_start=T_START, log=log)
    found = forbidden_modules()
    if found:
        log(f"loaded in the run: {', '.join(found)}")
        return 4

    checks = compared(rec)
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    for what in ("first_wrong", "widest_gap"):
        if rec["verdict"][what] is not None:
            log(f"[check] {what}: {rec['verdict'][what]}")
    queries = rec["queries"]
    failed_by = collections.Counter(q["failed"] for q in queries
                                    if q["failed"] is not None)
    failed = sum(failed_by.values())

    device = {"platform": "gpu" if args.device == "cuda" else "cpu",
              "kind": rec["kind"], "count": 1 if args.device == "cuda" else 0,
              "memory_peak_bytes": rec["memory_peak_bytes"]}
    if args.device == "cuda":
        device["power_limit"] = power_limit()
    out = {"correct": correct, "attempted": len(queries), "failed": failed,
           "metrics": read_metrics(cell_metrics(bench, wl["name"],
                                                bool(args.trace)),
                                   rec, args.device),
           "device": device}
    dev = rec["device_trace"]
    if args.trace and dev is not None:
        device["busy_s"] = dev["busy_s"]
        device["window_s"] = dev["window_s"]
        ops = sorted(dev["kernels"].items(), key=lambda x: -x[1][0])[:10]
        out["breakdown"] = {
            "device_ops": [[name, s] for name, (s, _) in ops],
            "idle_gaps": devtrace.attribute_gaps(
                dev["gaps"], rec["spans"], rec["harness_spans"]),
        }
    lat = sorted(rec["lateness"])
    out["generator"] = {
        "sent": len(lat), "failed_by": dict(failed_by),
        "late_p50_ms": lat[len(lat) // 2] * 1e3 if lat else 0.0,
        "late_max_ms": lat[-1] * 1e3 if lat else 0.0,
        "drain_s": rec["drain_s"], "update_batches": len(rec["updates"]),
        "ticks": tick_summary(rec),
        "sched": rec["sched"], "workers": rec["workers"],
        "latency_ms": {f"p{q}": record.percentile(record.latencies_ms(rec), q)
                       for q in (50, 90, 95, 99)},
        "slowest": [[q["s"], q["t"], q["due"], q["latency"] * 1e3,
                     q["iterations"]]
                    for q in sorted(queries, key=lambda q: -q["latency"])[:5]],
    }
    out["checks"] = checks
    for name, c in checks.items():
        log(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(out), flush=True)
    return 0


def tick_summary(rec) -> dict:
    """How the window's ticks held the host loop: their count, their sum,
    and each that held it past half a second, at its start in the window
    (seconds)."""
    ticks = [(a - rec["t0"], b - a) for name, a, b in rec["harness_spans"]
             if name == "harness.tick"]
    return {"n": len(ticks), "sum_s": sum(d for _, d in ticks),
            "long": [[a, d] for a, d in ticks if d > 0.5]}


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    import subprocess

    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"unread: {e}"


if __name__ == "__main__":
    sys.exit(main())
