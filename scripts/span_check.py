#!/usr/bin/env python3
"""One traced run of a benchmark cell, and what the program's spans say
beside the device trace.

    python3 scripts/span_check.py --workload city-open --seed N \
        [--seconds 51] [--device cuda|cpu] [--out FILE]

Runs ``kspbench/run.py``'s ``main`` in this process with ``--trace 1``
(its result line is printed as usual), keeps the run's record and the
profiler's raw device activity, and writes to FILE (default
``chiprun_out/span_check_<seed>.json``), with ``cover`` and ``align``
also on standard error:

- ``spans``: seconds and count of each program span, over the window
  and the drain;
- ``cover``: the share of Σ(admit + splice) that the KSP-DG stepper's
  spans cover, as the union of their intervals (a ``ref_next`` inside a
  ``stop_scan`` counted once), and the plain sum Σ(skeleton + ref_build
  + ref_next + join) over Σ(admit + splice);
- ``align``: of the window's device-to-host copies, the share whose
  midpoint lies inside a ``collect_round`` span widened by ``SLACK_S``
  on each side, with the copies mapped to the host clock as
  ``kspbench/devtrace.py`` maps the device's idle gaps (and their signed
  offsets from the nearest span), and mapped through the profiler's own
  clock (Unix time, read beside ``time.perf_counter`` just before the
  window's marker); the copies paired in order with the
  ``collect_round`` spans (two copies each) and each pair's distance on
  that clock; and the marker's launch lag, the difference of the two
  mappings (the device trace exists on the card only);
- ``wall_s``: the run's wall time.

Exits with ``main``'s code.
"""

from __future__ import annotations

import argparse
import bisect
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(REPO), str(REPO / "src")]

from kspbench import cell, devtrace  # noqa: E402
from kspbench import run as bench_run  # noqa: E402

#: the stepper's spans, nested inside the scheduler's admit and splice
STEPPER = ("skeleton", "ref_build", "ref_next", "cohort", "join",
           "stop_scan")
#: how far (seconds) a copy's midpoint may lie outside its span
SLACK_S = 1e-4


def union(intervals) -> list:
    """Sorted disjoint union of (start, end) intervals."""
    out: list = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def overlap_s(a, b) -> float:
    """Seconds shared by two sorted disjoint interval lists."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0.0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def cover(spans: dict) -> dict:
    def total(name):
        return sum(e - s for s, e in spans.get(name, []))

    outer = union([iv for n in ("admit", "splice") for iv in spans.get(n, [])])
    inner = union([iv for n in STEPPER for iv in spans.get(n, [])])
    outer_s = sum(e - s for s, e in outer)
    plain = sum(total(n) for n in ("skeleton", "ref_build", "ref_next",
                                   "join"))
    return {"admit_splice_s": outer_s,
            "union_share": overlap_s(outer, inner) / outer_s if outer_s
            else None,
            "plain_share": plain / outer_s if outer_s else None}


def _share_inside(mids, ivs) -> tuple:
    """Of the midpoints, the share inside a span widened by ``SLACK_S``,
    and every midpoint's signed distance to its nearest span (0 inside;
    negative before the next span, positive after the last one)."""
    starts = [s for s, _ in ivs]
    offsets = []
    for m in mids:
        i = bisect.bisect_right(starts, m) - 1
        if i >= 0 and m <= ivs[i][1]:
            offsets.append(0.0)
            continue
        cand = [m - ivs[i][1]] if i >= 0 else []
        if i + 1 < len(ivs):
            cand.append(m - ivs[i + 1][0])
        offsets.append(min(cand, key=abs) if cand else float("inf"))
    inside = sum(abs(o) <= SLACK_S for o in offsets)
    return (inside / len(mids) if mids else None), offsets


def align(events, t_mark: float, window_s: float, collects,
          clock_pair) -> dict:
    """Device-to-host copies of the window against ``collect_round``,
    under two mappings of the device's timestamps to the host clock:
    ``devtrace``'s (the marker's device start taken as ``t_mark``) and
    the profiler clock's own (its timestamps are Unix microseconds:
    ``clock_pair`` is a ``(time.time_ns(), time.perf_counter())`` pair
    read just before the marker's launch)."""
    origin = events[0][1]  # the marker, as devtrace.read takes it
    end = origin + window_s * 1e6
    copies = [(s + e) / 2 for name, s, e in events[1:]
              if "DtoH" in name and s < end]
    ns, pc = clock_pair

    def unix(us):
        return pc + (us * 1e3 - ns) / 1e9

    ivs = union(collects)
    share, offsets = _share_inside(
        [t_mark + (us - origin) / 1e6 for us in copies], ivs)
    # each collect_round copies twice (dist, parent): pair the window's
    # copies with the spans in order, and time each pair's drift
    mapped = sorted(unix(us) for us in copies)
    spans = sorted(c for c in collects if c[0] < unix(end))
    drift = sorted(abs(m - (a + b) / 2) * 1e6
                   for m, (a, b) in zip(mapped[::2], spans))
    return {"copies": len(copies), "slack_s": SLACK_S,
            "share_devtrace": share, "offset_us_p5_p50_p95": _pcts(offsets),
            "share_unix_clock": _share_inside(mapped, ivs)[0],
            "collect_rounds": len(spans),
            "pair_drift_us_p5_p50_p95": _pcts(drift, 1.0),
            # how much later the marker ran than devtrace takes it to
            "marker_lag_us": (unix(origin) - t_mark) * 1e6}


def _pcts(values, scale=1e6):
    """The 5th, 50th and 95th percentiles of ``values`` times ``scale``."""
    q = sorted(values)
    return ([q[int(f * (len(q) - 1))] * scale for f in (0.05, 0.5, 0.95)]
            if q else None)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    kept: dict = {}
    read_events, mark = devtrace._events, devtrace.mark
    run_cell = cell.run_cell

    def keep_mark(torch, dev):
        kept["clock_pair"] = (time.time_ns(), time.perf_counter())
        return mark(torch, dev)

    def keep_events(prof):
        kept["events"] = read_events(prof)
        return kept["events"]

    def keep_record(*a, **kw):
        kept["rec"] = run_cell(*a, **kw)
        return kept["rec"]

    devtrace._events, devtrace.mark = keep_events, keep_mark
    cell.run_cell = keep_record
    t0 = time.perf_counter()
    try:
        rc = bench_run.main(["--workload", args.workload, "--seed",
                             str(args.seed), "--seconds", str(args.seconds),
                             "--trace", "1", "--device", args.device])
    finally:
        devtrace._events, devtrace.mark = read_events, mark
        cell.run_cell = run_cell
    wall = time.perf_counter() - t0
    rec = kept.get("rec")
    if rec is None:
        return rc or 1
    spans = rec["spans"]
    out = {"workload": args.workload, "seed": args.seed, "rc": rc,
           "device": rec["kind"], "wall_s": wall,
           "spans": {n: [sum(e - s for s, e in ivs), len(ivs)]
                     for n, ivs in sorted(spans.items())},
           "cover": cover(spans), "align": None}
    if kept.get("events"):
        out["align"] = align(kept["events"], rec["t0"], rec["seconds"],
                             spans.get("collect_round", []),
                             kept["clock_pair"])
    path = Path(args.out or REPO / "chiprun_out" /
                f"span_check_{args.seed}.json")
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out, indent=1))
    print(json.dumps({k: out[k] for k in ("seed", "wall_s", "cover",
                                          "align")}), file=sys.stderr)
    return rc


if __name__ == "__main__":
    sys.exit(main())
