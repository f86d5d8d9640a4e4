"""Each metric reader on a synthetic record; ``BENCHMARK.json`` against
the files the harness finds by name; the device trace's reduction on a
stand-in for the profiler.

``WANT`` holds every reader under ``metrics/``, the feed cell's own
readers included (``test_kspbench_feed.py`` checks those on a record of
its own), so this file runs alone."""

import json
import math
import re
from types import SimpleNamespace

import pytest

from kspbench import cell, devtrace, record

BENCH = json.loads((cell.ROOT.parent / "BENCHMARK.json").read_text())
LISTED = {m["name"]: m for m in BENCH["end_to_end"] + BENCH["per_layer"]}
#: every reader under kspbench/metrics, listed in BENCHMARK.json or kept
#: for a cell that is not (yet) there
METRICS = [LISTED.get(p.name[:-3], {"name": p.name[:-3]})
           for p in sorted((cell.ROOT / "metrics").glob("*.py"))]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


#: the KSP-DG stepper's spans and the worker's wait on the card
SPANS = {"skeleton": [(0.0, 0.01)], "ref_build": [(0.01, 0.31)],
         "ref_next": [(0.31, 0.34), (1.0, 1.03)],
         "join": [(1.05, 1.2)], "collect_round": [(0.9, 0.93)]}


def _rec():
    """Four queries due in a 10-s window: three answered, one failed."""
    q = [
        {"due": 0.0, "done": 0.5, "failed": None, "latency": 0.5,
         "iterations": 2},
        {"due": 1.0, "done": 3.0, "failed": None, "latency": 2.0,
         "iterations": 4},
        {"due": 9.0, "done": 11.0, "failed": None, "latency": 2.0,
         "iterations": 6},
        {"due": 9.5, "done": None, "failed": "unanswered",
         "latency": math.inf, "iterations": 0},
    ]
    return {
        "queries": q, "seconds": 10.0, "drain_s": 1.0, "setup_s": 41.5,
        "updates": [(1.0, 1.0, 1.2), (3.0, 3.0, 3.6), (5.0, 5.0, None)],
        "spans": {"queue_wait": [(0.0, 0.9)], "splice": [(0, 0.3), (1, 1.3)],
                  "epoch_prepare": [(1.0, 1.1), (3.0, 3.3)], **SPANS},
        "sched": {"tasks_requested": 40, "tasks_dispatched": 30},
        "workers": {"tasks": 30, "cache_hits": 6},
        "transfer": {"device_rounds": 12, "host_rounds": 0},
        "build": {"bounding_s": 33.0},
        "device_trace": {"busy_s": 0.5, "window_s": 10.0, "gaps": [],
                         "kernels": {"bf_solve_grouped_kernel<8>": (0.2, 9),
                                     "memcpy": (0.3, 20)}},
        "roofline_bound_s": [0.001, 0.001],
    }


#: on the base record; the span readers per answered query (three)
WANT = {
    "answered_qps": 3 / 11.0, "query_p95_ms": math.inf,
    "setup_s": 41.5,
    "queue_wait_share": 100 * 0.9 / 4.5,
    "splice_ms_per_query": 200.0,
    "ksp_iterations_per_query": 4.0,
    "refine_rounds_per_query": 4.0,
    "bf_solve_grouped_roofline": 1.0,
    "device_idle_pct": 95.0, "dtlp_bounding_s": 33.0,
    "ref_build_ms_per_query": 300.0 / 3,
    "ref_next_ms_per_query": 60.0 / 3,
    "join_ms_per_query": 150.0 / 3,
    "device_wait_ms_per_query": 30.0 / 3,
    # batches visible 200 and 600 ms after due, one never; 400 ms of
    # ``epoch_prepare`` over the two applied; no ``tree_repair`` span
    "update_visible_p50_ms.feed": 600.0,
    "epoch_prepare_ms_per_batch.feed": 200.0,
    "tree_repair_ms_per_batch.feed": None,
}

#: each metric that one entry reads in every cell, where the open-loop
#: and the feed cell read it through twin entries before (``<name>.open``
#: and ``<name>.feed``; ``dtlp_bounding_s`` and ``dtlp_bounding_s.feed``):
#: the entry's fields, and what the ``.open`` reader read on ``_rec()``,
#: on ``_rec()`` with its failed query dropped and on ``_bare()``
FOLDED = {
    "query_p95_ms": ("ms", "lower", "host_clock", "scheduler",
                     (math.inf, 2000.0, math.inf)),
    "queue_wait_share": ("%", "lower", "program_span", "scheduler",
                         (20.0, 20.0, None)),
    "splice_ms_per_query": ("ms", "lower", "program_span",
                            "KSP-DG host loop", (200.0, 200.0, None)),
    "ksp_iterations_per_query": ("iterations", "lower", "program_counter",
                                 "KSP-DG host loop", (4.0, 4.0, 4.0)),
    "refine_rounds_per_query": ("rounds", "lower", "program_counter",
                                "worker and refine", (4.0, 4.0, 4.0)),
    "bf_solve_grouped_roofline": ("%", "higher", "device_trace", "kernels",
                                  (1.0, 1.0, None)),
    "device_idle_pct": ("%", "lower", "device_trace", "device",
                        (95.0, 95.0, None)),
    "ref_build_ms_per_query": ("ms", "lower", "program_span",
                               "KSP-DG host loop", (100.0, 100.0, None)),
    "ref_next_ms_per_query": ("ms", "lower", "program_span",
                              "KSP-DG host loop", (20.0, 20.0, None)),
    "join_ms_per_query": ("ms", "lower", "program_span", "KSP-DG host loop",
                          (50.0, 50.0, None)),
    "device_wait_ms_per_query": ("ms", "lower", "program_span",
                                 "worker and refine", (10.0, 10.0, None)),
    "dtlp_bounding_s": ("s", "lower", "program_span", "index build",
                        (33.0, 33.0, 33.0)),
}


def _reporting(metric):
    """The cells that report an end-to-end metric: those its entry lists,
    or every cell."""
    cells = [w["name"] for w in BENCH["workloads"]]
    return LISTED[metric].get("workloads", cells)


#: readers that find nothing to read without the program's spans or a
#: device trace
NEEDS_TRACE = {"queue_wait_share", "splice_ms_per_query", "device_idle_pct",
               "bf_solve_grouped_roofline", "ref_build_ms_per_query",
               "ref_next_ms_per_query", "join_ms_per_query",
               "device_wait_ms_per_query"}


def _bare():
    """A cell without a feed, spans or a device trace."""
    rec = _rec()
    rec.update(updates=[], spans={}, device_trace=None, roofline_bound_s=[])
    return rec


def _read(name, rec):
    return cell.load_module(cell.ROOT / "metrics" / f"{name}.py").read(rec)


def test_every_metric_is_checked_here():
    assert {m["name"] for m in METRICS} == set(WANT)
    assert set(LISTED) <= set(WANT)


@pytest.mark.parametrize("m", METRICS, ids=lambda m: m["name"])
def test_reader(m):
    mod = cell.load_module(cell.ROOT / "metrics" / f"{m['name']}.py")
    assert mod.UNIT == m.get("unit", mod.UNIT)
    assert mod.read(_rec()) == pytest.approx(WANT[m["name"]])


@pytest.mark.parametrize("m", METRICS, ids=lambda m: m["name"])
def test_reader_with_nothing_to_read(m):
    """A cell without a feed, spans or a device trace: a reader returns
    a number or nothing, never 0 for a share of a roofline.  A span
    reader also returns nothing where no query was answered."""
    value = _read(m["name"], _bare())
    if m["name"] in NEEDS_TRACE:
        assert value is None
        if m["source"] == "program_span":
            rec = _rec()
            rec["queries"] = [q for q in rec["queries"] if q["failed"]]
            assert _read(m["name"], rec) is None


@pytest.mark.parametrize("name", sorted(FOLDED))
def test_folded_entry(name):
    """One entry and one reader where the open-loop and the feed cell had
    twins: the entry lists every cell that reports the metric it moves and
    keeps the twins' fields, and the reader gives the ``.open`` reader's
    number on the same records."""
    unit, better, source, layer, want = FOLDED[name]
    entry = LISTED[name]
    assert entry["workloads"] == _reporting(entry["moves"])
    assert (entry["unit"], entry["better"], entry["source"],
            entry["layer"]) == (unit, better, source, layer)
    assert entry["moves"] == ("setup_s" if name == "dtlp_bounding_s"
                              else "answered_qps")
    answered = _rec()
    answered["queries"] = [q for q in answered["queries"] if not q["failed"]]
    for rec, value in zip((_rec(), answered, _bare()), want):
        got = _read(name, rec)
        assert got is None if value is None else got == pytest.approx(value)
    twins = {f"{name}.open", f"{name}.feed"}
    assert not twins & set(LISTED)
    assert not any((cell.ROOT / "metrics" / f"{t}.py").exists()
                   for t in twins)


def test_percentile_nearest_rank():
    assert record.percentile([3, 1, 2, 4], 50) == 2
    assert record.percentile(list(range(1, 101)), 95) == 95
    assert record.percentile([1.0, math.inf], 95) == math.inf
    assert record.percentile([], 50) == math.inf


def test_tick_summary():
    from kspbench import run

    rec = {"t0": 10.0, "harness_spans": [
        ("harness.tick", 10.5, 10.6), ("harness.submit", 11.0, 11.1),
        ("harness.tick", 12.0, 14.0), ("harness.idle", 14.0, 15.0)]}
    out = run.tick_summary(rec)
    assert out["n"] == 2
    assert out["sum_s"] == pytest.approx(2.1)
    assert out["long"] == [[2.0, 2.0]]


def test_benchmark_json_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    names = [c["name"] for c in BENCH["configs"]]
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("kspbench/configs/")
        cfg = json.loads((cell.ROOT.parent / c["file"]).read_text())
        assert set(c["reduced"]) <= set(cfg) and cfg["reduced"] == c["reduced"]
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in names and w["chips"] == 1
        assert len(w["why"]) <= 200
        assert (cell.ROOT / "traffic" / f"{w['traffic']}.json").is_file()
        reported = [m for m in BENCH["end_to_end"]
                    if w["name"] in m.get("workloads", [w["name"]])]
        assert len(reported) >= 2
        assert any(w["name"] in m.get("workloads", [w["name"]])
                   for m in BENCH["per_layer"])
    for m in LISTED.values():
        assert NAME.match(m["name"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= {w["name"]
                                               for w in BENCH["workloads"]}
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        moved = next(e for e in BENCH["end_to_end"] if e["name"] == m["moves"])
        for w in m["workloads"]:
            assert w in moved.get("workloads", [w])
    assert len(json.dumps(BENCH)) < 64 * 1024


class _Ev:
    def __init__(self, name, start_us, dur_us, cuda=True):
        from torch.autograd import DeviceType

        self._n, self._s, self._d = name, start_us, dur_us
        self._t = DeviceType.CUDA if cuda else DeviceType.CPU

    def name(self):
        return self._n

    def device_type(self):
        return self._t

    def start_ns(self):
        return int(self._s * 1000)

    def duration_ns(self):
        return int(self._d * 1000)


class _Prof:
    def __init__(self, events):
        self.profiler = SimpleNamespace(kineto_results=SimpleNamespace(
            events=lambda: events))

    def __exit__(self, *exc):
        return False


def test_device_trace_reduction():
    # marker at 1000 us; a 1-s window; overlapping kernel and copy; one
    # kernel past the window's end; a host event that must be ignored
    events = [_Ev("fill", 1000, 2), _Ev("bf_solve_grouped_kernel", 1100, 300),
              _Ev("Memcpy HtoD", 1300, 200), _Ev("cpu_op", 1200, 50, False),
              _Ev("bf_solve_grouped_kernel", 500000, 100),
              _Ev("late", 2_000_000, 10)]
    dev = devtrace.read(_Prof(events), t_mark=7.0, window_s=1.0)
    assert dev["busy_s"] == pytest.approx((400 + 100) / 1e6)
    assert dev["kernels"]["bf_solve_grouped_kernel"][1] == 2
    assert "late" not in dev["kernels"]
    gaps = dev["gaps"]
    assert gaps[0] == pytest.approx((7.0, 7.0 + 100e-6))
    assert gaps[-1][1] == pytest.approx(8.0)
    assert devtrace.read(_Prof([]), 0.0, 1.0) is None


def test_idle_gaps_by_host_activity():
    gaps = [(0.0, 1.0), (2.0, 2.5), (3.0, 3.2)]
    spans = {"splice": [(0.2, 0.9)], "queue_wait": [(0.0, 4.0)],
             "solve": [(2.0, 2.6)], "admit": [(2.1, 2.4)]}
    harness = [("harness.idle", 2.9, 3.5)]
    got = dict(devtrace.attribute_gaps(gaps, spans, harness))
    assert got == pytest.approx({"splice": 1.0, "admit": 0.5,
                                 "harness.idle": 0.2})
