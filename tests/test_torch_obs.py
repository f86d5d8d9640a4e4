"""repro_torch.obs: the recording entry points, the disabled path, the
Chrome export and the flight rings; and the spans inside the serving
stack — the KSP-DG stepper's ``skeleton``, ``ref_build``, ``ref_next``,
``cohort``, ``join`` and ``stop_scan`` nested inside the scheduler's
``admit`` and ``splice``, and
``collect_round`` on the worker tracks, one per refine round."""

import json

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.core.dtlp import DTLP
from repro_torch.core.kspdg import QueryStats, _k_best_joins, ksp_dg
from repro_torch.data.roadnet import grid_road_network
from repro_torch.dist.grouped_yen import _collect_round
from repro_torch.engine import layout
from repro_torch.obs.recorder import FlightRecorder
from repro_torch.obs.trace import Record
from repro_torch.service import KSPService, QueryRequest, ServiceConfig

#: the stepper's spans, and the scheduler spans each must lie inside
_INSIDE = {"skeleton": ("admit",), "ref_build": ("admit",),
           "join": ("splice",), "stop_scan": ("splice",),
           "ref_next": ("admit", "splice"), "cohort": ("admit", "splice")}


@pytest.fixture(autouse=True)
def _obs_reset():
    """obs state is process-global: every test starts and ends disabled."""
    obs.disable()
    yield
    obs.disable()


@pytest.fixture(scope="module")
def grid():
    g = grid_road_network(10, 10, seed=2)
    return g, DTLP.build(g, z=16, xi=4)


def _trips(n_vertices, n, seed=5):
    rng = np.random.default_rng(seed)
    return [tuple(map(int, rng.choice(n_vertices, 2, replace=False)))
            for _ in range(n)]


def _no_clock():
    raise AssertionError("a clock was read with tracing off")


# ------------------------------------------------------------ entry points
def test_span_at_records_the_callers_interval():
    col = obs.enable(trace=True)
    obs.span_at("solve", 5.0, 2.0, worker=3, k=4)
    obs.span_at("splice", 8.0, 0.5, qid=1)
    solve, splice = col.spans("solve")[0], col.spans("splice")[0]
    assert (solve.ts, solve.dur, solve.tid) == (5.0, 2.0, 4)
    assert solve.attrs == {"worker": 3, "k": 4}
    assert (splice.ts, splice.dur, splice.tid) == (8.0, 0.5, 0)


def test_worker_scope_routes_to_one_plus_wid():
    col = obs.enable(trace=True)
    with obs.worker_scope(2):
        obs.span_at("a", 0.0, 1.0)
        with obs.worker_scope(0):
            obs.span_at("b", 1.0, 1.0)
        obs.span_at("c", 2.0, 1.0)
        obs.span_at("d", 3.0, 1.0, worker=5)  # an explicit worker wins
    obs.span_at("e", 4.0, 1.0)
    assert [(r.name, r.tid) for r in col.spans()] == [
        ("a", 3), ("b", 1), ("c", 3), ("d", 6), ("e", 0)]


def test_disabled_path_records_nothing():
    assert not obs.enabled() and obs.get_collector() is None
    obs.span_at("solve", 0.0, 1.0, worker=0)
    assert obs.flight_dump("why") is None
    with pytest.raises(RuntimeError):
        obs.export("unused.json")
    col = obs.enable(trace=True)
    assert len(col) == 0
    obs.disable()
    obs.span_at("solve", 0.0, 1.0)
    assert len(col) == 0 and obs.get_collector() is None


def test_removed_entry_points_are_gone():
    for name in ("event", "span", "traced", "NOOP_SPAN"):
        assert not hasattr(obs, name)
        assert name not in obs.__all__


def test_chrome_export_ts_monotone_per_track(tmp_path):
    col = obs.enable(trace=True)
    for i, (t0, wid) in enumerate([(3.0, 0), (1.0, 1), (2.0, None),
                                   (0.5, 0), (2.5, 1), (0.1, None)]):
        attrs = {} if wid is None else {"worker": wid}
        obs.span_at(f"s{i}", t0, 0.25, **attrs)
    path = tmp_path / "trace.json"
    assert obs.export(str(path)) == 6
    events = json.loads(path.read_text())["traceEvents"]
    by_tid: dict = {}
    for e in events:
        if e["ph"] == "X":
            by_tid.setdefault(e["tid"], []).append(e["ts"])
            assert e["dur"] == pytest.approx(0.25e6)
    assert set(by_tid) == {0, 1, 2}
    for ts in by_tid.values():
        assert ts == sorted(ts)
    names = {e["tid"]: e["args"]["name"] for e in events
             if e["ph"] == "M" and e["name"] == "thread_name"}
    assert names == {0: "service", 1: "worker-0", 2: "worker-1"}


def test_flight_ring_evicts_fifo():
    fr = FlightRecorder(capacity=3)
    for i in range(5):
        fr.record(Record("span", f"s{i}", float(i), 0.5, 1, {}))
    fr.record(Record("span", "other", 9.0, 0.5, 0, {}))
    dump = fr.dump("test", t0=1.0)
    assert dump["recorded"] == 6 and dump["capacity"] == 3
    assert [r["name"] for r in dump["tracks"]["worker-0"]] == ["s2", "s3",
                                                                "s4"]
    assert dump["tracks"]["worker-0"][0]["t"] == 1.0
    assert [r["name"] for r in dump["tracks"]["service"]] == ["other"]


# ------------------------------------------------------ the stepper's spans
def test_stepper_off_path_reads_no_clock(grid, monkeypatch):
    g, d = grid
    want = [ksp_dg(d, s, t, 3, ref_stream="lazy") for s, t in _trips(g.n, 4)]
    monkeypatch.setattr(obs, "clock", _no_clock)
    got = [ksp_dg(d, s, t, 3, ref_stream="lazy") for s, t in _trips(g.n, 4)]
    assert got == want
    pending = (torch.zeros(2, 3, 4), torch.zeros(2, 3, 4, dtype=torch.int32),
               [(0, 1), (1, 2)])
    assert len(_collect_round(pending)) == 2


def test_stepper_spans_and_join_counts(grid):
    g, d = grid
    col = obs.enable(trace=True)
    for s, t in _trips(g.n, 4):
        L, stats = ksp_dg(d, s, t, 3, ref_stream="lazy", return_stats=True)
        mine = [r for r in col.spans() if r.attrs["s"] == s
                and r.attrs["t"] == t]
        col.events.clear()
        names = [r.name for r in mine]
        assert names.count("skeleton") == names.count("ref_build") == 1
        joins = [r for r in mine if r.name == "join"]
        assert len(joins) == stats.iterations >= 1
        assert [r.attrs["iteration"] for r in joins] == list(
            range(1, stats.iterations + 1))
        assert sum(r.attrs["join_pops"] for r in joins) == stats.join_pops
        assert sum(r.attrs["join_paths"] for r in joins) == stats.join_paths
        assert 0 < stats.join_paths <= stats.join_pops
        assert names.count("ref_next") >= stats.references
        assert all(r.tid == 0 for r in mine)


def test_join_counts_pops_and_simple_paths():
    # two segments meeting at 1; the two joins through 0 twice are walks
    segments = [[(1.0, (0, 1)), (2.0, (0, 2, 1))],
                [(1.0, (1, 3)), (5.0, (1, 0, 3))]]
    stats = QueryStats()
    out = _k_best_joins(segments, 4, stats)
    assert out == [(2.0, (0, 1, 3)), (3.0, (0, 2, 1, 3))]
    assert (stats.join_pops, stats.join_paths) == (4, 2)
    assert _k_best_joins(segments, 4) == out  # no stats: nothing counted


def _serve(d, trips, trace: bool):
    """Serve ``trips`` (k=3) on a fresh CPU ``dense_bf`` service; returns
    the answers and, traced, the collector."""
    col = obs.enable(trace=True) if trace else None
    layout.reset_transfer_stats()
    svc = KSPService(d, ServiceConfig(engine="dense_bf", device="cpu",
                                      n_workers=2, max_in_flight=4,
                                      straggler_factor=None))
    tickets = svc.replay([QueryRequest(s, t, 3) for s, t in trips])
    rounds = layout.TRANSFER_STATS["device_rounds"] + \
        layout.TRANSFER_STATS["host_rounds"]
    obs.disable()
    return [(tk.result.paths, tk.result.epoch) for tk in tickets], col, rounds


def _inside(r, outers) -> bool:
    end = r.ts + r.dur
    return any(o.ts <= r.ts and end <= o.ts + o.dur for o in outers)


def test_service_spans_nest_and_answers_match(grid):
    g, _ = grid
    trips = _trips(g.n, 6, seed=9)
    want, _, _ = _serve(DTLP.build(g, z=16, xi=4), trips, trace=False)
    got, col, rounds = _serve(DTLP.build(g, z=16, xi=4), trips, trace=True)
    assert got == want
    spans = {name: col.spans(name) for name in
             ("admit", "splice", "collect_round", *_INSIDE)}
    assert spans["admit"] and spans["splice"]
    for name, outers in _INSIDE.items():
        assert spans[name], name
        pool = [o for oname in outers for o in spans[oname]]
        for r in spans[name]:
            assert r.tid == 0 and _inside(r, pool), (name, r)
    collects = spans["collect_round"]
    assert len(collects) == rounds > 0
    assert all(r.tid >= 1 and r.attrs["jobs"] >= 1 for r in collects)
