"""The traffic kinds' schedules: counts, due times, determinism."""

import json

import pytest

from kspbench import cell, roadgen


@pytest.fixture(scope="module")
def net():
    return roadgen.grid_road_network(20, 20, seed=4)


def _mix(net, streams, seed, seconds):
    return cell.make_sources({"streams": streams}, net, seed, seconds)


OPEN = {"kind": "open_poisson", "rate_qps": 3.0, "k": 3, "lo": 4, "hi": 8,
        "trace_seed": 99, "jitter_s": 0.1}


@pytest.mark.parametrize("seed", [0, 2**31 + 11, 3_000_000_000])
def test_open_poisson_schedule(net, seed):
    (src,) = _mix(net, [OPEN], seed, 20.0)
    evs = src.initial()
    assert len(evs) == 60
    dues = [e["due"] for e in evs]
    assert dues == sorted(dues) and 0 <= dues[0] and dues[-1] < 20.0
    for e in evs:
        assert e["kind"] == "query" and e["k"] == 3
        assert 4 <= roadgen.hop_counts(net, e["s"], 8)[e["t"]] <= 8
    assert src.answered(evs[0], 1.0) == []
    (again,) = _mix(net, [OPEN], seed, 20.0)
    assert again.initial() == evs


def test_open_poisson_replays_one_trace(net):
    """Every seed sends the trace's trips; a seed only moves due times,
    each by at most jitter_s."""
    (a,) = _mix(net, [OPEN], 1, 20.0)
    (b,) = _mix(net, [{**OPEN, "jitter_s": 0.0}], 2, 20.0)
    ea, eb = a.initial(), b.initial()
    assert sorted((e["s"], e["t"]) for e in ea) == sorted(
        (e["s"], e["t"]) for e in eb)
    assert [e["due"] for e in ea] != [e["due"] for e in eb]
    base = {(e["s"], e["t"]): e["due"] for e in eb}
    assert all(abs(e["due"] - base[(e["s"], e["t"])]) <= 0.1 + 1e-12
               for e in ea)
    (c,) = _mix(net, [{**OPEN, "trace_seed": 100}], 1, 20.0)
    assert sorted((e["s"], e["t"]) for e in c.initial()) != sorted(
        (e["s"], e["t"]) for e in ea)


def test_trace_prefix_is_kept(net):
    """A higher rate sends a longer trace whose first trips are the lower
    rate's: no trip of the shorter trace is dropped."""
    (a,) = _mix(net, [OPEN], 3, 20.0)
    (b,) = _mix(net, [{**OPEN, "rate_qps": 6.0}], 3, 20.0)
    short = {(e["s"], e["t"]) for e in a.initial()}
    long = {(e["s"], e["t"]) for e in b.initial()}
    assert len(b.initial()) == 120 and short <= long


@pytest.mark.parametrize("name", sorted(
    p.stem for p in (cell.ROOT / "traffic").glob("*.json")))
def test_traffic_files_name_known_kinds(name):
    mix = json.loads((cell.ROOT / "traffic" / f"{name}.json").read_text())
    for stream in mix["streams"]:
        assert (cell.ROOT / "traffic" / "kinds"
                / f"{stream['kind']}.py").is_file()

