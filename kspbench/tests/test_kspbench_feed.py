"""The feed cell's harness: the ``update_feed`` traffic kind, its warm
batches, its readers, and a run of the cell's mix on the CPU.

``test_kspbench_metrics.py`` checks every reader under ``metrics/``
against its table ``WANT`` on its own record, the feed cell's three own
readers included; this file checks their numbers on a record of its own.
Besides those the feed cell reads the metrics every cell reads, through
the same entries and readers (``test_kspbench_metrics.py::
test_folded_entry``)."""

import math
import time

import numpy as np
import pytest

from kspbench import cell, reference, roadgen, run
from kspbench.tests import test_kspbench_metrics as base

FEED = cell.load_json("traffic", "feed-streaming")["streams"][1]
SMALL = {**cell.load_json("configs", "roadgrid64-streaming"),
         "rows": 16, "cols": 16, "z": 16}

@pytest.fixture(scope="module")
def net():
    return roadgen.grid_road_network(16, 16, seed=4)


def _feed(net, seed, seconds=51.0, **over):
    mix = {"streams": [{**FEED, **over}]}
    (src,) = cell.make_sources(mix, net, seed, seconds)
    return src


def test_feed_file_is_the_named_feed():
    assert FEED["kind"] == "update_feed"
    assert (FEED["period_s"], FEED["alpha"], FEED["tau"],
            FEED["warm_batches"]) == (2.0, 0.05, 0.2, 2)


@pytest.mark.parametrize("seed", [0, 2**31 + 11, 3_000_000_000])
def test_update_feed_schedule(net, seed):
    src = _feed(net, seed)
    evs = src.initial()
    assert len(evs) == 25
    dues = [e["due"] for e in evs]
    assert dues == sorted(dues) and dues[-1] < 51.0
    for i, e in enumerate(evs):
        assert e["kind"] == "update"
        assert abs(e["due"] - 2.0 * (i + 1)) <= 0.1
        assert e["eids"].shape == e["new_w"].shape == (int(0.05 * net.m),)
        ratio = e["new_w"] / net.w0[e["eids"]]
        lifted = e["new_w"] > 0.25
        assert np.all((ratio[lifted] >= 0.8) & (ratio[lifted] <= 1.2))
    assert src.answered(evs[0], 1.0) == []


def test_update_feed_replays_one_trace(net):
    """Every seed sends the same batches in the same order, the warm ones
    first; the seed moves only due times, each by at most jitter_s."""
    a, b = _feed(net, 1), _feed(net, 2**31 + 5)
    stream = roadgen.WeightUpdateStream(net, alpha=0.05, tau=0.2,
                                        seed=FEED["stream_seed"])
    want = [stream.next_batch() for _ in range(27)]
    for src in (a, b):
        got = src.warm_batches + [(e["eids"], e["new_w"])
                                  for e in src.initial()]
        assert len(got) == 27
        for (ge, gw), (we, ww) in zip(got, want):
            assert np.array_equal(ge, we) and np.array_equal(gw, ww)
    assert [e["due"] for e in a.initial()] != [e["due"] for e in b.initial()]
    c = _feed(net, 1, stream_seed=FEED["stream_seed"] + 1)
    assert not np.array_equal(c.initial()[0]["eids"], a.initial()[0]["eids"])


def test_warm_batches_applied_in_set_up():
    net = cell.build_net(SMALL)
    src = _feed(net, 7)
    qstream = cell.load_json("traffic", "feed-streaming")["streams"][0]
    srv = cell.set_up(SMALL, net, qstream, src.warm_batches, "cpu",
                      lambda m: None)
    assert srv.epoch_base == 2 and srv.svc.epoch == 2
    w = reference.weights_at(net.w0, src.warm_batches, 2)
    assert np.array_equal(srv.w_base, w)
    assert np.array_equal(srv.svc.dtlp.graph.w, w)


def _rec():
    rec = base._rec()
    rec["updates"] = [(2.0, 2.0, 2.05), (4.0, 4.01, 4.09), (6.0, 6.0, 6.2),
                      (8.0, 8.0, None)]
    rec["spans"] = {**rec["spans"],
                    "epoch_prepare": [(2.0, 2.03), (4.01, 4.05),
                                      (6.0, 6.05)],
                    "tree_repair": [(2.04, 2.046), (6.1, 6.103)]}
    return rec


FEED_WANT = {
    "update_visible_p50_ms.feed": 90.0,
    "epoch_prepare_ms_per_batch.feed": 120.0 / 3,
    "tree_repair_ms_per_batch.feed": 9.0 / 3,
}


_read = base._read


@pytest.mark.parametrize("name", sorted(FEED_WANT))
def test_feed_reader(name):
    assert base.LISTED[name]["workloads"] == ["feed-streaming"]
    assert _read(name, _rec()) == pytest.approx(FEED_WANT[name])


@pytest.mark.parametrize("name", sorted(FEED_WANT))
def test_feed_reader_with_nothing_to_read(name):
    """No feed, no span and no answer: every reader returns None."""
    rec = base._rec()
    rec.update(updates=[], spans={})
    rec["queries"] = [q for q in rec["queries"] if q["failed"]]
    assert _read(name, rec) is None


def test_visible_counts_a_batch_never_visible_as_inf():
    rec = _rec()
    rec["updates"] = [(2.0, 2.0, None), (4.0, 4.0, None), (6.0, 6.0, 6.1)]
    assert _read("update_visible_p50_ms.feed", rec) == math.inf


@pytest.mark.parametrize("mode", ["barrier", "streaming"])
def test_feed_mix_runs_correct_on_the_cpu(mode):
    """The cell's own mix (its trip trace and its feed kind, at a 4-s
    window with a 1-s period) on a 16x16 grid, through the whole run and
    the comparison with the reference: ``correct``, and every batch
    visible."""
    mix = cell.load_json("traffic", "feed-streaming")
    streams = [{**mix["streams"][0], "rate_qps": 4.0, "lo": 6, "hi": 12},
               {**mix["streams"][1], "period_s": 1.0}]
    rec = cell.run_cell({**SMALL, "update_mode": mode}, {"streams": streams},
                        seed=2**31 + 27, seconds=4.0, trace=False,
                        device="cpu", drain_s=30.0,
                        t_start=time.perf_counter(), log=lambda m: None)
    checks = run.compared(rec)
    assert all(c["value"] <= c["limit"] for c in checks.values()), checks
    assert len(rec["updates"]) == 3
    assert all(vis is not None for _, _, vis in rec["updates"])
