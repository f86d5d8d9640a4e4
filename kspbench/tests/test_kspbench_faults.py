"""The check must fail what it exists to catch.

Each test drives the rest of a run (set-up, window, drain, the
comparison with the reference) on the CPU, with the card's look skipped
(``device="cpu"``, the plain engine) at a size a test can hold, with a
fault planted underneath, and sees ``correct`` come out false.  The
control (the reference with its simple-path guarantee dropped, in the
program's place) is held the same way; on the card it is read at each
cell's own size by ``kspbench/control.py``.

No cell carries a weight feed yet, but the window, the record and the
reference replay update batches for the one that will; a feed source
written here (one batch a second, 30% of the edges each) drives that
path, in both of the program's update modes."""

import time

import numpy as np
import pytest

from kspbench import cell, control, reference, roadgen, run

SMALL = {**cell.load_json("configs", "roadgrid64-barrier"),
         "rows": 16, "cols": 16, "z": 16}
OPEN = {"kind": "open_poisson", "rate_qps": 4.0, "k": 3, "lo": 6, "hi": 12,
        "trace_seed": 5, "jitter_s": 0.1}
FEED = "feed"


class FeedSource:
    """One update batch a second, from a phase and a stream drawn from the
    seed, after one warm batch from a fixed stream."""

    def __init__(self, net, rng, seconds):
        phase = float(rng.uniform(0.0, 1.0))
        stream = roadgen.WeightUpdateStream(
            net, alpha=0.3, tau=0.5, seed=int(rng.integers(0, 2**63)))
        self.events = []
        for i in range(int(seconds)):
            eids, new_w = stream.next_batch()
            self.events.append({"kind": "update", "due": phase + i,
                                "eids": eids, "new_w": new_w})
        warm = roadgen.WeightUpdateStream(net, alpha=0.3, tau=0.5, seed=7)
        self.warm_batches = [warm.next_batch()]

    def initial(self):
        return list(self.events)

    def answered(self, event, now):
        return []


_make_sources = cell.make_sources


def _sources(streams, net, seed, seconds):
    out = _make_sources({"streams": [s for s in streams if s != FEED]},
                            net, seed, seconds)
    if FEED in streams:  # the generator a second stream of the mix gets
        out.append(FeedSource(net, np.random.default_rng(
            np.random.SeedSequence([seed % 2**64, 1])), seconds))
    return out


def _run(streams, *, update_mode="streaming", seconds=4.0, drain_s=20.0):
    cfg = {**SMALL, "update_mode": update_mode}
    cell.make_sources = lambda traffic, net, seed, secs: _sources(
        streams, net, seed, secs)
    try:
        rec = cell.run_cell(cfg, {"streams": [OPEN]}, seed=2**31 + 77,
                            seconds=seconds, trace=False, device="cpu",
                            drain_s=drain_s, t_start=time.perf_counter(),
                            log=lambda m: None)
    finally:
        cell.make_sources = _make_sources
    checks = run.compared(rec)
    return all(c["value"] <= c["limit"] for c in checks.values()), checks


@pytest.mark.parametrize("mode", ["barrier", "streaming"])
def test_sound_run_is_correct(mode):
    ok, checks = _run([OPEN, FEED], update_mode=mode)
    assert ok, checks


def test_answer_altered_where_produced(monkeypatch):
    from repro_torch.dist import scheduler

    orig = scheduler.QueryScheduler._advance

    def altered(self, tk, seg_lists):
        orig(self, tk, seg_lists)
        if tk.done and tk.result and tk.qid % 3 == 0:
            d, p = tk.result[-1]
            tk.result[-1] = (d * 1.001, p)

    monkeypatch.setattr(scheduler.QueryScheduler, "_advance", altered)
    ok, checks = _run([OPEN])
    assert not ok and checks["dist_gap"]["value"] > reference.LIMITS[
        "dist_gap"]


@pytest.mark.parametrize("mode", ["barrier", "streaming"])
def test_update_step_returns_state_unchanged(monkeypatch, mode):
    """The epoch advances, the weights stay: answers stamped with the new
    epoch are the old epoch's."""
    from repro_torch.dist.cluster import Cluster

    name = "apply_updates" if mode == "barrier" else "apply_updates_streaming"
    orig = getattr(Cluster, name)

    def unchanged(self, eids, new_w, **kw):
        return orig(self, eids, self.dtlp.graph.w[np.asarray(eids)], **kw)

    monkeypatch.setattr(Cluster, name, unchanged)
    ok, checks = _run([OPEN, FEED], update_mode=mode)
    assert not ok, checks


def test_half_of_the_answers_left_out(monkeypatch):
    from repro_torch.service.service import KSPService

    orig = KSPService.tick

    def halved(self):
        return [tk for tk in orig(self) if tk.qid % 2 == 0]

    monkeypatch.setattr(KSPService, "tick", halved)
    ok, checks = _run([OPEN], drain_s=2.0)
    assert not ok and checks["unanswered"]["value"] > 0


@pytest.mark.parametrize("sound", [False, True])
def test_control_fails_the_check(sound):
    net = cell.build_net(SMALL)
    sources = _sources([OPEN, FEED], net, 5, 10.0)
    w_base = reference.weights_at(net.w0, sources[1].warm_batches, 1)
    batches = [(e["eids"], e["new_w"]) for e in sources[1].initial()]
    answers = control.control_answers(net, sources, batches, sound=sound,
                                      w_base=w_base)
    adj = reference.Adjacency(net.n, net.edge_u, net.edge_v)
    v = reference.judge(adj, w_base, batches, answers)
    failed = (v["wrong_answers"] > reference.LIMITS["wrong_answers"]
              or v["dist_gap"] > reference.LIMITS["dist_gap"])
    assert failed != sound, v
