"""The index's lower bounds under a live weight feed.

A service is fed 5% of a 16x16 grid's edges per batch, each moved to its
initial weight times U[0.8, 1.2] (τ = 0.2, the paper's §6.4.1 dynamics),
with queries in flight at every handoff, in both update modes.  After
every batch:

(i)   every maintained bound, each subgraph's ``lbd`` and each skeleton
      edge weight, is at or below the true shortest distance between
      its boundary vertices inside its subgraph, computed here by a
      Dijkstra from the current weights;
(ii)  every served ``(paths, epoch)`` is Yen's k shortest simple paths
      on the weights of the stamped epoch;
(iii) the incremental path (``prepare_updates``/``commit_updates``, or
      ``apply_updates`` in barrier mode) leaves the index bit for bit as
      the wholesale path (``apply_updates(incremental=False)``) does.

Theorem 1's bound (``lbd_mode="paper"``) fails (i) on this trace: the
stored representatives stop being their level's shortest paths as the
weights drift.  Where no update ran, the index and the answers are
``repro``'s, bit for bit.  The maintenance spans (``dtlp_prepare`` with
``bound_refresh`` inside ``epoch_prepare``, ``tree_repair`` inside
``epoch_commit``) are recorded only with tracing on."""

import functools
import heapq

import numpy as np
import pytest

import repro.service as jax_service
from repro.core.dtlp import DTLP as JaxDTLP
from repro.data.roadnet import grid_road_network as jax_grid
from repro_torch import obs
from repro_torch.core.bound_refresh import PairDistances
from repro_torch.core.bounding import lower_bound_distances_vec
from repro_torch.core.dtlp import DTLP
from repro_torch.core.graph import Graph
from repro_torch.core.sssp import graph_view
from repro_torch.core.yen import ksp
from repro_torch.data.roadnet import WeightUpdateStream, grid_road_network
from repro_torch.service import (KSPService, QueryRequest, ServiceConfig,
                                 UpdateBatch)

MODES = ["barrier", "streaming"]
BATCHES = 12
QUERIES_PER_BATCH = 2


@pytest.fixture(autouse=True)
def _obs_reset():
    obs.disable()
    yield
    obs.disable()


def _dijkstra(sg, w, src: int) -> dict:
    """Local-vertex distances from ``src`` inside subgraph ``sg``."""
    dist = {src: 0.0}
    heap = [(0.0, src)]
    done = set()
    while heap:
        du, u = heapq.heappop(heap)
        if u in done:
            continue
        done.add(u)
        for p in range(sg.indptr[u], sg.indptr[u + 1]):
            v, nd = int(sg.nbr[p]), du + w[sg.eid[p]]
            if nd < dist.get(v, np.inf):
                dist[v] = nd
                heapq.heappush(heap, (nd, v))
    return dist


def _truth(d, w) -> list:
    """Per subgraph, each pair's true in-subgraph distance under ``w``."""
    out = []
    for si in d.sub_indexes:
        rows = {int(a): _dijkstra(si.sg, w, int(a))
                for a in np.unique(si.pairs[:, 0])}
        out.append(np.array([rows[int(a)].get(int(b), np.inf)
                             for a, b in si.pairs]))
    return out


def _skeleton_truth(d, truth) -> np.ndarray:
    """Per skeleton edge, the least true distance over its contributing
    (subgraph, pair)s: the largest value a sound weight may take."""
    sk = d.skeleton
    best = np.full(sk.weight.shape[0], np.inf)
    vals = np.array([truth[s][p] for s, p in zip(sk.contrib_sub,
                                                 sk.contrib_pair)])
    np.minimum.at(best, sk.contrib_edge, vals)
    return best


def _index_arrays(d) -> list:
    out = [d.skeleton.weight]
    for si in d.sub_indexes:
        out += [si.lbd, si.path_D, si.path_BD]
    return out


def _is_yen(paths, epoch_w, g, s, t, k) -> bool:
    """The served paths are k shortest simple s-t paths under ``epoch_w``:
    lengths by rank as Yen's (to the float32 rounding the engine's slabs
    hold), each path simple, from s to t, distinct, of its stated length."""
    g.w[:] = epoch_w
    want = ksp(graph_view(g), s, t, k)
    if len(paths) != len(want) or len({p for _, p in paths}) != len(paths):
        return False
    for (dg, p), (dw, _) in zip(paths, want):
        if (p[0], p[-1]) != (s, t) or len(set(p)) != len(p):
            return False
        own = g.path_distance(p)
        if abs(dg - dw) > 1e-6 * dw or abs(dg - own) > 1e-6 * own:
            return False
    return True


@functools.lru_cache(maxsize=None)
def _feed(mode: str) -> dict:
    """Serve the feed in ``mode``; the checks of (i)-(iii) per batch."""
    g = grid_road_network(16, 16, seed=0)
    built = DTLP.build(g, z=16, xi=4)
    # the wholesale path's replay, on a graph of its own
    whole = DTLP.build(grid_road_network(16, 16, seed=0), z=16, xi=4)
    svc = KSPService(built, ServiceConfig(
        engine="dense_bf", device="cpu", n_workers=3, max_in_flight=4,
        update_mode=mode))
    stream = WeightUpdateStream(g, alpha=0.05, tau=0.2, seed=1)
    rng = np.random.default_rng(4)
    weights = {0: g.w.copy()}
    tickets, sound, skel_sound, same = [], [], [], []
    for _ in range(BATCHES):
        for _ in range(QUERIES_PER_BATCH):
            s, t = map(int, rng.choice(g.n, 2, replace=False))
            tickets.append(svc.submit(QueryRequest(s, t, 3)))
            svc.tick()  # in flight across the handoff
        eids, new_w = stream.next_batch()
        svc.update(UpdateBatch(eids, new_w))
        weights[svc.epoch] = g.w.copy()
        whole.apply_updates(eids, new_w, incremental=False)
        d = svc.dtlp
        truth = _truth(d, g.w)
        sound.append(all(np.all(si.lbd <= tr)
                         for si, tr in zip(d.sub_indexes, truth)))
        skel_sound.append(bool(np.all(
            d.skeleton.weight <= _skeleton_truth(d, truth))))
        same.append(all(np.array_equal(a, b) for a, b in
                        zip(_index_arrays(d), _index_arrays(whole))))
    svc.drain()
    g_yen = Graph(g.n, g.edge_u, g.edge_v, g.w0, directed=g.directed)
    exact = [_is_yen(tk.result.paths, weights[tk.result.epoch], g_yen,
                     tk.request.s, tk.request.t, 3) for tk in tickets]
    return {"sound": sound, "skel_sound": skel_sound, "same": same,
            "exact": exact, "epochs": [tk.result.epoch for tk in tickets],
            "dtlp": svc.dtlp, "truth": _truth(svc.dtlp, g.w)}


@pytest.mark.parametrize("mode", MODES)
def test_maintained_bounds_stay_lower_bounds(mode):
    got = _feed(mode)
    assert all(got["sound"]), got["sound"]
    assert all(got["skel_sound"]), got["skel_sound"]


@pytest.mark.parametrize("mode", MODES)
def test_served_answers_are_yen_on_their_epoch(mode):
    got = _feed(mode)
    assert all(got["exact"]), got["exact"]
    assert max(got["epochs"]) >= BATCHES - 1


@pytest.mark.parametrize("mode", MODES)
def test_incremental_equals_wholesale_bitwise(mode):
    assert all(_feed(mode)["same"])


@pytest.mark.parametrize("mode", MODES)
def test_theorem1_bound_leaks_on_the_trace(mode):
    """The trace is a witness of the fault: Theorem 1's bound, computed
    from the same maintained representatives and bound distances, passes
    the true distance at some pair, where the maintained ``lbd`` does
    not."""
    got = _feed(mode)
    leaks = 0
    for si, tr in zip(got["dtlp"].sub_indexes, got["truth"]):
        paper = lower_bound_distances_vec(si.pair_ptr, si.path_D, si.path_BD,
                                          mode="paper")
        leaks += int(np.sum(paper > tr * (1 + 1e-9)))
        assert np.all(si.lbd <= tr)
    assert leaks > 0


def test_fresh_build_and_answers_are_the_reference():
    """No update: the port's index keeps ``repro``'s bounds bit for bit
    and serves ``repro``'s answers."""
    g, jg = grid_road_network(8, 8, seed=3), jax_grid(8, 8, seed=3)
    d, jd = DTLP.build(g, z=12, xi=4), JaxDTLP.build(jg, z=12, xi=4)
    assert np.array_equal(d.skeleton.weight, np.asarray(jd.skeleton.weight))
    for si, jsi in zip(d.sub_indexes, jd.sub_indexes):
        assert np.array_equal(si.lbd, np.asarray(jsi.lbd))
    assert d.update_stats.refreshed_pairs == 0
    rng = np.random.default_rng(8)
    trips = [tuple(map(int, rng.choice(g.n, 2, replace=False)))
             for _ in range(6)]
    svc = KSPService(d, ServiceConfig(engine="dense_bf", device="cpu",
                                      n_workers=2))
    jsvc = jax_service.KSPService(jd, jax_service.ServiceConfig(
        engine="dense_bf", n_workers=2))
    for s, t in trips:
        a, b = svc.query(s, t, 3), jsvc.query(s, t, 3)
        assert (a.paths, a.epoch) == (b.paths, b.epoch)


@pytest.mark.parametrize("directed", [False, True])
def test_pair_distances_are_dijkstra_bitwise(directed):
    """The batched refresh gives each pair the Dijkstra distance from its
    source, bit for bit, under weights that are not integers."""
    g = grid_road_network(10, 10, seed=6, directed=directed)
    d = DTLP.build(g, z=16, xi=3)
    w = g.w0 * np.random.default_rng(2).uniform(0.8, 1.2, g.m)
    pd = PairDistances(d.sub_indexes, "cpu")
    flat = pd(w)
    want = np.concatenate(_truth(d, w))
    assert np.array_equal(flat, want)
    assert 0 < pd.relaxations <= pd.steps


def test_rebaseline_keeps_sound_bounds():
    g = grid_road_network(10, 10, seed=2)
    d = DTLP.build(g, z=16, xi=4)
    stream = WeightUpdateStream(g, alpha=0.3, tau=0.5, seed=2)
    for _ in range(3):
        d.apply_updates(*stream.next_batch())
    d.rebaseline()
    for si, tr in zip(d.sub_indexes, _truth(d, g.w)):
        assert np.all(si.lbd <= tr)
    assert np.all(d.skeleton.weight <= _skeleton_truth(d, _truth(d, g.w)))


@pytest.mark.parametrize("directed", [False, True])
def test_fresh_build_on_weights_that_are_not_integers_keeps_sound_bounds(
        directed):
    """A build on weights that are not integers has unit weights (w over
    its vfrag count) other than 1 from the start, so Theorem 1's bound
    leaks there as after an update: the build caps it as an update does,
    and every bound stays at or below the Dijkstra truth."""
    base = grid_road_network(12, 12, seed=2, directed=directed)
    w = base.w0 * np.random.default_rng(2).uniform(0.8, 1.2, base.m)
    g = Graph(base.n, base.edge_u, base.edge_v, w, directed=directed)
    d = DTLP.build(g, z=16, xi=4)
    truth = _truth(d, g.w)
    leaks = 0
    for si, tr in zip(d.sub_indexes, truth):
        paper = lower_bound_distances_vec(si.pair_ptr, si.path_D, si.path_BD,
                                          mode="paper")
        leaks += int(np.sum(paper > tr * (1 + 1e-9)))
        assert np.all(si.lbd <= tr)
    assert np.all(d.skeleton.weight <= _skeleton_truth(d, truth))
    assert leaks > 0 and d.update_stats.capped_pairs > 0


# ------------------------------------------------------------------ spans
def _traced_handoff(mode: str):
    """Two batches through a traced service with trees in its cache."""
    g = grid_road_network(10, 10, seed=2)
    svc = KSPService.build(g, ServiceConfig(
        engine="dense_bf", device="cpu", n_workers=2, z=16, xi=4,
        update_mode=mode))
    col = obs.enable(trace=True)
    stream = WeightUpdateStream(g, alpha=0.05, tau=0.2, seed=3)
    on_skeleton = np.nonzero(svc.dtlp.skeleton.g2s >= 0)[0]
    for i in range(2):
        svc.query(int(on_skeleton[i]), int(on_skeleton[-1 - i]), 3)
        svc.update(UpdateBatch(*stream.next_batch()))
    obs.disable()
    return col, svc


def _inside(r, outers) -> bool:
    return any(o.ts <= r.ts and r.ts + r.dur <= o.ts + o.dur for o in outers)


def test_maintenance_spans_nest_and_carry_attributes():
    col, svc = _traced_handoff("streaming")
    prep, commit = col.spans("epoch_prepare"), col.spans("epoch_commit")
    dtlp_prep, refresh = col.spans("dtlp_prepare"), col.spans("bound_refresh")
    repair = col.spans("tree_repair")
    assert len(prep) == len(commit) == len(dtlp_prep) == len(refresh) == 2
    assert repair
    assert all(_inside(r, prep) for r in dtlp_prep)
    assert all(_inside(r, dtlp_prep) for r in refresh)
    assert all(_inside(r, commit) for r in repair)
    for r in dtlp_prep:
        assert r.attrs["edges"] > 0 and r.attrs["subgraphs"] > 0
    for r in refresh:
        assert r.attrs["subgraphs"] > 0 and r.attrs["relaxations"] > 0
    st = svc.dtlp.update_stats
    assert sum(r.attrs["kept"] + r.attrs["evicted"] for r in repair) == (
        st.trees_kept + st.trees_evicted) > 0
    assert st.batches == 2 and st.touched_subgraphs > 0
    assert st.refreshed_pairs > 0 and st.refresh_s > 0


def test_barrier_updates_record_the_index_spans():
    col, _ = _traced_handoff("barrier")
    outer = col.spans("apply_updates")
    assert not col.spans("epoch_prepare")
    assert len(col.spans("dtlp_prepare")) == 2
    assert all(_inside(r, outer) for r in col.spans("dtlp_prepare")
               + col.spans("bound_refresh") + col.spans("tree_repair"))


def test_tracing_off_records_nothing_and_reads_no_clock_in_commit(
        monkeypatch):
    g = grid_road_network(10, 10, seed=2)
    d = DTLP.build(g, z=16, xi=4)
    stream = WeightUpdateStream(g, alpha=0.05, tau=0.2, seed=3)
    view = d.skeleton.view()
    cache = d.ref_tree_cache()
    from repro_torch.core.refstream import SidetrackTree

    cache.put(0, SidetrackTree(view, 0))
    plan = d.prepare_updates(*stream.next_batch())
    reads = []
    monkeypatch.setattr(obs, "clock", lambda: reads.append(1) or 0.0)
    d.commit_updates(plan)
    assert reads == [] and obs.get_collector() is None
    assert d.update_stats.trees_kept + d.update_stats.trees_evicted == 1
