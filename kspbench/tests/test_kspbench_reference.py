"""The plain reference against brute-force enumeration on tiny graphs,
and the comparison against answers altered on purpose."""

import itertools

import numpy as np
import pytest

from kspbench import reference as R
from kspbench import roadgen


def _all_simple_paths(adj, s, t):
    out, stack = [], [(s, (s,))]
    while stack:
        u, path = stack.pop()
        if u == t:
            out.append(path)
            continue
        for v, _ in adj.out[u]:
            if v not in path:
                stack.append((v, path + (v,)))
    return out


def _walk_lengths(adj, w, s, t, bound):
    """Lengths of every s-t walk no longer than ``bound``."""
    out, stack = [], [(s, 0.0)]
    while stack:
        u, d = stack.pop()
        if u == t:
            out.append(d)
        for v, e in adj.out[u]:
            if d + w[e] <= bound:
                stack.append((v, d + w[e]))
    return out


def _tiny(seed, directed=False):
    rng = np.random.default_rng(seed)
    n = 7
    pairs = [(u, v) for u, v in itertools.permutations(range(n), 2)
             if directed or u < v]
    keep = [p for p in pairs if rng.random() < 0.45]
    u, v = zip(*keep)
    w = rng.integers(1, 6, len(keep)).astype(float)  # integer: many ties
    return R.Adjacency(n, u, v, directed), w.tolist()


@pytest.mark.parametrize("seed", range(12))
@pytest.mark.parametrize("directed", [False, True])
def test_ksp_equals_brute_force(seed, directed):
    adj, w = _tiny(seed, directed)
    for s, t in [(0, 6), (1, 5), (2, 3)]:
        paths = _all_simple_paths(adj, s, t)
        want = sorted(R.path_length(adj, w, p) for p in paths)[:4]
        got = R.ksp(adj, w, s, t, 4)
        assert [d for d, _ in got] == want
        assert len({p for _, p in got}) == len(got)
        for d, p in got:
            assert len(set(p)) == len(p) and p[0] == s and p[-1] == t
            assert R.path_length(adj, w, p) == d


@pytest.mark.parametrize("seed", range(6))
def test_walks_equal_brute_force(seed):
    adj, w = _tiny(seed)
    for s, t in [(0, 6), (1, 5)]:
        simple = R.ksp(adj, w, s, t, 3)
        if len(simple) < 3:
            continue
        # simple paths are walks: the 3 shortest walks are no longer
        want = sorted(_walk_lengths(adj, w, s, t, simple[-1][0]))[:3]
        got = R.k_shortest_walks(adj, w, s, t, 3)
        assert [d for d, _ in got] == want
        for d, p in got:
            assert p[0] == s and p[-1] == t
            assert R.path_length(adj, w, p) == d


def test_weights_at_replays_in_order():
    w0 = np.array([1.0, 2.0, 3.0])
    batches = [(np.array([0, 2]), np.array([5.0, 6.0])),
               (np.array([2]), np.array([7.0]))]
    assert R.weights_at(w0, batches, 0).tolist() == [1.0, 2.0, 3.0]
    assert R.weights_at(w0, batches, 1).tolist() == [5.0, 2.0, 6.0]
    assert R.weights_at(w0, batches, 2).tolist() == [5.0, 2.0, 7.0]


def _answers(net, adj, w, trips, k=3, epoch=0):
    return [{"s": s, "t": t, "k": k, "paths": R.ksp(adj, w, s, t, k),
             "epoch": epoch, "epoch_lo": epoch, "epoch_hi": epoch}
            for s, t in trips]


@pytest.fixture(scope="module")
def grid():
    net = roadgen.grid_road_network(12, 12, seed=3)
    adj = R.Adjacency(net.n, net.edge_u, net.edge_v)
    trips = roadgen.local_trips(net, 20, np.random.default_rng(1), 4, 8)
    return net, adj, trips


def test_judge_passes_the_reference(grid):
    net, adj, trips = grid
    v = R.judge(adj, net.w0, [], _answers(net, adj, net.w0.tolist(), trips))
    assert v["wrong_answers"] == 0 and v["dist_gap"] == 0.0


@pytest.mark.parametrize("alter", ["length", "path", "drop", "epoch",
                                   "stale"])
def test_judge_catches_an_altered_answer(grid, alter):
    net, adj, trips = grid
    stream = roadgen.WeightUpdateStream(net, alpha=0.3, tau=0.5, seed=2)
    batches = [stream.next_batch()]
    w1 = R.weights_at(net.w0, batches, 1).tolist()
    answers = _answers(net, adj, w1, trips, epoch=1)
    a = answers[3]
    if alter == "length":
        a["paths"][1] = (a["paths"][1][0] * 1.01, a["paths"][1][1])
    elif alter == "path":
        d, p = a["paths"][0]
        a["paths"][0] = (d, p[:-2] + (p[-1],))
    elif alter == "drop":
        a["paths"] = a["paths"][:-1]
    elif alter == "epoch":
        a["epoch_hi"] = 0
    else:  # answered on the weights before the update, stamped after
        for b in answers:
            b["paths"] = R.ksp(adj, net.w0.tolist(), b["s"], b["t"], 3)
    v = R.judge(adj, net.w0, batches, answers)
    assert (v["wrong_answers"] > R.LIMITS["wrong_answers"]
            or v["dist_gap"] > R.LIMITS["dist_gap"])
