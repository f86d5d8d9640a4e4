"""The native route of ``core/sssp.py::dijkstra`` (``csrc/sssp_host.cpp``).

A call in its plain form (no destination, bans, cap, heuristic or reuse)
runs the native loop where its library builds; it must return the Python
loop's ``dist`` byte for byte and its ``parent`` exactly, since the pop
order of any min-heap on (distance, vertex id) is heapq's.  Held here on
graphs with many ties, parallel and zero-weight edges, unreachable
vertices, weights after a drift, a reversed directed view and the
extended skeletons of a 16x16 DTLP, spliced and unspliced; the lazy
stream's first walks must come out in the same order on both routes.
Every other call stays on the Python loop, and a host without the
library (no compiler, a failed build) answers the same on the loop.

The tests that compare the two routes need a host C++ compiler; the
fixture ``native`` skips them where none builds the library."""

import subprocess
import sys
import textwrap
import threading

import numpy as np
import pytest

from repro_torch.core import sssp
from repro_torch.core.dtlp import DTLP
from repro_torch.core.kspdg import _extended_skeleton, ksp_dg
from repro_torch.core.refstream import SidetrackTree
from repro_torch.core.sssp import INF, CSRView, dijkstra, graph_view
from repro_torch.core.yen import ksp
from repro_torch.data.roadnet import WeightUpdateStream, grid_road_network
from repro_torch.kernels import _build

SRC = str(_build.CSRC.parent.parent)


@pytest.fixture(scope="module")
def native():
    if sssp._native_fn() is None:
        pytest.skip("the native route did not build on this host: "
                    f"{_build.BUILD_INFO.get('sssp_host')}")


@pytest.fixture
def python_route(monkeypatch):
    """Run ``fn()`` with the native library made unavailable."""
    def run(fn):
        with monkeypatch.context() as m:
            m.setattr(sssp, "_native_fn", lambda: None)
            return fn()
    return run


@pytest.fixture(scope="module")
def dtlp16():
    return DTLP.build(grid_road_network(16, 16, seed=0), z=16, xi=4)


def _csr(n, edges, directed=False) -> CSRView:
    """A CSR view of (u, v, w) edges, in the order given."""
    src, dst, w = [], [], []
    for u, v, x in edges:
        src.append(u), dst.append(v), w.append(x)
        if not directed:
            src.append(v), dst.append(u), w.append(x)
    src = np.asarray(src, dtype=np.int64)
    order = np.argsort(src, kind="stable")
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(src, minlength=n), out=indptr[1:])
    return CSRView(n, indptr, np.asarray(dst, dtype=np.int64)[order],
                   np.asarray(w, dtype=np.float64)[order])


def _same(python_route, view, src) -> None:
    before = dict(sssp.ROUTE_CALLS)
    d_n, p_n, b_n = dijkstra(view, src)
    assert sssp.ROUTE_CALLS["native"] == before["native"] + 1
    d_p, p_p, b_p = python_route(lambda: dijkstra(view, src))
    assert sssp.ROUTE_CALLS["python"] == before["python"] + 1
    assert d_n.dtype == d_p.dtype and d_n.tobytes() == d_p.tobytes()
    assert p_n.dtype == p_p.dtype and np.array_equal(p_n, p_p)
    assert b_n == b_p == INF


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("directed", [False, True])
def test_random_graphs_with_many_ties(native, python_route, seed, directed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(40, 200))
    m = int(rng.integers(n, 4 * n))
    edges = [(int(a), int(b), float(x)) for a, b, x in zip(
        rng.integers(n, size=m), rng.integers(n, size=m),
        rng.integers(1, 4, size=m))]
    view = _csr(n, edges, directed)
    for src in rng.choice(n, 8, replace=False):
        _same(python_route, view, src)


def test_parallel_edges(native, python_route):
    edges = [(0, 1, 2.0), (0, 1, 2.0), (0, 1, 1.0), (1, 2, 3.0),
             (1, 2, 3.0), (0, 2, 4.0), (2, 3, 1.0), (2, 3, 5.0)]
    view = _csr(4, edges)
    for src in range(4):
        _same(python_route, view, src)


def test_zero_weight_edges(native, python_route):
    rng = np.random.default_rng(3)
    edges = [(int(a), int(b), float(x)) for a, b, x in zip(
        rng.integers(50, size=150), rng.integers(50, size=150),
        rng.integers(0, 3, size=150))]
    view = _csr(50, edges)
    for src in range(0, 50, 7):
        _same(python_route, view, src)


def test_unreachable_vertices(native, python_route):
    # two components and an isolated vertex 7
    edges = [(0, 1, 1.0), (1, 2, 1.0), (2, 0, 2.0), (3, 4, 1.0),
             (4, 5, 1.0), (5, 6, 1.0)]
    view = _csr(8, edges)
    for src in range(8):
        _same(python_route, view, src)
    d, p, _ = dijkstra(view, 0)
    assert np.all(np.isinf(d[3:])) and np.all(p[3:] == -1)


def test_weights_after_drift(native, python_route):
    """The 16x16 grid under the feed's batches (5% of edges, τ 0.2): the
    graph's own view and the extended skeletons of the drifted index."""
    g = grid_road_network(16, 16, seed=0)
    d = DTLP.build(g, z=16, xi=4)
    stream = WeightUpdateStream(g, alpha=0.05, tau=0.2, seed=1)
    rng = np.random.default_rng(4)
    for _ in range(6):
        d.apply_updates(*stream.next_batch())
        assert np.any(g.w != np.round(g.w))
        _same(python_route, graph_view(g), int(rng.integers(g.n)))
        s, t = map(int, rng.choice(g.n, 2, replace=False))
        view, ext_id, _, _ = _extended_skeleton(d, s, t)
        _same(python_route, view, ext_id(t))


def test_reversed_directed_view(native, python_route):
    g = grid_road_network(12, 12, seed=5, directed=True)
    rview = graph_view(g).reversed()
    for src in range(0, g.n, 17):
        _same(python_route, rview, src)
    for dst in (0, g.n // 2, g.n - 1):
        a_d, a_p = sssp.reverse_spt(graph_view(g), dst, True)
        b_d, b_p = python_route(
            lambda: sssp.reverse_spt(graph_view(g), dst, True))
        assert a_d.tobytes() == b_d.tobytes() and np.array_equal(a_p, b_p)


def _trips(dtlp, n, seed):
    rng = np.random.default_rng(seed)
    return [tuple(map(int, rng.choice(dtlp.graph.n, 2, replace=False)))
            for _ in range(n)]


def test_extended_skeletons(native, python_route, dtlp16):
    """Spliced and unspliced queries: the splice searches give the same
    extended skeleton on both routes, and its reverse tree is the same."""
    boundary = np.nonzero(dtlp16.skeleton.g2s >= 0)[0]
    rng = np.random.default_rng(7)
    unspliced = [tuple(map(int, rng.choice(boundary, 2, replace=False)))
                 for _ in range(8)]
    homes = set()
    for s, t in _trips(dtlp16, 24, 1) + unspliced:
        view, ext_id, _, home = _extended_skeleton(dtlp16, s, t)
        v_p, _, _, _ = python_route(lambda: _extended_skeleton(dtlp16, s, t))
        for f in ("indptr", "nbr", "hw"):
            a, b = getattr(view, f), getattr(v_p, f)
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
        homes.add(bool(home))
        _same(python_route, view, ext_id(t))
    assert homes == {False, True}


def test_stream_tie_order(native, python_route, dtlp16):
    """The lazy stream's first 50 walks, weight and vertex tuple, are the
    same on both routes."""
    for s, t in _trips(dtlp16, 8, 2):
        view, ext_id, _, _ = _extended_skeleton(dtlp16, s, t)
        es, et = ext_id(s), ext_id(t)

        def first_walks():
            walks = SidetrackTree(view, et).walks(es)
            return [w for _, w in zip(range(50), walks)]

        native_walks = first_walks()
        assert len(native_walks) == 50
        assert native_walks == python_route(first_walks)


def test_non_plain_calls_stay_on_the_python_loop(native, python_route,
                                                 monkeypatch):
    g = grid_road_network(10, 10, seed=2)
    view = graph_view(g)
    a_d, a_p = sssp.reverse_spt(view, g.n - 1, False)
    calls = [
        dict(dst=g.n - 1),
        dict(banned_vertices={3, 4}),
        dict(banned_vertices=np.zeros(g.n, dtype=bool)),
        dict(banned_edges={(0, 1)}),
        dict(banned_edges=set()),
        dict(cap=50.0),
        dict(heuristic=lambda v: 0.0),
        dict(dst=g.n - 1, reuse=(a_d, a_p, lambda u, tree: True)),
    ]
    want = [dijkstra(view, 0, **kw) for kw in calls]

    def refused(*args):
        raise AssertionError("a call that is not plain took the native route")

    monkeypatch.setattr(sssp, "_native_dijkstra", refused)
    before = dict(sssp.ROUTE_CALLS)
    for kw, (d0, p0, b0) in zip(calls, want):
        d, p, b = dijkstra(view, 0, **kw)
        assert d.tobytes() == d0.tobytes() and np.array_equal(p, p0)
        assert b == b0
    assert sssp.ROUTE_CALLS == before
    # Yen's banned and capped searches run with the native loop refused;
    # only its heuristic's reverse tree is plain
    monkeypatch.undo()
    paths = ksp(view, 0, g.n - 1, 4)
    assert paths == python_route(lambda: ksp(view, 0, g.n - 1, 4))


def test_route_counter_counts_both_routes(native, python_route):
    view = graph_view(grid_road_network(6, 6, seed=1))
    before = dict(sssp.ROUTE_CALLS)
    dijkstra(view, 0)
    dijkstra(view, 1)
    python_route(lambda: dijkstra(view, 2))
    assert sssp.ROUTE_CALLS == {"native": before["native"] + 2,
                                "python": before["python"] + 1}


def test_unavailable_library_serves_the_same_answers(native, monkeypatch,
                                                     dtlp16):
    """With the loader finding no library, KSP-DG on the lazy stream
    answers as on the native route, and counts the Python route."""
    trips = _trips(dtlp16, 6, 3)
    want = [ksp_dg(dtlp16, s, t, 3, ref_stream="lazy")[0] for s, t in trips]
    monkeypatch.setattr(_build, "host_library", lambda name: None)
    sssp._native_fn.cache_clear()
    try:
        before = sssp.ROUTE_CALLS["python"]
        got = [ksp_dg(dtlp16, s, t, 3, ref_stream="lazy")[0]
               for s, t in trips]
        assert sssp.ROUTE_CALLS["python"] > before
    finally:
        sssp._native_fn.cache_clear()
    assert got == want


@pytest.mark.parametrize("dtypes", [(np.int32, np.int32, np.float32),
                                    (np.int64, np.uint32, np.int64)])
def test_views_of_other_dtypes(native, python_route, dtypes):
    """Integer and float arrays of other widths widen exactly."""
    g = grid_road_network(8, 8, seed=4)
    v = graph_view(g)
    ip, nb, hw = dtypes
    view = CSRView(v.n, v.indptr.astype(ip), v.nbr.astype(nb),
                   np.round(v.hw * 4).astype(hw) / (4 if hw is np.float32
                                                   else 1))
    for src in (0, 17, v.n - 1):
        _same(python_route, view, src)


def test_malformed_view_falls_back_to_the_loop(native):
    """A neighbour out of range: the native loop refuses it, and the
    Python loop runs and raises as it always did."""
    view = CSRView(3, np.array([0, 1, 2, 2]), np.array([1, 3]),
                   np.array([1.0, 1.0]))
    before = sssp.ROUTE_CALLS["python"]
    with pytest.raises(IndexError):
        dijkstra(view, 0)
    assert sssp.ROUTE_CALLS["python"] == before + 1


def test_no_compiler_means_no_library(monkeypatch):
    monkeypatch.setattr(_build, "_host_cxx", lambda: None)
    assert _build.host_library.__wrapped__("sssp_host") is None
    assert "no host C++ compiler" in _build.BUILD_INFO["sssp_host"]["log"]


def test_failed_build_means_no_library(monkeypatch, tmp_path):
    if _build._host_cxx() is None:
        pytest.skip("no host C++ compiler on this host")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "HOST_CXX_FLAGS",
                        _build.HOST_CXX_FLAGS + ("-fno-such-option",))
    assert _build.host_library.__wrapped__("sssp_host") is None
    assert list(tmp_path.iterdir()) == []


def test_concurrent_builds_do_not_race(tmp_path):
    """Four processes build the library into one empty directory at once:
    each loads a working library and one file is left."""
    if _build._host_cxx() is None:
        pytest.skip("no host C++ compiler on this host")
    code = textwrap.dedent(f"""
        import sys
        from pathlib import Path
        sys.path.insert(0, {SRC!r})
        from repro_torch.kernels import _build
        _build.BUILD_DIR = Path({str(tmp_path)!r})
        assert _build.host_library("sssp_host").sssp_dijkstra
    """)
    procs = [subprocess.Popen([sys.executable, "-c", code])
             for _ in range(4)]
    assert [p.wait(timeout=120) for p in procs] == [0] * 4
    left = sorted(p.name for p in tmp_path.iterdir())
    assert len(left) == 1 and left[0].endswith(".so"), left


def test_route_counter_under_threads(native):
    """Eight threads, each 50 plain calls on the native route (which
    releases the interpreter lock) with a short switch interval: no count
    is lost."""
    view = graph_view(grid_road_network(6, 6, seed=1))
    before = sssp.ROUTE_CALLS["native"]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [
            dijkstra(view, i % view.n) for i in range(50)]) for _ in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads)
    assert sssp.ROUTE_CALLS["native"] == before + 400
