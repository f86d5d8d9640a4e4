"""The frozen copies in ``kspbench/roadgen.py`` equal the program's
originals on fixed seeds (they may drift apart later: the copy is the
yardstick)."""

import importlib.util

import numpy as np
import pytest

from kspbench import roadgen
from kspbench.tests.conftest import REPO


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_for_test", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("rows,cols,seed", [(8, 8, 0), (16, 12, 3),
                                            (64, 64, 0)])
def test_grid_equals_original(rows, cols, seed):
    from repro_torch.data.roadnet import grid_road_network

    g = grid_road_network(rows, cols, seed=seed)
    net = roadgen.grid_road_network(rows, cols, seed=seed)
    assert net.n == g.n and net.m == g.m
    for a, b in ((net.edge_u, g.edge_u), (net.edge_v, g.edge_v),
                 (net.w0, g.w0), (net.csr_indptr, g.csr_indptr),
                 (net.csr_dst, g.csr_dst), (net.csr_eid, g.csr_eid)):
        np.testing.assert_array_equal(a, b)


def test_largest_component_equals_original():
    from repro_torch.core.graph import Graph
    from repro_torch.data.roadnet import _largest_component

    # two components: a path 0-1-2 and a bigger cycle 3-4-5-6
    u, v = [0, 1, 3, 4, 5, 6], [1, 2, 4, 5, 6, 3]
    w = [1.0, 2.0, 3.0, 4.0, 5.0, 6.0]
    g = _largest_component(Graph(7, u, v, w))
    net = roadgen._largest_component(roadgen.RoadNet.from_edges(7, u, v, w))
    assert net.n == g.n == 4
    np.testing.assert_array_equal(net.edge_u, g.edge_u)
    np.testing.assert_array_equal(net.edge_v, g.edge_v)
    np.testing.assert_array_equal(net.w0, g.w0)


@pytest.mark.parametrize("alpha,tau,seed", [(0.05, 0.5, 0), (0.5, 0.5, 4)])
def test_update_stream_equals_original(alpha, tau, seed):
    from repro_torch.data.roadnet import WeightUpdateStream, grid_road_network

    g = grid_road_network(16, 16, seed=1)
    net = roadgen.grid_road_network(16, 16, seed=1)
    a = WeightUpdateStream(g, alpha=alpha, tau=tau, seed=seed)
    b = roadgen.WeightUpdateStream(net, alpha=alpha, tau=tau, seed=seed)
    for _ in range(3):
        (ea, wa), (eb, wb) = a.next_batch(), b.next_batch()
        np.testing.assert_array_equal(ea, eb)
        np.testing.assert_array_equal(wa, wb)


def test_local_trips_equal_original():
    from repro_torch.data.roadnet import grid_road_network

    g = grid_road_network(24, 24, seed=2)
    net = roadgen.grid_road_network(24, 24, seed=2)
    want = _smoke().local_trips(np, g, 40, np.random.default_rng(9))
    assert roadgen.local_trips(net, 40, np.random.default_rng(9)) == want
