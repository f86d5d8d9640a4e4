"""repro_torch.data.dimacs: the DIMACS .gr loader on the in-repo
miniature fixture, edge for edge the reference loader's — duplicate-arc
collapse, weight floor, self-loop removal, gzip, max_edges truncation,
the missing problem line, and the find_dimacs miss/hit paths (as
``tests/test_dimacs.py`` checks ``repro``'s)."""

import gzip
import os

import numpy as np
import pytest

from repro.data import dimacs as jax_dimacs
from repro_torch.core.sssp import dijkstra, graph_view
from repro_torch.data.dimacs import find_dimacs, load_gr

FIXTURE = os.path.join(os.path.dirname(__file__), "data", "mini.gr")


def edge_set(g):
    return {
        (int(u), int(v)): float(w)
        for u, v, w in zip(g.edge_u, g.edge_v, g.w)
    }


def assert_same_graph(got, want):
    assert (got.n, got.m, got.directed) == (want.n, want.m, want.directed)
    np.testing.assert_array_equal(got.edge_u, want.edge_u)
    np.testing.assert_array_equal(got.edge_v, want.edge_v)
    np.testing.assert_array_equal(got.w, want.w)
    np.testing.assert_array_equal(got.csr_indptr, want.csr_indptr)
    np.testing.assert_array_equal(got.csr_dst, want.csr_dst)


@pytest.mark.parametrize("kw", [{}, {"undirected": False},
                                {"max_edges": 3}, {"max_edges": 7}],
                         ids=["undirected", "directed", "max3", "max7"])
def test_load_gr_equals_reference(kw):
    assert_same_graph(load_gr(FIXTURE, **kw), jax_dimacs.load_gr(FIXTURE, **kw))


def test_load_gr_undirected():
    g = load_gr(FIXTURE)
    assert not g.directed and g.n == 6
    edges = edge_set(g)
    # 10 arcs → 5 logical edges: dups collapsed (min wins), self-loop
    # dropped, zero travel time floored to the loader's minimum
    assert edges == {(0, 1): 4.0, (1, 2): 2.0, (0, 3): 1.0, (2, 5): 7.0,
                     (4, 5): pytest.approx(1e-3)}


def test_load_gr_directed_and_shortest_path():
    assert load_gr(FIXTURE, undirected=False).m == 9
    dist, _, _ = dijkstra(graph_view(load_gr(FIXTURE)), 0)
    assert dist[5] == pytest.approx(13.0)  # 0-1 (4) + 1-2 (2) + 2-5 (7)


def test_load_gr_gzip(tmp_path):
    gz = tmp_path / "mini.gr.gz"
    with open(FIXTURE, "rb") as f:
        gz.write_bytes(gzip.compress(f.read()))
    assert_same_graph(load_gr(str(gz)), load_gr(FIXTURE))


def test_load_gr_no_problem_line(tmp_path):
    bad = tmp_path / "bad.gr"
    bad.write_text("c only comments\na 1 2 3\n")
    with pytest.raises(ValueError, match="no problem line"):
        load_gr(str(bad))


def test_find_dimacs(tmp_path):
    assert find_dimacs("NY", search=(str(tmp_path),)) is None
    p = tmp_path / "USA-road-t.NY.gr"
    p.write_text("p sp 1 0\n")
    assert find_dimacs("NY", search=(str(tmp_path),)) == str(p)
    pz = tmp_path / "USA-road-t.COL.gr.gz"
    pz.write_bytes(b"")
    assert find_dimacs("COL", search=(str(tmp_path),)) == str(pz)
    for name in ("NY", "COL", "FLA"):
        assert find_dimacs(name, search=(str(tmp_path),)) == \
            jax_dimacs.find_dimacs(name, search=(str(tmp_path),))
