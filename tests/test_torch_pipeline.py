"""The port's data pipelines (``repro_torch.data.pipeline``, a copy of
``repro.data.pipeline``) give the reference's arrays bit for bit over
several seeds and steps, the fanout sampler the reference's blocks; and
the twins of ``tests/test_substrate.py``'s pipeline and sampler
checks."""

import re
from pathlib import Path

import numpy as np
import pytest

from repro.data import pipeline as R
from repro_torch.data import pipeline as P

ROOT = Path(__file__).resolve().parent.parent


def same(a: dict, b: dict):
    assert set(a) == set(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        np.testing.assert_array_equal(x, y, err_msg=k)


def test_source_is_the_reference_copy():
    """The module differs from the reference only in ``repro.`` →
    ``repro_torch.`` references."""
    ref = (ROOT / "src/repro/data/pipeline.py").read_text()
    port = (ROOT / "src/repro_torch/data/pipeline.py").read_text()
    assert re.sub(r"\brepro\.", "repro_torch.", ref) == port


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_token_pipeline(seed):
    args = dict(vocab=97, batch=3, seq_len=17, seed=seed)
    for step in (0, 1, 9, 1000):
        same(P.TokenPipeline(**args).batch_at(step),
             R.TokenPipeline(**args).batch_at(step))


@pytest.mark.parametrize("seed", [0, 5])
def test_click_stream(seed):
    args = dict(n_items=500, n_profile=60, seq_len=6, batch=9, bag_nnz=4,
                n_dense=3, seed=seed)
    for step in (0, 2, 77):
        same(P.ClickStream(**args).batch_at(step),
             R.ClickStream(**args).batch_at(step))


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_random_gnn_graph(seed):
    for kw in ({}, {"with_pos": True}, {"edge_feat_dim": 4}):
        same(P.random_gnn_graph(30, 70, 5, 3, seed=seed, **kw),
             R.random_gnn_graph(30, 70, 5, 3, seed=seed, **kw))


@pytest.mark.parametrize("seed", [0, 2])
def test_molecule_batch_and_triplets(seed):
    same(P.molecule_batch(5, 9, 14, seed=seed),
         R.molecule_batch(5, 9, 14, seed=seed))
    g = P.random_gnn_graph(20, 40, 2, 2, seed=seed)
    for cap in (None, 25):
        for a, b in zip(P.build_triplets(g["edge_src"], g["edge_dst"], cap),
                        R.build_triplets(g["edge_src"], g["edge_dst"], cap)):
            np.testing.assert_array_equal(a, b)
    # degenerate: no triplet at all
    for a, b in zip(P.build_triplets(np.array([0]), np.array([1])),
                    R.build_triplets(np.array([0]), np.array([1]))):
        np.testing.assert_array_equal(a, b)


def _csr(g, n):
    order = np.argsort(g["edge_src"], kind="stable")
    src, dst = g["edge_src"][order], g["edge_dst"][order]
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(src, minlength=n), out=indptr[1:])
    return indptr, dst


@pytest.mark.parametrize("seed", [0, 4])
def test_neighbor_sampler_blocks(seed):
    """The same CSR, fanouts and seed give the same blocks, call after
    call (the sampler's generator advances identically)."""
    g = P.random_gnn_graph(200, 600, 4, 3, seed=2)
    indptr, nbr = _csr(g, 200)
    ps = P.NeighborSampler(indptr, nbr, fanouts=(5, 3), seed=seed)
    rs = R.NeighborSampler(indptr, nbr, fanouts=(5, 3), seed=seed)
    for seeds in (np.array([0, 10, 20]), np.arange(40, 60), np.array([7])):
        a, b = ps.sample(seeds), rs.sample(seeds)
        assert a["n_seeds"] == b["n_seeds"] == len(seeds)
        same({k: v for k, v in a.items() if k != "n_seeds"},
             {k: v for k, v in b.items() if k != "n_seeds"})


class TestPipelines:
    """Twins of ``tests/test_substrate.py::TestPipelines``."""

    def test_token_pipeline_deterministic(self):
        p = P.TokenPipeline(vocab=100, batch=4, seq_len=16, seed=3)
        a = p.batch_at(7)
        b = p.batch_at(7)
        np.testing.assert_array_equal(a["tokens"], b["tokens"])
        c = p.batch_at(8)
        assert not np.array_equal(a["tokens"], c["tokens"])
        assert a["tokens"].max() < 100

    def test_clickstream_shapes(self):
        p = P.ClickStream(n_items=50, n_profile=20, seq_len=5, batch=8,
                          bag_nnz=4, n_dense=3)
        b = p.batch_at(0)
        assert b["hist"].shape == (8, 5)
        assert b["bag_ids"].shape == (32,)
        assert b["bag_ids"].max() < 20
        assert set(b["bag_seg"]) == set(range(8))

    def test_molecule_batch_triplets_valid(self):
        b = P.molecule_batch(4, 6, 10, seed=1)
        E = b["edge_src"].shape[0]
        assert b["t_kj"].max() < E and b["t_ji"].max() < E
        # triplet invariant: dst(kj) == src(ji), src(kj) != dst(ji)
        ok = b["edge_dst"][b["t_kj"]] == b["edge_src"][b["t_ji"]]
        assert ok.all()
        noloop = b["edge_src"][b["t_kj"]] != b["edge_dst"][b["t_ji"]]
        assert noloop.all()


def test_fanout_sampler():
    """Twin of ``tests/test_substrate.py::TestSampler``'s fanout test."""
    g = P.random_gnn_graph(200, 600, 4, 3, seed=2)
    indptr, nbr = _csr(g, 200)
    samp = P.NeighborSampler(indptr, nbr, fanouts=(5, 3), seed=0)
    seeds = np.array([0, 10, 20])
    block = samp.sample(seeds)
    assert block["n_seeds"] == 3
    assert (block["nodes"][:3] == seeds).all()
    # every edge points child → parent within the block's local ids
    n_nodes = block["nodes"].shape[0]
    assert block["edge_src"].max() < n_nodes
    assert block["edge_dst"].max() < n_nodes
    # fanout bound: ≤ 3·5 first-hop + 15·3 second-hop edges
    assert block["edge_src"].shape[0] <= 3 * 5 + 15 * 3
