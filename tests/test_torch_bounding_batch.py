"""The DTLP build's batched bounding pass against the per-source host build.

``core.bounding_batch`` runs every boundary source's level DP in one
``ops.ktrop_solve`` call and every level's representative walk in one
``ops.level_walks`` call.  On the CPU both wrappers run their plain
versions, and the index that comes out must equal ``dtlp.
_build_subgraph_index``'s, source by source on the host, bit for bit:
pairs, pair offsets, φ, vertices, edges, D, BD, LBD, the EBP-II storage and
the skeleton weights.  Levels are integer vfrag sums, so nothing here has a
tolerance.  Sources the batch cannot hold (a parallel pair of different
weights, a DP that hits its cap) take the host path, and the counters say
so.  The walk kernel itself is held to its plain version on the card
(marked ``cuda``; it skips without one)."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.core.bounding import extract_level_path, kdistinct_walk_dp
from repro_torch.core.bounding_batch import _in_edges
from repro_torch.core.dtlp import (DTLP, BuildStats, SkeletonGraph,
                                   _build_subgraph_index, _path_edge_ids,
                                   batched_subgraph_indexes)
from repro_torch.core.graph import Graph
from repro_torch.core.partition import partition_graph
from repro_torch.data.roadnet import grid_road_network
from repro_torch.kernels import level_walk, ops, ref

_ARRAYS = ("pairs", "pair_ptr", "path_phi", "path_D", "path_BD", "lbd")


def _random_graph(n, m, seed, directed):
    """A chain plus random extra edges, integer weights 1-9 (many equal
    levels, many non-simple ones)."""
    rng = np.random.default_rng(seed)
    eu = np.concatenate([np.arange(n - 1), rng.integers(0, n, m)])
    ev = np.concatenate([np.arange(1, n), rng.integers(0, n, m)])
    keep = eu != ev
    if directed:  # back edges too, so most pairs are reachable
        eu, ev = (np.concatenate([eu[keep], ev[keep][::2]]),
                  np.concatenate([ev[keep], eu[keep][::2]]))
    else:
        eu, ev = eu[keep], ev[keep]
    w0 = rng.integers(1, 10, eu.shape[0]).astype(np.float64)
    return Graph(n, eu, ev, w0, directed=directed)


def _builds(g, z, xi, max_iter=None):
    """(host indexes, batched indexes, the batch's stats)."""
    part = partition_graph(g, z, seed=0)
    host = [_build_subgraph_index(g, sg, xi, "paper", max_iter)
            for sg in part.subgraphs]
    stats = BuildStats()
    batch = batched_subgraph_indexes(g, part.subgraphs, xi, "paper", stats,
                                     "cpu", max_iter)
    return part, host, batch, stats


def _assert_same(g, host, batch):
    assert len(host) == len(batch)
    for a, b in zip(host, batch):
        for f in _ARRAYS:
            x, y = getattr(a, f), getattr(b, f)
            assert x.dtype == y.dtype and x.shape == y.shape, f
            assert np.array_equal(x, y), f
        assert a.path_vertices == b.path_vertices
        assert len(a.path_edges) == len(b.path_edges)
        for p, q in zip(a.path_edges, b.path_edges):
            assert (p is None) == (q is None)
            if p is not None:
                assert p.dtype == q.dtype and np.array_equal(p, q)
        for f in ("keys", "indptr", "pids"):
            assert np.array_equal(getattr(a.storage, f),
                                  getattr(b.storage, f)), f
        for f in ("cum_vfrag", "cum_wsum", "unit_sorted"):
            assert np.array_equal(getattr(a.profile, f),
                                  getattr(b.profile, f)), f
    skel = []
    for subs in (host, batch):
        s = SkeletonGraph(g.n, g.directed)
        s.finalize(subs)
        s.refresh_weights(subs)
        skel.append(s)
    for f in ("edge_i", "edge_j", "weight", "s2g"):
        assert np.array_equal(getattr(skel[0], f), getattr(skel[1], f)), f


def _walk_count(subs):
    return sum(len(si.path_vertices) for si in subs)


def _simple_count(subs):
    return sum(p is not None for si in subs for p in si.path_vertices)


@pytest.mark.parametrize("seed", [0, 1])
def test_grid_matches_the_host_build(seed):
    g = grid_road_network(8, 8, seed=seed)
    part, host, batch, st = _builds(g, 12, 4)
    _assert_same(g, host, batch)
    n_src = sum(int(sg.boundary_local.shape[0]) for sg in part.subgraphs)
    assert (st.device_sources, st.host_sources) == (n_src, 0)
    assert st.device_walks == _walk_count(host) > 0
    assert st.simple_walks == _simple_count(host)
    assert 0 < st.simple_walks < st.device_walks  # non-simple levels too


def test_directed_graph_matches_the_host_build():
    g = _random_graph(60, 70, 3, directed=True)
    part, host, batch, st = _builds(g, 14, 3)
    _assert_same(g, host, batch)
    assert st.device_sources > 0 and st.device_walks > 0


def test_parallel_pair_of_different_weights_takes_the_host_path():
    """A second edge u-v of another weight: no dense matrix holds both,
    so every source of that subgraph runs the host DP, and the rest of
    the build stays batched."""
    base = grid_road_network(7, 7, seed=4)
    u, v = int(base.edge_u[0]), int(base.edge_v[0])
    w0 = np.append(base.w0, base.w0[0] + 3.0)
    g = Graph(base.n, np.append(base.edge_u, u), np.append(base.edge_v, v),
              w0, directed=False)
    part, host, batch, st = _builds(g, 10, 4)
    _assert_same(g, host, batch)
    owner = [sg for sg in part.subgraphs if g.m - 1 in set(sg.edges)]
    assert len(owner) == 1 and owner[0].boundary_local.shape[0] > 0
    assert st.host_sources == owner[0].boundary_local.shape[0]
    assert st.device_sources > 0
    assert st.simple_walks == _simple_count(host)


def test_capped_dp_takes_the_host_path():
    """With the DP's cap cut to a few relaxations, the rows that hit it
    run the host DP (which stops at the same cap); rows that converged
    within it stay batched."""
    g = grid_road_network(8, 8, seed=5)
    part, host, batch, st = _builds(g, 12, 4, max_iter=6)
    _assert_same(g, host, batch)
    assert st.host_sources > 0 and st.device_sources > 0
    assert st.simple_walks == _simple_count(host)


def test_build_routes_by_device():
    g = grid_road_network(6, 6, seed=0)
    plain = DTLP.build(g, z=10, xi=3)
    cpu = DTLP.build(g, z=10, xi=3, device="cpu")
    assert plain.device is None and cpu.device is None
    n_src = sum(int(sg.boundary_local.shape[0])
                for sg in cpu.partition.subgraphs)
    assert (cpu.stats.device_sources, cpu.stats.host_sources,
            cpu.stats.device_walks) == (0, n_src, 0)
    assert cpu.stats.simple_walks == _simple_count(cpu.sub_indexes)
    assert np.array_equal(plain.skeleton.weight, cpu.skeleton.weight)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            DTLP.build(g, z=10, xi=3, device="cuda")


def test_levels_past_f32_exact_integers_raise():
    """A vfrag so large that a walk of the DP's cap could reach 2^24 is no
    longer exact in f32: the batched pass raises rather than send the
    build to the host."""
    base = grid_road_network(6, 6, seed=1)
    w0 = base.w0.copy()
    w0[0] = 1e6
    g = Graph(base.n, base.edge_u, base.edge_v, w0, directed=False)
    part = partition_graph(g, 10, seed=0)
    with pytest.raises(ValueError, match="2\\^24"):
        batched_subgraph_indexes(g, part.subgraphs, 4, "paper", BuildStats(),
                                 "cpu")


@pytest.mark.parametrize("k,z,h_max,what", [
    (4, 1025, 10, "seen set"),
    (16, 1024, 20_000, "shared memory"),
])
def test_walk_launcher_refuses_what_the_kernel_cannot_hold(k, z, h_max,
                                                          what):
    """The launcher raises, before touching a card, where a walk's seen set
    or a row's staged tables would not fit the kernel."""
    D = torch.zeros((1, k, z))
    with pytest.raises(ValueError, match=what):
        level_walk.walks(D, *[None] * 10, h_max=h_max)


# ---------------------------------------------------------------- the walks
def _walk_inputs(seed, nv_lo, nv_hi, k, n_src, G=3):
    """Random directed subgraphs (a ring and random chords, weights 1-4),
    their host DP rows, and every (target, level) walk of each row; every
    other row caps its walks at 3-6 vertices, the rest at the host's
    default (nv + k + 2)."""
    rng = np.random.default_rng(seed)
    subs, rows = [], []
    for g in range(G):
        nv = int(rng.integers(nv_lo, nv_hi + 1))
        m = 3 * nv
        eu = np.concatenate([np.arange(nv), rng.integers(0, nv, m)])
        ev = np.concatenate([(np.arange(nv) + 1) % nv,
                             rng.integers(0, nv, m)])
        keep = eu != ev
        eu, ev = eu[keep], ev[keep]
        order = np.argsort(eu, kind="stable")
        eu, ev = eu[order], ev[order]
        indptr = np.zeros(nv + 1, np.int64)
        np.cumsum(np.bincount(eu, minlength=nv), out=indptr[1:])
        sg = SimpleNamespace(nv=nv, indptr=indptr, nbr=ev,
                             eid=np.arange(eu.shape[0]) + 1000 * g)
        hw = rng.integers(1, 5, eu.shape[0]).astype(np.float64)
        subs.append((sg, hw))
        for src in rng.choice(nv, n_src, replace=False):
            rows.append((g, int(src), kdistinct_walk_dp(indptr, ev, hw,
                                                        int(src), k)))
    z = max(sg.nv for sg, _ in subs)
    D = np.full((len(rows), k, z), ops.INF, np.float32)
    walks, walk_ptr, max_len = [], [0], []
    for s, (g, src, Dh) in enumerate(rows):
        D[s, :, :Dh.shape[1]] = np.where(np.isfinite(Dh), Dh, ops.INF)
        nv = subs[g][0].nv
        # every other row's cap falls within its walks' lengths
        max_len.append(int(rng.integers(3, 7)) if s % 2
                       else nv + k + 2)
        for t in range(nv):
            for lv in Dh[:, t][np.isfinite(Dh[:, t])]:
                if t != src:
                    walks.append((t, float(lv)))
        walk_ptr.append(len(walks))
    tables = [_in_edges(sg, hw, z) for sg, hw in subs]
    ptr = np.zeros((G, z + 1), np.int64)
    ptr[:, 1:] = np.cumsum([t[0] for t in tables], axis=1)
    ptr += np.concatenate([[0], np.cumsum([t[1].shape[0]
                                           for t in tables])[:-1]])[:, None]
    args = [D, np.array([r[0] for r in rows]), np.array([r[1] for r in rows]),
            np.array(max_len), ptr, np.concatenate([t[1] for t in tables]),
            np.concatenate([t[2] for t in tables]),
            np.concatenate([t[3] for t in tables]), np.array(walk_ptr),
            np.array([w[0] for w in walks]), np.array([w[1] for w in walks])]
    dtypes = [np.float32] + [np.int32] * 5 + [np.float32] + [np.int32] * 3 \
        + [np.float32]
    tensors = [torch.from_numpy(np.ascontiguousarray(a, dtype=dt))
               for a, dt in zip(args, dtypes)]
    return tensors, subs, rows, walks, walk_ptr, max_len


def _prefixes(verts, eids, n):
    n = n.cpu().numpy()
    v, e = verts.cpu().numpy(), eids.cpu().numpy()
    return n, [(v[w, :n[w]].tolist(), e[w, :max(n[w] - 1, 0)].tolist())
               for w in range(n.shape[0])]


def _cut_by_cap(tensors, n):
    """The walks that are simple without their row's cap but not with it."""
    D = tensors[0]
    uncapped = list(tensors)
    uncapped[3] = torch.full_like(tensors[3], D.shape[2] + D.shape[1] + 2)
    n_free = ref.level_walks_ref(*uncapped)[2].numpy()
    return (n_free > 0) & (np.asarray(n) == 0)


@pytest.mark.parametrize("seed,k", [(0, 3), (1, 4)])
def test_plain_walks_equal_the_host_walks(seed, k):
    """``ref.level_walks_ref`` gives, walk for walk, what
    ``extract_level_path`` and ``_path_edge_ids`` give on the host, at the
    row's walk cap."""
    tensors, subs, rows, walks, walk_ptr, max_len = _walk_inputs(
        seed, 12, 20, k, 3)
    n, got = _prefixes(*ref.level_walks_ref(*tensors))
    n_simple = 0
    for s, (g, src, Dh) in enumerate(rows):
        sg, hw = subs[g]
        for w in range(walk_ptr[s], walk_ptr[s + 1]):
            t, lv = walks[w]
            want = extract_level_path(sg.indptr, sg.nbr, hw, Dh, src, t, lv,
                                      max_len=max_len[s])
            if want is None:
                assert n[w] == 0
                continue
            n_simple += 1
            assert got[w] == (want, _path_edge_ids(sg, want).tolist())
    assert 0 < n_simple < len(walks)
    assert _cut_by_cap(tensors, n).any()


@pytest.mark.cuda
@pytest.mark.parametrize("seed,k", [(0, 4), (1, 2), (2, 6)])
def test_walk_kernel_matches_plain_version_on_the_card(seed, k):
    """The kernel against its plain version on random subgraphs wider than
    64 vertices (a seen set of three words and more), with non-simple
    levels and walks cut by their cap: every length, vertex and edge id
    equal."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the walk kernel runs only there")
    tensors, *_ = _walk_inputs(seed, 65, 140, k, 6)
    want_n, want = _prefixes(*ref.level_walks_ref(*tensors))
    ops.reset_launches()
    out = ops.level_walks(*[t.cuda() for t in tensors])
    torch.cuda.synchronize()
    assert ops.LAUNCHES["level_walks"] == 1
    got_n, got = _prefixes(*out)
    assert np.array_equal(got_n, want_n) and got == want
    assert 0 < np.count_nonzero(want_n) < want_n.shape[0]
    assert _cut_by_cap(tensors, want_n).any()
