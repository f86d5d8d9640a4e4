"""End-to-end serving parity: the port twin of ``bench_engine.
bench_backend_compare``.  One trace — queries, one UpdateBatch, queries —
through the reference ``dense_bf`` and through the port's ``cuda_bf`` and
``dense_bf`` on the CPU device; the ``(paths, epoch)`` lists must be
equal in both update modes, to the reference's pipelined and lockstep
schedules alike, and on a 2-shard CPU mesh (the port's form of
``test_backend.py``'s
``test_service_level`` and ``test_streaming.py``'s updates-under-mesh
tests)."""

import numpy as np
import pytest

import repro.service as jax_service
import repro_torch.service as torch_service
from repro.core.dtlp import DTLP as JaxDTLP
from repro.data.roadnet import WeightUpdateStream as JaxStream
from repro.data.roadnet import grid_road_network as jax_grid
from repro.dist.cluster import Cluster as JaxCluster
from repro_torch.core.dtlp import DTLP
from repro_torch.data.roadnet import WeightUpdateStream, grid_road_network
from repro_torch.dist.cluster import Cluster
from repro_torch.engine.dense import ShardedMirror
from repro_torch.launch.mesh import make_host_mesh

_N = 8


def _queries(n_vertices, n, seed=3):
    rng = np.random.default_rng(seed)
    return [tuple(map(int, rng.choice(n_vertices, 3, replace=False)))
            for _ in range(n)]


def _trace(port: bool, engine: str, update_mode: str, pipeline=True,
           requests=None, mesh=None):
    """Replay the trace on a fresh 6x6 grid; returns [(paths, epoch)].
    ``pipeline`` picks the reference's schedule; the port has only the
    pipelined one."""
    api = torch_service if port else jax_service
    g = (grid_road_network if port else jax_grid)(6, 6, seed=0)
    d = (DTLP if port else JaxDTLP).build(g, z=12, xi=4)
    kw = {"device": "cpu", "mesh": mesh} if port else {"pipeline": pipeline}
    svc = api.KSPService(d, api.ServiceConfig(
        engine=engine, n_workers=2, max_in_flight=4,
        update_mode=update_mode, **kw))
    batch = (WeightUpdateStream if port else JaxStream)(
        g, alpha=0.5, tau=0.5, seed=1).next_batch()
    if requests is None:
        requests = [lambda s, t, u: api.QueryRequest(s, t, 3)] * _N
    reqs = [make(*q) for make, q in zip(requests, _queries(g.n, _N))]
    cut = _N // 2
    tickets = svc.replay(reqs[:cut])
    svc.update(api.UpdateBatch(*batch))
    tickets += svc.replay(reqs[cut:])
    return [(tk.result.paths, tk.result.epoch) for tk in tickets]


@pytest.mark.parametrize("pipeline", [True, False], ids=["pipe", "lockstep"])
@pytest.mark.parametrize("update_mode", ["barrier", "streaming"])
def test_paths_and_epochs_equal_reference(update_mode, pipeline):
    """The port's pipelined schedule serves what the reference serves
    under either of its schedules."""
    want = _trace(False, "dense_bf", update_mode, pipeline)
    assert [e for _, e in want] == [0] * (_N // 2) + [1] * (_N // 2)
    assert all(paths for paths, _ in want)
    for engine in ("cuda_bf", "dense_bf"):
        got = _trace(True, engine, update_mode)
        assert got == want, engine


def test_mixed_variant_burst_equals_reference():
    """Diverse, bounded and one-to-many requests share the same grouped
    solves in both packages and answer identically."""

    def burst(api):
        return [
            lambda s, t, u: api.QueryRequest(s, t, 3),
            lambda s, t, u: api.DiverseKSPRequest(s, t, k=3, min_dist=0.3),
            lambda s, t, u: api.BoundedKSPRequest(s, t, k=6, stretch=1.2),
            lambda s, t, u: api.OneToManyRequest(s, targets=(t, u), k=2),
        ] * (_N // 4)

    want = _trace(False, "dense_bf", "barrier",
                  requests=burst(jax_service))
    got = _trace(True, "cuda_bf", "barrier", requests=burst(torch_service))
    assert got == want


@pytest.mark.parametrize("update_mode", ["barrier", "streaming"])
@pytest.mark.parametrize("engine", ["cuda_bf", "dense_bf"])
def test_mesh_serving_equals_reference(engine, update_mode):
    """On a 2-shard CPU mesh (slab copies split over the shards, rounds
    padded to a multiple of 2, each shard's rows through the engine's
    own solve) the port serves repro's dense_bf (paths, epoch)."""
    want = _trace(False, "dense_bf", update_mode)
    got = _trace(True, engine, update_mode,
                 mesh=make_host_mesh(2, device="cpu"))
    assert got == want


def _run_mixed(port: bool, mesh=None):
    """Updates landing mid-flight (``wait=False``) in streaming mode, as
    ``tests/test_streaming.py::run_mixed``: {qid: (paths, epoch)}."""
    api = torch_service if port else jax_service
    g = (grid_road_network if port else jax_grid)(6, 6, seed=0)
    kw = {"device": "cpu", "mesh": mesh} if port else {}
    svc = api.KSPService.build(g, api.ServiceConfig(
        engine="dense_bf", n_workers=4, z=12, xi=4,
        update_mode="streaming", **kw))
    stream = (WeightUpdateStream if port else JaxStream)(
        g, alpha=0.5, tau=0.5, seed=7)
    done, sent = [], 0
    for i, (s, t, _) in enumerate(_queries(g.n, 12)):
        svc.submit(api.QueryRequest(s, t, 3))
        if i % 4 == 3 and sent < 3:
            svc.update(api.UpdateBatch(*stream.next_batch()), wait=False)
            sent += 1
        done.extend(svc.tick())
    done.extend(svc.drain())
    assert svc.epoch == 3
    return {tk.qid: (tk.result.paths, tk.result.epoch) for tk in done
            if tk.result is not None}


def test_streaming_under_mesh_equals_reference():
    want = _run_mixed(False)
    assert _run_mixed(True, mesh=make_host_mesh(2, device="cpu")) == want


@pytest.mark.parametrize("engine", ["cuda_bf", "dense_bf"])
def test_kill_revive_resync_under_mesh(engine):
    """A worker that missed a streaming batch re-syncs its split slab
    copy on revival: queries answer as repro's cluster does, and every
    copy equals its host slab, row for row, filler rows aside."""

    def run(port):
        g = (grid_road_network if port else jax_grid)(6, 6, seed=5)
        d = (DTLP if port else JaxDTLP).build(g, z=12, xi=4)
        kw = ({"device": "cpu", "mesh": make_host_mesh(2, device="cpu")}
              if port else {})
        cl = (Cluster if port else JaxCluster)(
            d, n_workers=3, engine=engine if port else "dense_bf", **kw)
        stream = (WeightUpdateStream if port else JaxStream)(
            g, alpha=0.5, tau=0.5, seed=3)
        cl.kill(1)
        dead = cl.workers[1]
        cl.apply_updates_streaming(*stream.next_batch())  # missed
        assert dead.epoch == 0 and len(dead.pending) == 1
        cl.revive(1)
        dead.ensure_epoch()  # lazy resync replays the missed batch
        assert dead.epoch == 1 and dead.stats.resyncs == 1
        # pairs whose host join stays short: after this 50% update some
        # pairs of the grid take tens of seconds of it (ROADMAP queue 1,
        # item 11), which is host work this test does not check
        return [cl.query(s, t, 3) for s, t in ((14, 31), (2, 20), (30, 5))], cl

    want, _ = run(False)
    got, cl = run(True)
    assert got == want
    for w in cl.workers:
        if w.slab is None:
            continue
        assert isinstance(w.slab.adj_dev, ShardedMirror)
        S = w.slab.adj.shape[0]
        np.testing.assert_array_equal(
            w.slab.adj_dev.full().numpy()[:S], w.slab.adj)
