"""End-to-end serving parity: the port twin of ``bench_engine.
bench_backend_compare``.  One trace — queries, one UpdateBatch, queries —
through the reference ``dense_bf`` and through the port's ``cuda_bf`` and
``dense_bf`` on the CPU device; the ``(paths, epoch)`` lists must be
equal in both update modes with the pipeline on and off."""

import numpy as np
import pytest

import repro.service as jax_service
import repro_torch.service as torch_service
from repro.core.dtlp import DTLP as JaxDTLP
from repro.data.roadnet import WeightUpdateStream as JaxStream
from repro.data.roadnet import grid_road_network as jax_grid
from repro_torch.core.dtlp import DTLP
from repro_torch.data.roadnet import WeightUpdateStream, grid_road_network

_N = 8


def _queries(n_vertices, n, seed=3):
    rng = np.random.default_rng(seed)
    return [tuple(map(int, rng.choice(n_vertices, 3, replace=False)))
            for _ in range(n)]


def _trace(port: bool, engine: str, update_mode: str, pipeline: bool,
           requests=None):
    """Replay the trace on a fresh 6x6 grid; returns [(paths, epoch)]."""
    api = torch_service if port else jax_service
    g = (grid_road_network if port else jax_grid)(6, 6, seed=0)
    d = (DTLP if port else JaxDTLP).build(g, z=12, xi=4)
    kw = {"device": "cpu"} if port else {}
    svc = api.KSPService(d, api.ServiceConfig(
        engine=engine, n_workers=2, max_in_flight=4, pipeline=pipeline,
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
    want = _trace(False, "dense_bf", update_mode, pipeline)
    assert [e for _, e in want] == [0] * (_N // 2) + [1] * (_N // 2)
    assert all(paths for paths, _ in want)
    for engine in ("cuda_bf", "dense_bf"):
        got = _trace(True, engine, update_mode, pipeline)
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

    want = _trace(False, "dense_bf", "barrier", True, burst(jax_service))
    got = _trace(True, "cuda_bf", "barrier", True, burst(torch_service))
    assert got == want
