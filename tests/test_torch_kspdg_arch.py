"""repro_torch's kspdg architecture (the refine/maintain/index data
plane) and its flat engine vs the JAX reference: the flat Bellman–Ford,
``engine_ksp``, the ``refine`` cell's step with its 64-iteration cap, the
shape inventory and the registry.  (The ``levels`` and ``maintain`` steps
are held in ``test_torch_ktrop.py`` and ``test_torch_bound_dist.py``.)"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.configs import kspdg_arch as jax_arch
from repro.engine import dense as jax_dense
from repro.engine import yen_engine as jax_yen
from repro_torch.configs import kspdg_arch
from repro_torch.configs.base import all_archs, get_arch
from repro_torch.core.sssp import graph_view
from repro_torch.core.yen import ksp
from repro_torch.engine import dense, yen_engine
from repro_torch.kernels import ref
from tests.test_backend import masked_slab
from tests.test_core_graph import random_graph
from tests.test_engine import dense_adj

_INF = ref.INF


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _port_graph(g):
    from repro_torch.convert import graph_from_numpy

    return graph_from_numpy({"n": g.n, "edge_u": g.edge_u,
                             "edge_v": g.edge_v, "w": g.w,
                             "directed": g.directed})


class TestFlatBF:
    @pytest.mark.parametrize("seed,P,z", [(0, 3, 24), (1, 4, 40), (2, 1, 17)])
    def test_solve_and_parents_match_reference(self, seed, P, z):
        """Flat ``bf_solve``/``bf_parents`` == the reference's, bitwise,
        with every mask and a finite cap; the iteration count too."""
        rng = np.random.default_rng(seed)
        adj, init, bv, so, bn, cap = masked_slab(rng, P, 1, z)
        flat = (adj, init[:, 0], bv[:, 0], so[:, 0], bn[:, 0], cap[:, 0])
        jd, jit = jax_dense.bf_solve(*map(jnp.asarray, flat[:5]),
                                     cap=jnp.asarray(flat[5]))
        jp = jax_dense.bf_parents(jnp.asarray(adj), jd, jnp.asarray(flat[3]),
                                  jnp.asarray(flat[4]))
        d, it = dense.bf_solve(*_t(*flat[:5]), cap=_t(flat[5])[0])
        p = dense.bf_parents(_t(adj)[0], d, *_t(flat[3], flat[4]))
        np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
        np.testing.assert_array_equal(p.numpy(), np.asarray(jp))
        assert p.dtype == torch.int32 and int(it) == int(jit)

    def test_step_matches_reference(self):
        rng = np.random.default_rng(4)
        adj, init, _, so, bn, _ = masked_slab(rng, 3, 1, 30)
        args = (init[:, 0], adj, so[:, 0], bn[:, 0])
        want = np.asarray(jax_dense.bf_step(*map(jnp.asarray, args)))
        np.testing.assert_array_equal(dense.bf_step(*_t(*args)).numpy(), want)


class TestEngineKSP:
    @pytest.mark.parametrize("seed,k", [(0, 1), (3, 3), (8, 4), (21, 5)])
    def test_matches_reference_and_core_yen(self, seed, k):
        """``engine_ksp`` on CPU tensors: the reference's paths exactly,
        and host Yen's distances within rtol 1e-5."""
        g = random_graph(14, 34, seed)
        adj = dense_adj(g)
        rng = np.random.default_rng(seed)
        s, t = map(int, rng.choice(g.n, size=2, replace=False))
        got = yen_engine.engine_ksp(adj, s, t, k, device="cpu")
        want = jax_yen.engine_ksp(adj, s, t, k)
        assert [p for _, p in got] == [p for _, p in want]
        np.testing.assert_array_equal([d for d, _ in got],
                                      [d for d, _ in want])
        host = ksp(graph_view(_port_graph(g)), s, t, k)
        np.testing.assert_allclose([d for d, _ in got],
                                   [d for d, _ in host], rtol=1e-5)

    def test_spur_batch_matches_reference(self):
        """One padded spur batch (warm starts and caps) == the
        reference's, bitwise."""
        rng = np.random.default_rng(2)
        adj = dense_adj(random_graph(16, 40, 2))
        z = adj.shape[0]
        jobs = [(int(rng.integers(z)), rng.random(z) < 0.1,
                 rng.random(z) < 0.2) for _ in range(3)]
        warm = [None, np.full(z, 30.0, np.float32), None]
        caps = np.array([_INF, 25.0, 40.0])
        d, p = yen_engine._spur_batch(adj, jobs, warm=warm, caps=caps,
                                      device="cpu")
        jd, jp = jax_yen._spur_batch(adj, jobs, warm=warm, caps=caps)
        np.testing.assert_array_equal(d, jd)
        np.testing.assert_array_equal(p, jp)


class TestRefineStep:
    def _chain(self, z):
        adj = np.full((2, z, z), _INF, np.float32)
        for s in range(2):
            np.fill_diagonal(adj[s], 0.0)
        adj[:, np.arange(z - 1), np.arange(1, z)] = 1.0
        init = np.full((2, 2, z), _INF, np.float32)
        init[:, 0, 0] = 0.0  # the chain's head: 95 hops to settle
        init[:, 1, z - 5] = 0.0  # 4 hops
        zeros = np.zeros((2, 2, z), bool)
        return adj, init, zeros, zeros, zeros, np.full((2, 2), _INF, np.float32)

    @pytest.mark.parametrize("case", ["chain", "masked"])
    def test_matches_reference(self, case):
        """``_refine_step`` on CPU tensors == the reference's, bitwise:
        on a 96-vertex chain that needs more than 64 relaxations the cap
        binds (vertex 64 settles, vertex 65 stays INF); on a masked
        mid-relaxation slab it does not.  The largest per-row iteration
        count is the reference's global count."""
        if case == "chain":
            args = self._chain(96)
        else:
            args = masked_slab(np.random.default_rng(9), 3, 5, 40)
        jd, jp, jit = jax_arch._refine_step(*map(jnp.asarray, args))
        d, p, it = kspdg_arch._refine_step(*_t(*args))
        np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
        np.testing.assert_array_equal(p.numpy(), np.asarray(jp))
        assert it.dtype == torch.int32 and it.shape == (args[0].shape[0],)
        assert int(it.max()) == int(jit)
        if case == "chain":
            assert int(jit) == 64
            assert d[0, 0, 64] == 64.0 and d[0, 0, 65] == _INF


class TestArch:
    def test_registry_holds_kspdg(self):
        assert set(all_archs()) == {"kspdg"}
        arch = get_arch("kspdg")
        assert arch.family == "ksp" and arch.smoke_fn is kspdg_arch.kspdg_smoke

    def test_cells_match_reference_inventory(self):
        """Same four cells, shapes, dtypes, axes and notes; only the
        cluster-sized ``refine_cusa`` carries a skip reason."""
        want = jax_arch.kspdg_cells()
        got = get_arch("kspdg").cells()
        assert [c.shape for c in got] == [c.shape for c in want]
        for g, w in zip(got, want):
            assert (g.arch, g.kind, g.note) == (w.arch, w.kind, w.note)
            assert g.arg_axes == w.arg_axes
            assert [(tuple(s.shape), str(s.dtype).replace("torch.", ""))
                    for s in g.arg_specs] == \
                [(tuple(s.shape), str(s.dtype)) for s in w.arg_specs]
            assert (g.skip is not None) == (g.shape == "refine_cusa")
        assert got[0].arg_specs[0].nbytes == 122_880 * 1024 * 1024 * 4

    def test_smoke_on_cpu(self):
        assert get_arch("kspdg").smoke_fn(device="cpu") == \
            {"engine_ksp_checked": 6}
