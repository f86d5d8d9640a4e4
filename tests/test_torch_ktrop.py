"""repro_torch's k-distinct tropical relaxation vs the JAX reference.

The port's plain step (``kernels.ref.ktrop_relax_ref``, the CPU path of
``ops.ktrop_relax_step``, ``engine.dense.ktrop_step``) and its fixed point
(``dense.ktrop_solve``, the ``levels`` cell) must equal ``repro``'s bit
for bit: both sort f32 sums, and the sorted distinct set does not depend
on the order it is built in.  The Hopper kernels are held to these plain
versions on the card by ``chip_smoke.py``."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.engine import dense as jax_dense
from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro_torch.configs.kspdg_arch import _levels_step
from repro_torch.core.bounding import kdistinct_walk_dp
from repro_torch.engine import dense
from repro_torch.kernels import ktrop, ops, ref
from tests.test_core_graph import random_graph
from tests.test_engine import dense_adj

_INF = ref.INF


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _vfrag_slab(rng, S, z, density=0.3):
    """Integer vfrag weights 1-8 (many ties, so dedupe matters), 0
    diagonal, INF elsewhere."""
    adj = rng.integers(1, 9, (S, z, z)).astype(np.float32)
    adj[rng.random((S, z, z)) > density] = _INF
    for s in range(S):
        np.fill_diagonal(adj[s], 0.0)
    return adj


def _sources(rng, S, k, z):
    D = np.full((S, k, z), _INF, np.float32)
    D[np.arange(S), 0, rng.integers(z, size=S)] = 0.0
    return D


class TestStep:
    @pytest.mark.parametrize("z,k", [(128, 2), (128, 10), (256, 4)])
    def test_plain_step_matches_reference_and_pallas(self, z, k):
        """Three chained relaxations from single sources: the port's three
        plain forms == the jnp oracle == the Pallas kernel (interpret),
        bitwise, INF padding included; no +inf ever comes out."""
        rng = np.random.default_rng(z + k)
        adj = _vfrag_slab(rng, 2, z)
        D = _sources(rng, 2, k, z)
        for _ in range(3):
            want = np.asarray(jax_ref.ktrop_relax_ref(jnp.asarray(D),
                                                      jnp.asarray(adj)))
            pallas = np.asarray(jax_ops.ktrop_relax_step(jnp.asarray(D),
                                                         jnp.asarray(adj)))
            np.testing.assert_array_equal(pallas, want)
            for got in (ref.ktrop_relax_ref(*_t(D, adj)),
                        ops.ktrop_relax_step(*_t(D, adj)),
                        dense.ktrop_step(*_t(D, adj))):
                assert got.dtype == torch.float32 and got.shape == (2, k, z)
                np.testing.assert_array_equal(got.numpy(), want)
            assert not np.isinf(want).any()
            D = want

    @pytest.mark.parametrize("z,k", [(1, 1), (33, 16), (200, 3)])
    @pytest.mark.parametrize("distinct", [True, False])
    def test_engine_step_at_ragged_z(self, z, k, distinct):
        """``dense.ktrop_step`` == the reference's ``E.ktrop_step`` at a z
        the Pallas kernel refuses, from a mid-relaxation D (real-valued
        weights and partial levels), with and without dedupe."""
        rng = np.random.default_rng(7 * z + k)
        adj = np.round(rng.uniform(1.0, 20.0, (2, z, z)), 1).astype(np.float32)
        adj[rng.random((2, z, z)) > 0.4] = _INF
        for s in range(2):
            np.fill_diagonal(adj[s], 0.0)
        D = np.asarray(jax_dense.ktrop_step(
            jnp.asarray(_sources(rng, 2, k, z)), jnp.asarray(adj), distinct))
        want = np.asarray(jax_dense.ktrop_step(jnp.asarray(D),
                                               jnp.asarray(adj), distinct))
        got = dense.ktrop_step(*_t(D, adj), distinct=distinct).numpy()
        np.testing.assert_array_equal(got, want)


class TestFixedPoint:
    @pytest.mark.parametrize("z,k,max_iters", [(24, 3, None), (40, 10, None),
                                               (64, 4, 3), (96, 2, None)])
    def test_solve_matches_reference(self, z, k, max_iters):
        """``dense.ktrop_solve`` and ``ops.ktrop_solve`` (CPU) == the
        reference's while loop, bitwise, to the fixed point and with the
        iteration cap binding."""
        rng = np.random.default_rng(z * k)
        adj = _vfrag_slab(rng, 3, z, density=0.15)
        src = rng.integers(z, size=3).astype(np.int32)
        want = np.asarray(jax_dense.ktrop_solve(
            jnp.asarray(adj), jnp.asarray(src), k, max_iters=max_iters))
        for got in (dense.ktrop_solve(*_t(adj, src), k, max_iters=max_iters),
                    ops.ktrop_solve(*_t(adj, src), k, max_iters=max_iters)):
            np.testing.assert_array_equal(got.numpy(), want)

    def test_per_row_iterations(self):
        """The per-row counts the kernel reports (``with_iters=True``): a
        row stops after its first relaxation that changes nothing, and the
        largest count is what the reference's global loop runs (a chain
        needs z relaxations to settle, an isolated source one)."""
        z = 12
        adj = np.full((2, z, z), _INF, np.float32)
        for s in range(2):
            np.fill_diagonal(adj[s], 0.0)
        adj[0, np.arange(z - 1), np.arange(1, z)] = 1.0  # a chain
        D, iters = ref.ktrop_solve_ref(*_t(adj, np.array([0, 3], np.int32)), 1)
        assert iters.tolist() == [z, 1]
        assert D[0, 0].tolist() == list(range(z))
        for cap in (4, z - 1, z):
            want = np.asarray(jax_dense.ktrop_solve(
                jnp.asarray(adj), jnp.asarray([0, 3]), 1, max_iters=cap))
            got, it = ops.ktrop_solve(*_t(adj, np.array([0, 3])), 1, cap,
                                      with_iters=True)
            np.testing.assert_array_equal(got.numpy(), want)
            assert it.tolist() == [cap, 1]

    def test_levels_step_matches_reference(self):
        """The ``levels`` cell's step (k=10, 48 iterations) on CPU tensors
        == the reference's, bitwise."""
        from repro.configs.kspdg_arch import _levels_step as jax_levels

        rng = np.random.default_rng(11)
        adj = _vfrag_slab(rng, 2, 64, density=0.06)
        src = rng.integers(64, size=2).astype(np.int32)
        want = np.asarray(jax_levels(jnp.asarray(adj), jnp.asarray(src)))
        got = _levels_step(*_t(adj, src))
        assert got.shape == (2, 10, 64)
        np.testing.assert_array_equal(got.numpy(), want)

    @pytest.mark.parametrize("seed,k", [(0, 2), (1, 3), (2, 5)])
    def test_matches_numpy_walk_dp(self, seed, k):
        """The port's fixed point == its host DP (``core.bounding``) on
        the collapsed CSR of a random graph, within rtol 1e-5."""
        g = random_graph(12, 28, seed)
        adj = dense_adj(g)
        src_l, dst_l = np.nonzero((adj < _INF / 2) & ~np.eye(g.n, dtype=bool))
        order = np.argsort(src_l, kind="stable")
        src_l, dst_l = src_l[order], dst_l[order]
        indptr = np.zeros(g.n + 1, np.int64)
        np.cumsum(np.bincount(src_l, minlength=g.n), out=indptr[1:])
        want = kdistinct_walk_dp(
            indptr, dst_l, adj[src_l, dst_l].astype(np.float64), 0, k)
        got = dense.ktrop_solve(*_t(adj[None], np.array([0])), k)[0].numpy()
        got = np.where(got > _INF / 2, np.inf, got)
        np.testing.assert_allclose(got, want, rtol=1e-5)


class TestCudaLaunchers:
    """What the ktrop launchers decide on the host, without a card."""

    def test_launchers_refuse_cpu_tensors(self):
        rng = np.random.default_rng(0)
        adj = _vfrag_slab(rng, 1, 16)
        D, adj_t = _t(_sources(rng, 1, 2, 16), adj)
        with pytest.raises(ValueError, match="CUDA device"):
            ktrop.relax_step(D, adj_t)
        with pytest.raises(ValueError, match="CUDA device"):
            ktrop.solve(adj_t, torch.zeros(1, dtype=torch.int32), 2)

    @pytest.mark.parametrize("k", [0, 17])
    def test_k_out_of_range(self, k):
        D = torch.full((1, k, 8), _INF)
        with pytest.raises(ValueError, match="k <= 16"):
            ktrop.relax_step(D, torch.zeros(1, 8, 8))

    def test_solve_shared_memory_limit(self):
        assert ktrop.solve_smem(10, 256) == 54_280  # D tiles + in-edge list
        with pytest.raises(ValueError, match="shared memory"):
            ktrop.solve(torch.zeros(1, 2048, 2048),
                        torch.zeros(1, dtype=torch.int32), 16)
