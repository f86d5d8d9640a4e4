"""repro_torch kernels' plain versions vs the JAX reference, bit for bit.

The Hopper kernels themselves run only on the card (``chip_smoke.py``
holds them against these plain versions there).  Here, on the CPU, the
port's wrappers take their plain PyTorch path, which must equal the
reference's jnp oracles and its Pallas kernel in interpret mode — min-plus
uses only f32 add, min and compare, so no tolerance is needed."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.engine.backend import _pallas_grouped_solver
from repro.engine.yen_engine import grouped_solver as jax_grouped_solver
from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro_torch.engine import dense
from repro_torch.engine.yen_engine import grouped_solver
from repro_torch.kernels import bf_relax, ops, ref
from tests.test_backend import masked_slab
from tests.test_kernels import rand_slab


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _step_inputs(seed, S, J, z):
    rng = np.random.default_rng(seed)
    adj, dist = rand_slab(rng, S, J, z)
    spur = rng.random((S, J, z)) < 0.05  # general masks, not one-hot
    ban = rng.random((S, J, z)) < 0.1
    cap = rng.uniform(20, 80, (S, J)).astype(np.float32)
    return dist, adj, spur, ban, cap


class TestRelaxStep:
    @pytest.mark.parametrize("J", [1, 3, 8])
    @pytest.mark.parametrize("z", [96, 128, 200])
    def test_plain_step_matches_reference(self, z, J):
        """Plain step == jnp oracle == Pallas kernel (interpret), bitwise,
        at ragged z and J with general masks and finite caps."""
        dist, adj, spur, ban, cap = _step_inputs(10 * z + J, 2, J, z)
        got = ops.bf_relax_step(*_t(dist, adj, spur, ban, cap)).numpy()
        want = np.asarray(jax_ref.bf_relax_ref(
            jnp.asarray(dist), jnp.asarray(adj), jnp.asarray(spur),
            jnp.asarray(ban), jnp.asarray(cap)))
        pallas = np.asarray(jax_ops.bf_relax_step(
            jnp.asarray(dist), jnp.asarray(adj),
            jnp.asarray(spur, jnp.float32), jnp.asarray(ban, jnp.float32),
            jnp.asarray(cap)))
        assert got.dtype == np.float32 and got.shape == (2, J, z)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, pallas)

    def test_default_cap_and_float_masks(self):
        """``cap=None`` means INF and 0/1 float masks act as bool, as the
        reference wrapper's casts do."""
        dist, adj, spur, ban, _ = _step_inputs(3, 1, 2, 128)
        got = ops.bf_relax_step(*_t(dist, adj, spur.astype(np.float32),
                                    ban.astype(np.float32)))
        want = ref.bf_relax_ref(*_t(dist, adj, spur, ban),
                                torch.full((1, 2), ref.INF))
        assert torch.equal(got, want)


class TestFixedPoint:
    @pytest.mark.parametrize("seed,z,J", [(0, 24, 3), (1, 96, 4),
                                          (2, 128, 8), (3, 200, 3)])
    def test_plain_solves_match_reference(self, seed, z, J):
        """Both plain fixed points (the dense engine's and the fused
        kernel's) == the reference's Pallas fixed point and its jnp
        grouped solver: dist AND parents, bitwise."""
        rng = np.random.default_rng(seed)
        args = masked_slab(rng, 2, J, z)
        jargs = [jnp.asarray(a) for a in args]
        d_pl, p_pl = _pallas_grouped_solver(2, J, z, True)(*jargs)
        d_jn, p_jn = jax_grouped_solver(2, J, z)(*jargs)
        for d, p in (grouped_solver(*_t(*args)),
                     ref.bf_solve_grouped_ref(*_t(*args)),
                     ops.bf_solve_grouped(*_t(*args))):
            assert p.dtype == torch.int32
            for want_d, want_p in ((d_pl, p_pl), (d_jn, p_jn)):
                np.testing.assert_array_equal(d.numpy(), np.asarray(want_d))
                np.testing.assert_array_equal(p.numpy(), np.asarray(want_p))

    def test_iteration_count_matches_reference(self):
        """The plain loop never reads its change flag on the host, yet
        counts the iterations the reference's early-exit loop runs."""
        from repro.engine import dense as jax_dense

        rng = np.random.default_rng(5)
        adj, init, bv, so, bn, cap = masked_slab(rng, 2, 4, 40)
        d, it = dense.bf_solve_grouped(*_t(adj, init, bv, so, bn), cap=_t(cap)[0])
        jd, jit = jax_dense.bf_solve_grouped(
            *(jnp.asarray(a) for a in (adj, init, bv, so, bn)),
            cap=jnp.asarray(cap))
        np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
        assert int(it) == int(jit)

    def test_iteration_cap(self):
        """``max_iters`` bounds the fixed point exactly as the reference's
        ``max_iters`` does (a chain needs z-1 relaxations)."""
        from repro.engine import dense as jax_dense

        z = 16
        adj = np.full((1, z, z), ref.INF, np.float32)
        np.fill_diagonal(adj[0], 0.0)
        adj[0, np.arange(z - 1), np.arange(1, z)] = 1.0
        init = np.full((1, 1, z), ref.INF, np.float32)
        init[0, 0, 0] = 0.0
        for cap_iters in (3, 7):
            d, _ = dense.bf_solve_grouped(*_t(adj, init), max_iters=cap_iters)
            jd, _ = jax_dense.bf_solve_grouped(
                jnp.asarray(adj), jnp.asarray(init), max_iters=cap_iters)
            np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
            assert np.isfinite(d.numpy()[0, 0, cap_iters])
            assert d.numpy()[0, 0, cap_iters + 1] == ref.INF


class TestCudaLaunchers:
    """What the CUDA launchers decide on the host, without a card."""

    def test_tile_width(self):
        assert bf_relax.tile_width(1, 32, bf_relax.solve_smem) == 1
        assert bf_relax.tile_width(3, 96, bf_relax.solve_smem) == 4
        assert bf_relax.tile_width(40, 256, bf_relax.solve_smem) == 32
        assert bf_relax.tile_width(32, 1024, bf_relax.solve_smem) == 16
        for J, z in ((32, 256), (8, 2048), (32, 700)):
            for smem in (bf_relax.step_smem, bf_relax.solve_smem):
                assert smem(bf_relax.tile_width(J, z, smem), z) \
                    <= bf_relax.SMEM_LIMIT
        with pytest.raises(ValueError, match="shared memory"):
            bf_relax.tile_width(1, 40_000, bf_relax.solve_smem)

    def test_launchers_refuse_cpu_tensors(self):
        """A launcher never runs a plain version: off the card it raises
        before building anything."""
        dist, adj, spur, ban, cap = _t(*_step_inputs(0, 1, 2, 32))
        with pytest.raises(ValueError, match="CUDA device"):
            bf_relax.relax_step(dist, adj, spur, ban, cap)
        with pytest.raises(ValueError, match="CUDA device"):
            bf_relax.solve_grouped(adj, dist, spur, spur, ban, cap)

    def test_cpu_wrappers_count_no_launches(self):
        ops.reset_launches()
        dist, adj, spur, ban, cap = _t(*_step_inputs(1, 1, 2, 32))
        ops.bf_relax_step(dist, adj, spur, ban, cap)
        ops.bf_solve_grouped(adj, dist, spur, spur, ban, cap)
        assert ops.LAUNCHES == {"bf_relax_step": 0, "bf_solve_grouped": 0,
                                "ktrop_relax_step": 0, "ktrop_solve": 0,
                                "bound_dist": 0}
