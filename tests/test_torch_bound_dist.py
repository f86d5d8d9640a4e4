"""repro_torch's bound distances vs the JAX reference.

Bound distances sum floats, so parity is by tolerance: the clip-sum
forms (``ref.bound_dist_ref``, ``ops.bound_dist``/``bound_dist_blocked``
on CPU tensors) at rtol 2e-5 against the reference's oracle and its
Pallas kernel (interpret), as ``tests/test_kernels.py`` holds them; the
sort + prefix-sum forms (``dense.bound_dist``, ``dense.bound_dist_batch``
and the ``maintain`` cell's step) at rtol 1e-5, since torch's and XLA's
f32 ``cumsum`` differ in the last bits.  The Hopper kernel is held to
its plain version on the card by ``chip_smoke.py``."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.engine import dense as jax_dense
from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro_torch.configs.kspdg_arch import _maintain_step
from repro_torch.core.bounding import bound_distances, unit_weight_profile
from repro_torch.engine import dense
from repro_torch.kernels import bound_dist as bd_launcher
from repro_torch.kernels import ops, ref

_INF = ref.INF


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _sorted_profile(rng, S, E, pad=True):
    """Ascending unit weights, vfrag counts 1-8, a padded tail (w = INF,
    n = 0) on some rows, and the exclusive running count."""
    w = np.sort(rng.uniform(0.1, 5.0, (S, E)).astype(np.float32), -1)
    n = rng.integers(1, 9, (S, E)).astype(np.float32)
    if pad:
        for s in range(S):
            p = int(rng.integers(0, E // 4 + 1))
            if p:
                w[s, -p:] = _INF
                n[s, -p:] = 0.0
    cb = np.concatenate([np.zeros((S, 1), np.float32),
                         np.cumsum(n, -1)[:, :-1]], -1)
    return w, n, cb


def _unsorted_profile(rng, S, E):
    unit_w = rng.uniform(0.1, 5.0, (S, E)).astype(np.float32)
    unit_n = rng.integers(1, 9, (S, E)).astype(np.float32)
    unit_w[:, -3:] = _INF  # padding: sorts last, adds no fragments
    unit_n[:, -3:] = 0.0
    return unit_w, unit_n


class TestClipSum:
    @pytest.mark.parametrize("E", [1, 37, 64, 256])
    def test_per_query_matches_reference(self, E):
        """``bound_dist_ref`` and ``ops.bound_dist`` (CPU) == the reference
        oracle at rtol 2e-5, one subgraph per query, ragged B."""
        rng = np.random.default_rng(E)
        S, B = 4, 300
        w, n, cb = _sorted_profile(rng, S, E)
        sub = rng.integers(0, S, B).astype(np.int32)
        phi = rng.uniform(0, 1.1 * float(n.sum(-1).max()), B).astype(
            np.float32)
        want = np.asarray(jax_ref.bound_dist_ref(*map(jnp.asarray,
                                                      (w, n, cb, sub, phi))))
        for got in (ref.bound_dist_ref(*_t(w, n, cb, sub, phi)),
                    ops.bound_dist(*_t(w, n, cb, sub, phi))):
            assert got.dtype == torch.float32 and got.shape == (B,)
            np.testing.assert_allclose(got.numpy(), want, rtol=2e-5)

    @pytest.mark.parametrize("E", [64, 256])
    def test_blocked_matches_pallas(self, E):
        """``ops.bound_dist_blocked`` (the TPU signature) == the Pallas
        kernel in interpret mode and the oracle at rtol 2e-5."""
        rng = np.random.default_rng(100 + E)
        S, B = 3, 512
        w, n, cb = _sorted_profile(rng, S, E, pad=False)
        sub_blocked = rng.integers(0, S, B // 256).astype(np.int32)
        phi = rng.uniform(0, float(n.sum(-1).max()), B).astype(np.float32)
        pallas = np.asarray(jax_ops.bound_dist_blocked(
            *map(jnp.asarray, (w, n, cb, sub_blocked, phi))))
        oracle = np.asarray(jax_ref.bound_dist_ref(
            *map(jnp.asarray, (w, n, cb, np.repeat(sub_blocked, 256), phi))))
        got = ops.bound_dist_blocked(*_t(w, n, cb, sub_blocked, phi)).numpy()
        np.testing.assert_allclose(got, pallas, rtol=2e-5)
        np.testing.assert_allclose(got, oracle, rtol=2e-5)

    def test_blocked_ragged_b_and_shape_check(self):
        """A ragged B takes ceil(B/256) block indices (the last block is
        partial); any other count is refused."""
        rng = np.random.default_rng(5)
        w, n, cb = _sorted_profile(rng, 2, 16)
        phi = rng.uniform(0, 20, 300).astype(np.float32)
        sub_blocked = np.array([1, 0], np.int32)
        got = ops.bound_dist_blocked(*_t(w, n, cb, sub_blocked, phi))
        want = ref.bound_dist_ref(
            *_t(w, n, cb, np.repeat(sub_blocked, 256)[:300], phi))
        assert torch.equal(got, want)
        with pytest.raises(ValueError, match="sub_blocked"):
            ops.bound_dist_blocked(*_t(w, n, cb, np.array([1], np.int32), phi))


class TestSortPrefix:
    @pytest.mark.parametrize("seed,E", [(0, 64), (6, 64), (2, 300)])
    def test_batch_and_maintain_step_match_reference(self, seed, E):
        """``dense.bound_dist_batch`` and the ``maintain`` cell's step on
        CPU tensors == the reference's within rtol 1e-5, for φ up to each
        path's own subgraph total."""
        from repro.configs.kspdg_arch import _maintain_step as jax_maintain

        rng = np.random.default_rng(seed)
        S, B = 3, 256
        unit_w, unit_n = _unsorted_profile(rng, S, E)
        sub = rng.integers(0, S, B).astype(np.int32)
        phi = np.floor(rng.random(B) * (unit_n.sum(-1)[sub] + 1)).astype(
            np.float32)
        args = (unit_w, unit_n, sub, phi)
        want = np.asarray(jax_dense.bound_dist_batch(*map(jnp.asarray, args)))
        np.testing.assert_allclose(
            np.asarray(jax_maintain(*map(jnp.asarray, args))), want)
        for got in (dense.bound_dist_batch(*_t(*args)),
                    _maintain_step(*_t(*args))):
            assert got.dtype == torch.float32 and got.shape == (B,)
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)

    def test_one_profile_matches_reference(self):
        """``dense.bound_dist`` (one subgraph's profile) == the
        reference's within rtol 1e-5."""
        rng = np.random.default_rng(3)
        unit_w, unit_n = _unsorted_profile(rng, 1, 80)
        phi = np.floor(rng.random(50) * unit_n.sum()).astype(np.float32)
        want = np.asarray(jax_dense.bound_dist(
            jnp.asarray(unit_w[0]), jnp.asarray(unit_n[0]), jnp.asarray(phi)))
        got = dense.bound_dist(*_t(unit_w[0], unit_n[0], phi)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5)

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_matches_core_bound_distances(self, seed):
        """The sort + prefix form, the maintain step and the clip-sum on
        the sorted profile == the paper-level reference
        (``core.bounding.bound_distances``) within rtol 1e-5."""
        rng = np.random.default_rng(seed)
        En = 20
        w_edge = rng.uniform(1.0, 9.0, En)
        vf = np.maximum(1, np.rint(w_edge)).astype(np.int64)
        phis = np.array([1, 2, 5, int(vf.sum()) // 2, int(vf.sum())])
        want = bound_distances(unit_weight_profile(w_edge, vf), phis)
        unit_w = (w_edge / vf).astype(np.float32)[None]
        unit_n = vf.astype(np.float32)[None]
        sub = np.zeros(len(phis), np.int32)
        phi = phis.astype(np.float32)
        w_s, n_s, cum_n = dense.sort_profile(*_t(unit_w, unit_n))
        for got in (dense.bound_dist_batch(*_t(unit_w, unit_n, sub, phi)),
                    _maintain_step(*_t(unit_w, unit_n, sub, phi)),
                    ops.bound_dist(w_s, n_s, cum_n - n_s, *_t(sub, phi))):
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)


class TestCudaLauncher:
    def test_launcher_refuses_cpu_tensors(self):
        w, n, cb = _t(*_sorted_profile(np.random.default_rng(0), 2, 8))
        sub, phi = torch.zeros(4, dtype=torch.int32), torch.ones(4)
        with pytest.raises(ValueError, match="CUDA device"):
            bd_launcher.bound_dist(w, n, cb, sub, phi)
