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

    @pytest.mark.parametrize("part", ["group", "evaluate"])
    def test_grouping_and_evaluation_refuse_cpu_tensors(self, part):
        """Each half of the launcher checks its tensors before any launch:
        a CPU tensor raises, it never falls back."""
        w, n, cb = _t(*_sorted_profile(np.random.default_rng(1), 2, 8))
        sub, phi = torch.zeros(4, dtype=torch.int32), torch.ones(4)
        with pytest.raises(ValueError, match="CUDA device"):
            if part == "group":
                bd_launcher.group(sub, phi, 2)
            else:
                groups = bd_launcher.Groups(
                    *(torch.zeros(1, dtype=torch.int32),) * 6)
                bd_launcher.evaluate(w, n, cb, groups)

    @pytest.mark.parametrize("S,E,B", [(3, 8, 0), (7, 37, 1000),
                                       (122_880, 4, 300_001)])
    def test_evaluation_checks_the_grouping_it_reads(self, monkeypatch, S,
                                                     E, B):
        """``evaluate`` checks every field of the grouping that its kernel
        reads, as ``group`` makes it for B queries over S subgraphs, before
        any launch.  The CPU host has no CUDA tensor to pass, so the checks
        are recorded here; the card refuses CPU groups in ``chip_smoke.py``.
        """
        seen = []

        class Checked(Exception):
            pass

        def record(name, t, dtype, shape, device):
            seen.append((name, t, dtype, tuple(shape)))
            if name == "groups.items":
                raise Checked

        monkeypatch.setattr(bd_launcher, "check_tensor", record)
        w = torch.zeros((S, E))
        groups = bd_launcher.Groups(
            *(torch.zeros(1, dtype=torch.int32),) * 2,
            torch.zeros(B, dtype=torch.int32), torch.zeros(B),
            *(torch.zeros(1, dtype=torch.int32),) * 2)
        with pytest.raises(Checked):
            bd_launcher.evaluate(w, w, w, groups)
        i32, f32 = torch.int32, torch.float32
        want = [("w_sorted", w, f32, (S, E)), ("n_sorted", w, f32, (S, E)),
                ("cum_before", w, f32, (S, E)),
                ("groups.order", groups.order, i32, (B,)),
                ("groups.phi_sorted", groups.phi_sorted, f32, (B,)),
                ("groups.item_off", groups.item_off, i32, (S + 1,)),
                ("groups.items", groups.items, i32,
                 (bd_launcher.max_items(B, S, bd_launcher.PER_ITEM), 4))]
        assert [(n, d, s) for n, _, d, s in seen] == \
            [(n, d, s) for n, _, d, s in want]
        assert all(a is b for (_, a, _, _), (_, b, _, _) in zip(seen, want))


# ---------------------------------------------------------------------------
# the Hopper kernel's order and grouping, on the CPU
# ---------------------------------------------------------------------------
def _subs(kind, rng, S, B):
    """Query subgraphs: uniform, all on one subgraph, Zipf-like, or
    spread over a tenth of the subgraphs (most subgraphs empty)."""
    if kind == "uniform":
        sub = rng.integers(0, S, B)
    elif kind == "one":
        sub = np.full(B, S // 2)
    elif kind == "zipf":
        sub = np.minimum(rng.zipf(1.5, B) - 1, S - 1)
    else:  # "sparse"
        sub = rng.choice(rng.permutation(S)[: max(1, S // 10)], B)
    return sub.astype(np.int32)


def _seq_loop(w, n, cb, sub, phi, stop=True):
    """The clip-sum of every query in ascending e, one f32 rounding per
    step, in numpy: stopping at the first cb ≥ φ, or run to E."""
    acc = np.zeros(len(phi), np.float32)
    alive = np.ones(len(phi), bool)
    for e in range(w.shape[1]):
        c = cb[sub, e]
        if stop:
            alive &= ~(c >= phi)
        take = np.minimum(np.maximum(phi - c, np.float32(0.0)), n[sub, e])
        acc = np.where(alive, acc + w[sub, e] * take, acc)
    return acc


def _phis(rng, n, B, scale=1.1):
    """φ up to ``scale`` times the largest row total, with φ = 0 and φ
    on a running-count boundary among them."""
    phi = rng.uniform(0, scale * float(n.sum(-1).max()), B).astype(np.float32)
    phi[:2] = [0.0, float(n[0, :3].sum())]
    return phi


class TestSequentialOrder:
    @pytest.mark.parametrize("E", [1, 37, 64, 256])
    def test_seq_matches_reference(self, E):
        """``bound_dist_seq_ref`` (the kernel's order, early stop) == the
        reference oracle at rtol 2e-5, ragged B."""
        rng = np.random.default_rng(200 + E)
        S, B = 4, 300
        w, n, cb = _sorted_profile(rng, S, E)
        sub = rng.integers(0, S, B).astype(np.int32)
        phi = _phis(rng, n, B)
        want = np.asarray(jax_ref.bound_dist_ref(*map(jnp.asarray,
                                                      (w, n, cb, sub, phi))))
        got = ref.bound_dist_seq_ref(*_t(w, n, cb, sub, phi))
        assert got.dtype == torch.float32 and got.shape == (B,)
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-5)

    @pytest.mark.parametrize("E", [64, 256])
    def test_seq_matches_pallas(self, E):
        """``bound_dist_seq_ref`` == the Pallas kernel in interpret mode at
        rtol 2e-5 (blocked queries, expanded to one subgraph each)."""
        rng = np.random.default_rng(300 + E)
        S, B = 3, 512
        w, n, cb = _sorted_profile(rng, S, E, pad=False)
        sub_blocked = rng.integers(0, S, B // 256).astype(np.int32)
        phi = rng.uniform(0, float(n.sum(-1).max()), B).astype(np.float32)
        pallas = np.asarray(jax_ops.bound_dist_blocked(
            *map(jnp.asarray, (w, n, cb, sub_blocked, phi))))
        got = ref.bound_dist_seq_ref(
            *_t(w, n, cb, np.repeat(sub_blocked, 256), phi)).numpy()
        np.testing.assert_allclose(got, pallas, rtol=2e-5)

    @pytest.mark.parametrize("seed,E,pad", [(0, 1, False), (1, 37, True),
                                            (2, 64, True), (3, 300, True),
                                            (4, 300, False)])
    def test_early_stop_gives_the_full_loop_bytes(self, seed, E, pad):
        """With w ≥ 0, n ≥ 0 and cb the exclusive running count, the
        early stop gives the loop run to E bit for bit (the dropped terms
        are w·(+0) = +0), φ past the row's total included."""
        rng = np.random.default_rng(seed)
        S, B = 5, 400
        w, n, cb = _sorted_profile(rng, S, E, pad=pad)
        sub = rng.integers(0, S, B).astype(np.int32)
        phi = _phis(rng, n, B)
        full = _seq_loop(w, n, cb, sub, phi, stop=False)
        got = ref.bound_dist_seq_ref(*_t(w, n, cb, sub, phi))
        assert torch.equal(got, torch.from_numpy(full))
        assert torch.equal(got, torch.from_numpy(
            _seq_loop(w, n, cb, sub, phi)))

    def test_stop_rule_on_any_cum_before(self):
        """The stop is at the first e with cb ≥ φ, also where cb is not a
        running count (not monotone): the terms after it are dropped."""
        rng = np.random.default_rng(9)
        S, E, B = 3, 50, 200
        w = rng.uniform(0.1, 5.0, (S, E)).astype(np.float32)
        n = rng.integers(1, 9, (S, E)).astype(np.float32)
        cb = rng.uniform(0, 100, (S, E)).astype(np.float32)
        sub = rng.integers(0, S, B).astype(np.int32)
        phi = rng.uniform(0, 120, B).astype(np.float32)
        got = ref.bound_dist_seq_ref(*_t(w, n, cb, sub, phi))
        assert torch.equal(got, torch.from_numpy(
            _seq_loop(w, n, cb, sub, phi)))
        assert not torch.equal(got, torch.from_numpy(
            _seq_loop(w, n, cb, sub, phi, stop=False)))


class TestGrouping:
    @pytest.mark.parametrize("kind,S,B", [("uniform", 50, 1000),
                                          ("one", 50, 777),
                                          ("zipf", 200, 3000),
                                          ("sparse", 500, 1000),
                                          ("uniform", 7, 0)])
    def test_group_by_subgraph_matches_numpy(self, kind, S, B):
        """``ref.group_by_subgraph``: counts, offsets (exclusive scan) and a
        stable order of the queries by subgraph, as numpy gives them."""
        sub = _subs(kind, np.random.default_rng(S + B), S, B)
        counts, offsets, order = ref.group_by_subgraph(torch.from_numpy(sub),
                                                       S)
        want = np.bincount(sub, minlength=S)
        assert counts.dtype == offsets.dtype == order.dtype == torch.int32
        np.testing.assert_array_equal(counts.numpy(), want)
        np.testing.assert_array_equal(offsets.numpy(),
                                      np.concatenate([[0], np.cumsum(want)]))
        np.testing.assert_array_equal(order.numpy(),
                                      np.argsort(sub, kind="stable"))

    @pytest.mark.parametrize("kind", ["uniform", "one", "zipf", "sparse"])
    @pytest.mark.parametrize("per_item", [32, 64, 128])
    def test_max_items_bounds_the_work_items(self, kind, per_item):
        """The launcher sizes the work-item list without reading the
        counts: ``max_items`` is never below sum ceil(counts / per_item)."""
        for S, B in ((50, 1000), (1000, 300), (3, 5000)):
            counts = np.bincount(_subs(kind, np.random.default_rng(B), S, B),
                                 minlength=S)
            items = int((-(-counts // per_item)).sum())
            assert items <= bd_launcher.max_items(B, S, per_item)


def _exact_steps(cb, n, cb_next):
    """The kernel's per-pair check: cb ≤ cb_next, and cb + n == cb_next
    exactly in f32 (rounded sum equal, TwoSum error 0) with n ≥ +0."""
    with np.errstate(over="ignore", invalid="ignore"):
        s = cb + n
        dp = s - cb
        err = (cb - (s - dp)) + (n - dp)
    return (cb <= cb_next, ~np.signbit(n) & (s == cb_next) & (err == 0))


def _emulate_kernel(w, n, cb, sub, phi, per_item, grid, seg=None):
    """The evaluation kernel's walk and arithmetic, in numpy f32: work
    items of at most ``per_item`` queries per subgraph (the launcher's
    scans, the items kernel's search), batches of ``BATCH`` items in
    contiguous ranges per persistent block, the items of one subgraph in a
    batch sharing one staged row, each row in segments of ``seg`` entries,
    staged while the batch's largest φ of the row lies past the segment's
    first entry.  While every segment so far has exact running counts
    (also into the next segment's first entry), a row's queries take the
    prefix sums: a sequential prefix P of w·n carried across segments,
    each query's stop k found by search, its sum P[k-2] plus its last
    term; from the first segment that is not exact on, the loop.  Returns
    (out, writes per query, segments evaluated by path)."""
    seg = seg or bd_launcher.SEGMENT
    S, E = w.shape
    B = len(phi)
    counts, offsets, order = (x.numpy() for x in ref.group_by_subgraph(
        torch.from_numpy(sub), S))
    item_off = np.concatenate([[0], np.cumsum(-(-counts // per_item))])
    n_items = int(item_off[-1])
    assert n_items <= bd_launcher.max_items(B, S, per_item)
    item_sub = np.searchsorted(item_off, np.arange(n_items), "right") - 1
    first = offsets[item_sub] + (np.arange(n_items)
                                 - item_off[item_sub]) * per_item
    last = np.minimum(first + per_item, offsets[item_sub + 1])
    phi_sorted = phi[order]
    out = np.zeros(B, np.float32)
    writes = np.zeros(B, int)
    steps = {"prefix": 0, "loop": 0}
    batches = -(-n_items // bd_launcher.BATCH)
    per = -(-batches // grid)
    for bt in range(batches):
        assert bt // per < grid
        items = range(bt * bd_launcher.BATCH,
                      min(n_items, (bt + 1) * bd_launcher.BATCH))
        for r in sorted(set(item_sub[list(items)])):  # one staged row each
            pos = np.concatenate([np.arange(first[i], last[i])
                                  for i in items if item_sub[i] == r])
            p = phi_sorted[pos]
            top = p.max()
            acc = np.zeros(len(p), np.float32)
            done = np.zeros(len(p), bool)
            by_prefix, carry = True, np.float32(0.0)
            for e0 in range(0, E, seg):
                if e0 > 0 and not cb[r, e0] < top:
                    break  # not staged: every query stopped before
                e1 = min(E, e0 + seg)
                c_t, n_t, w_t = cb[r, e0:e1], n[r, e0:e1], w[r, e0:e1]
                nxt = np.append(c_t[1:], cb[r, e1] if e1 < E else np.inf)
                exact = _exact_steps(c_t, n_t, nxt)[1]
                if e1 == E:
                    exact[-1] = not np.signbit(n_t[-1])
                if by_prefix and exact.all():
                    steps["prefix"] += 1
                    P = np.cumsum(np.append(carry, w_t * n_t),
                                  dtype=np.float32)
                    k = np.searchsorted(c_t, p, "left")  # count of cb < φ
                    stops = ~done & ((k < len(c_t)) | (nxt[-1] >= p))
                    j = np.maximum(k - 1, 0)
                    nj = np.where(k < len(c_t),
                                  c_t[np.minimum(k, len(c_t) - 1)] - c_t[j],
                                  n_t[-1])
                    end = P[j] + w_t[j] * np.minimum(p - c_t[j], nj)
                    acc = np.where(stops, np.where(k == 0, carry, end), acc)
                    done |= stops
                    carry = P[-1]
                else:
                    steps["loop"] += 1
                    if by_prefix:
                        acc = np.where(done, acc, carry)
                    by_prefix = False
                    for e in range(len(c_t)):
                        done |= c_t[e] >= p
                        # before the stop φ − cb > 0: no clamp at 0
                        # (stopped lanes may overflow; their terms drop)
                        with np.errstate(over="ignore"):
                            term = w_t[e] * np.minimum(p - c_t[e], n_t[e])
                        acc = np.where(done, acc, acc + term)
            assert by_prefix is False or done.all()
            out[order[pos]] = acc
            writes[order[pos]] += 1
    return out, writes, steps


def _mixed_profile(rng, S, E, kind):
    """Sorted profiles whose running counts are exact ("exact", integer
    vfrag counts), not exact anywhere ("frac": fractional counts), exact
    on the first half of each row only ("half"), or not monotone
    ("shuffled" cum_before)."""
    w, n, cb = _sorted_profile(rng, S, E)
    if kind in ("frac", "half"):
        lo = E // 2 if kind == "half" else 0
        n[:, lo:] = np.where(n[:, lo:] > 0, n[:, lo:] + np.float32(0.1), 0)
        cb = np.concatenate([np.zeros((S, 1), np.float32),
                             np.cumsum(n, -1, dtype=np.float32)[:, :-1]], -1)
    elif kind == "shuffled":
        cb = rng.permuted(cb, axis=1)
    return w, n, cb


class TestKernelWalk:
    @pytest.mark.parametrize("kind,S,E,B,per_item,grid", [
        ("uniform", 20, 37, 500, 32, 7),
        ("uniform", 20, 64, 500, 64, 3),
        ("one", 10, 40, 300, 7, 5),
        ("zipf", 40, 200, 600, 32, 11),
        ("sparse", 200, 20, 300, 64, 16),
        ("uniform", 3, 300, 97, 64, 2),
    ])
    def test_walk_writes_each_query_once_with_the_seq_bytes(
            self, kind, S, E, B, per_item, grid):
        """Every query is written once, with ``bound_dist_seq_ref``'s
        bytes, whatever the item, batch and block sizes; with exact running
        counts every segment takes the prefix sums, and a row's segments
        past its largest φ are never staged."""
        rng = np.random.default_rng(S * E + B)
        w, n, cb = _sorted_profile(rng, S, E)
        sub = _subs(kind, rng, S, B)
        phi = _phis(rng, n, B, scale=1.1 if E <= 64 else 0.3)
        got, writes, steps = _emulate_kernel(w, n, cb, sub, phi, per_item,
                                             grid)
        assert (writes == 1).all()
        want = ref.bound_dist_seq_ref(*_t(w, n, cb, sub, phi))
        assert torch.equal(torch.from_numpy(got), want)
        assert steps["loop"] == 0
        # one staged row per subgraph and batch, at most every segment
        counts = np.bincount(sub, minlength=S)
        item_sub = np.repeat(np.arange(S), -(-counts // per_item))
        staged = len({(i // bd_launcher.BATCH, r)
                      for i, r in enumerate(item_sub)})
        segs = -(-E // bd_launcher.SEGMENT)
        assert steps["prefix"] <= staged * segs
        if segs > 1:
            assert steps["prefix"] < staged * segs

    @pytest.mark.parametrize("kind,seg", [("frac", 64), ("frac", 16),
                                          ("half", 16), ("half", 64),
                                          ("shuffled", 32)])
    def test_prefix_sums_and_loop_give_the_seq_bytes(self, kind, seg):
        """Where the running counts are not exact, the kernel's loop takes
        over, from the first segment that is not exact (a query carries the
        prefix of the exact segments before it); the bytes stay
        ``bound_dist_seq_ref``'s."""
        rng = np.random.default_rng(len(kind) * seg)
        S, E, B = 6, 64, 400
        w, n, cb = _mixed_profile(rng, S, E, kind)
        sub = rng.integers(0, S, B).astype(np.int32)
        phi = _phis(rng, n, B)
        got, writes, steps = _emulate_kernel(w, n, cb, sub, phi, 64, 5, seg)
        assert (writes == 1).all() and steps["loop"] > 0
        if kind == "half" and seg < E:
            assert steps["prefix"] > 0
        want = ref.bound_dist_seq_ref(*_t(w, n, cb, sub, phi))
        assert torch.equal(torch.from_numpy(got), want)
