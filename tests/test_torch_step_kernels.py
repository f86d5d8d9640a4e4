"""The step kernels' staged row read and sparse paths, emulated on the CPU.

On the card, ``bf_relax_step`` and ``ktrop_relax_step`` stream each
adjacency row through shared memory (``csrc/row_stage.cuh``: a head and a
tail by plain loads, the body in bulk-copy chunks), append its finite
entries to an in-edge list as they land, and relax or fold from the list
where the block's inputs allow it: every distance ≥ 0 (no NaN) and, for
BF, every cap ≤ INF.  A block that fails the check, or has a column over
the list's slots, runs the dense scan.  Here the staging plan, the list
build over it and the path choice are emulated with plain tensors and
held to ``kernels.ref`` and ``repro``'s Pallas steps in interpret mode,
bit for bit; the inputs the dense path exists for show that the list
alone would change bytes there."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ops as jax_ops
from repro_torch.kernels import _build, bf_relax, ktrop, ref
from tests.test_torch_edge_list import (bf_inputs, in_edge_lists,
                                        list_ktrop_step, list_relax)
from tests.test_torch_ktrop import _vfrag_slab

INF = ref.INF
POS_INF = float("inf")


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


# ---------------------------------------------------------------------------
# the emulation
# ---------------------------------------------------------------------------
def staged_in_edges(flat, z, slots, addr):
    """The list a block builds from its row (``flat``: z*z f32 at byte
    address ``addr``), range by range as ``row_stage_plan`` stages it,
    with the kernel's walk (``append_column``: each column's next source
    kept between ranges, no division): per column
    v the sources u and weights of its first ``slots`` finite entries,
    and its degree (all finite entries)."""
    plan = _build.row_stage_plan(z, addr)
    n = z * z
    ranges = [(0, plan["head"])] if plan["head"] else []
    ranges += [(f0, f0 + m) for f0, m in plan["chunks"]]
    if plan["tail"]:
        ranges.append((n - plan["tail"], n))
    assert [r[0] for r in ranges[1:]] == [r[1] for r in ranges[:-1]]
    assert (ranges[0][0] if ranges else 0) == 0
    assert (ranges[-1][1] if ranges else n) == n
    eu = [[] for _ in range(z)]
    ew = [[] for _ in range(z)]
    deg = [0] * z
    next_u = [0] * z  # each column's next source, kept between ranges
    for f0, f1 in ranges:
        buf = flat[f0:f1]
        for v in range(z):
            u = next_u[v]
            f = u * z + v
            assert f >= f0  # the ranges before covered everything below
            while f < f1:
                a = buf[f - f0]
                if a < INF:
                    if deg[v] < slots:
                        eu[v].append(u)
                        ew[v].append(a)
                    deg[v] += 1
                f += z
                u += 1
            next_u[v] = u
    return eu, ew, deg


def mask_words(m, jn, z, threads, unroll=8):
    """The kernel's ``mask_words``: a [jn][z] byte tile read as 32-bit
    words (little-endian, as the card reads them), word w by thread
    w % threads, ``unroll`` words a round; bit j of words[v] set for each
    nonzero byte m[j, v]."""
    per_row = z // 4
    w4 = np.ascontiguousarray(m[:jn]).view("<u4").ravel()
    words = [0] * z
    for tid in range(threads):
        for w0 in range(tid, jn * per_row, unroll * threads):
            for t in range(unroll):
                w = w0 + t * threads
                if w >= jn * per_row or w4[w] == 0:
                    continue
                j, v = w // per_row, 4 * (w % per_row)
                for b in range(4):
                    if (int(w4[w]) >> (8 * b)) & 0xFF:
                        words[v + b] |= 1 << j
    return words


def bf_sparse_ok(dist, cap):
    """The BF step kernel's check per block: [S, J] → True where the
    problem's distances are all ≥ 0 (no NaN) and its cap ≤ INF."""
    return (dist >= 0).all(dim=2) & (cap <= INF)


def emulate_bf_step(dist, adj, spur, ban, cap, jt, slots):
    """``bf_relax_step`` as the kernel runs it: per block of jt problems,
    the list relaxation where the check holds and every column fits in
    ``slots``, else the dense scan (the plain step's terms).  Returns
    (out, path [S, ceil(J/jt)])."""
    S, J, z = dist.shape
    fits = (adj < INF).sum(dim=1).amax(dim=1) <= slots if slots else \
        torch.zeros(S, dtype=torch.bool)
    ok = bf_sparse_ok(dist, cap)
    lists = in_edge_lists(adj)
    out = torch.empty_like(dist)
    path = torch.zeros((S, -(-J // jt)), dtype=torch.int32)
    for b, j0 in enumerate(range(0, J, jt)):
        t = slice(j0, min(J, j0 + jt))
        sparse = ok[:, t].all(dim=1) & fits
        path[:, b] = sparse.int()
        args = (dist[:, t], adj, spur[:, t], ban[:, t], cap[:, t])
        out[:, t] = torch.where(sparse[:, None, None], list_relax(
            args[0], lists, *args[2:]), ref.bf_relax_ref(*args))
    return out, path


def emulate_ktrop_step(D, adj, slots):
    """``ktrop_relax_step`` as the kernel runs it: per row, the list fold
    where D[s] ≥ 0 and every column fits, else every u.  (out, path [S])."""
    fits = (adj < INF).sum(dim=1).amax(dim=1) <= slots
    sparse = (D >= 0).flatten(1).all(dim=1) & fits
    out = torch.where(sparse[:, None, None],
                      list_ktrop_step(D, in_edge_lists(adj)),
                      ref.ktrop_relax_ref(D, adj))
    return out, sparse.int()


def _pallas_bf(dist, adj, spur, ban, cap):
    return np.asarray(jax_ops.bf_relax_step(
        jnp.asarray(dist), jnp.asarray(adj), jnp.asarray(spur, jnp.float32),
        jnp.asarray(ban, jnp.float32), jnp.asarray(cap)))


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------
class TestStagingPlan:
    @pytest.mark.parametrize("misalign", [0, 4, 8, 12])
    @pytest.mark.parametrize("z", [1, 33, 96, 200, 256, 1000])
    def test_plan_covers_the_row_in_aligned_chunks(self, z, misalign):
        """Rows 0-2 of a slab whose storage starts ``misalign`` bytes
        past a 16-byte boundary (an offset view): head and tail under 4
        floats by plain loads, every chunk a bulk copy from a 16-byte
        aligned address of a multiple of 16 bytes, at most ROW_CHUNK
        floats, together the whole row in order."""
        n = z * z
        for s in range(3):
            addr = 0x7f0000000000 + misalign + s * n * 4
            plan = _build.row_stage_plan(z, addr)
            head, tail, chunks = plan["head"], plan["tail"], plan["chunks"]
            assert 0 <= head < 4 and 0 <= tail < 4
            assert head == min(n, (-addr % 16) // 4)
            at = head
            for f0, m in chunks:
                assert f0 == at and (addr + 4 * f0) % 16 == 0
                assert 0 < m <= _build.ROW_CHUNK and (4 * m) % 16 == 0
                at += m
            assert at + tail == n
            assert len(chunks) == -(-(n - head - tail) // _build.ROW_CHUNK)

    def test_ring_bytes(self):
        """At least 3 stages of 4 KiB; the area's bytes are those the CUDA
        header sums (barriers and head/tail before the ring)."""
        assert _build.ROW_STAGES >= 3 and _build.ROW_CHUNK % 4 == 0
        assert _build.row_stage_smem(3) == 128 + 3 * 1024 * 4
        assert 8 * _build.ROW_MAX_STAGES + 8 * 4 <= _build.ROW_RING

    @pytest.mark.parametrize("fixed,per_slot,z", [
        (11_264, 2048, 256), (70_792, 0, 256), (40_000, 8000, 1000),
        (0, 8, 1), (120_000, 16_384, 2048)])
    def test_layout_prefers_slots_then_blocks(self, fixed, per_slot, z):
        """The chosen (slots, stages) fits, has at least 3 stages and
        STEP_MIN_SLOTS slots where any layout with them fits, and no
        layout with as many slots (up to STEP_MIN_SLOTS) gives more
        blocks per SM, or as many with more slots or stages."""
        def other(slots):
            return fixed + (8 + 4 * z + per_slot * slots if slots else 0)

        def blocks(smem):
            return _build.SM_SMEM // (smem + _build.SM_SMEM_PER_BLOCK)

        slots, stages, smem = _build.step_layout(other, z)
        assert smem == other(slots) + _build.row_stage_smem(stages)
        assert smem <= _build.SMEM_LIMIT and stages >= _build.ROW_STAGES
        key = (min(slots, _build.STEP_MIN_SLOTS), blocks(smem), slots, stages)
        for sl in range(min(_build.EDGE_SLOTS, z) + 1):
            for st in range(_build.ROW_STAGES, _build.ROW_MAX_STAGES + 1):
                sm = other(sl) + _build.row_stage_smem(st)
                if sm <= _build.SMEM_LIMIT:
                    assert (min(sl, _build.STEP_MIN_SLOTS), blocks(sm), sl,
                            st) <= key

    def test_plan_refuses_an_unaligned_f32_row(self):
        with pytest.raises(ValueError, match="4 bytes"):
            _build.row_stage_plan(8, 2)

    @pytest.mark.parametrize("misalign", [0, 4, 12])
    @pytest.mark.parametrize("z", [1, 33, 96, 200])
    def test_staged_list_equals_the_column_list(self, z, misalign):
        """The list built range by range over the plan (with the kernel's
        first-index and count arithmetic) is each column's finite
        entries in ascending u, as ``in_edge_lists`` has them."""
        rng = np.random.default_rng(z + misalign)
        adj = _vfrag_slab(rng, 1, z, density=0.05)
        adj[0, rng.random((z, z)) < 0.01] = -3.0  # negative: an edge
        eu, ew, deg = staged_in_edges(adj[0].ravel(), z, z, 64 + misalign)
        want_u, want_w, valid = in_edge_lists(_t(adj)[0])
        for v in range(z):
            n = int(valid[0, :, v].sum())
            assert deg[v] == n
            assert eu[v] == want_u[0, :n, v].tolist()
            assert ew[v] == want_w[0, :n, v].tolist()

    def test_staged_list_counts_past_its_slots(self):
        """A column with more finite entries than slots keeps the first
        ``slots`` and counts them all: the block then runs dense."""
        z = 40
        adj = np.full((z, z), INF, np.float32)
        adj[:, 7] = 1.0
        eu, _, deg = staged_in_edges(adj.ravel(), z, 16, 4)
        assert deg[7] == z and eu[7] == list(range(16))
        assert deg[0] == 0


class TestMaskWords:
    @pytest.mark.parametrize("jn,z,threads", [(32, 256, 256), (8, 96, 96),
                                               (5, 1000, 256), (1, 4, 32)])
    def test_words_equal_the_bytes(self, jn, z, threads):
        """Where z % 4 == 0 the BF step reads its spur and ban masks as
        32-bit words across the block; the words it packs are those of
        one byte per (j, v), for sparse and dense masks."""
        rng = np.random.default_rng(jn * z)
        for p in (0.02, 0.5):
            m = (rng.random((jn, z)) < p).astype(np.uint8)
            m[m > 0] = rng.integers(1, 256, int(m.sum()))  # any nonzero byte
            want = [sum(1 << j for j in range(jn) if m[j, v]) for v in
                    range(z)]
            assert mask_words(m, jn, z, threads) == want


class TestBellmanFordStep:
    @pytest.mark.parametrize("cap_inf", [False, True])
    @pytest.mark.parametrize("density", [0.02, 0.3])
    @pytest.mark.parametrize("S,J,z", [(2, 3, 24), (2, 8, 96), (1, 5, 128)])
    def test_list_step_matches_reference_and_pallas(self, S, J, z, density,
                                                    cap_inf):
        """Where the check holds, one relaxation over the list == the
        plain step == repro's Pallas bf_relax (interpret), bitwise."""
        adj, dist, _, spur, ban, cap = bf_inputs(z + J, S, J, z, density,
                                                 cap_inf, one_hot=False)
        td, ta, ts, tb, tc = _t(dist, adj, spur, ban, cap)
        assert bool(bf_sparse_ok(td, tc).all())
        got = list_relax(td, in_edge_lists(ta), ts, tb, tc)
        want = ref.bf_relax_ref(td, ta, ts, tb, tc)
        assert torch.equal(got, want)
        np.testing.assert_array_equal(got.numpy(),
                                      _pallas_bf(dist, adj, spur, ban, cap))

    @pytest.mark.parametrize("J,z", [(33, 40), (40, 33), (5, 97)])
    def test_kernel_emulation_at_ragged_shapes(self, J, z):
        """The whole step, as the launcher tiles J (33 and 40 leave a
        partial tile) and sizes the list, == the plain step; rows at 30%
        overflow the slots and run dense, rows at 2% run the list."""
        jt = bf_relax.tile_width(J, z, bf_relax.step_smem)
        slots = bf_relax.step_layout(jt, z)[0]
        for density in (0.02, 0.3):
            adj, dist, _, spur, ban, cap = bf_inputs(J * z, 2, J, z, density,
                                                     False)
            args = _t(dist, adj, spur, ban, cap)
            got, path = emulate_bf_step(*args, jt, slots)
            assert torch.equal(got, ref.bf_relax_ref(*args))
            col = int((args[1] < INF).sum(dim=1).max())
            assert bool(path.all()) == (col <= slots)

    def _one_edge(self):
        """v=1 has one finite in-edge (0 -> 1, weight 5); v=2 none."""
        z = 3
        adj = np.full((1, z, z), INF, np.float32)
        adj[0, 0, 1] = 5.0
        dist = np.array([[[0.0, INF, INF]]], np.float32)
        no = np.zeros((1, 1, z), bool)
        return adj, dist, no, np.full((1, 1), INF, np.float32)

    def test_negative_distance_needs_the_dense_path(self):
        """d[u] = -1e37 makes d[u] + INF = 2.9e38 < INF a winning term at
        a non-edge: the list alone misses it, the kernel's check sends
        the block dense."""
        adj, dist, no, cap = self._one_edge()
        dist[0, 0, 0] = -1e37
        args = _t(dist, adj, no, no, cap)
        want = ref.bf_relax_ref(*args)
        assert float(want[0, 0, 2]) < INF
        assert not torch.equal(list_relax(args[0], in_edge_lists(args[1]),
                                          *args[2:]), want)
        got, path = emulate_bf_step(*args, 1, 4)
        assert torch.equal(got, want) and path.tolist() == [[0]]
        np.testing.assert_array_equal(want.numpy(),
                                      _pallas_bf(dist, adj, no, no, cap))

    def test_infinite_cap_needs_the_dense_path(self):
        """With cap = +inf nothing clamps: at v=2 (distance +inf, no
        in-edge) the dense scan gives 0 + INF = INF, the list keeps +inf."""
        adj, dist, no, cap = self._one_edge()
        dist[0, 0, 2] = POS_INF
        cap[:] = POS_INF
        args = _t(dist, adj, no, no, cap)
        want = ref.bf_relax_ref(*args)
        assert float(want[0, 0, 2]) == INF
        assert not torch.equal(list_relax(args[0], in_edge_lists(args[1]),
                                          *args[2:]), want)
        got, path = emulate_bf_step(*args, 1, 4)
        assert torch.equal(got, want) and path.tolist() == [[0]]
        cap[:] = INF  # with cap <= INF the same input may take the list
        args = _t(dist, adj, no, no, cap)
        got, path = emulate_bf_step(*args, 1, 4)
        assert path.tolist() == [[1]]
        assert torch.equal(got, ref.bf_relax_ref(*args))

    def test_negative_adj_needs_no_dense_path(self):
        """A negative entry is finite, so it stays in the list: skipping
        reads adj only where it is >= INF.  The list step == the plain
        step == Pallas on a row with negative weights."""
        adj, dist, _, spur, ban, cap = bf_inputs(5, 2, 4, 48, 0.05, False,
                                                 one_hot=False)
        rng = np.random.default_rng(5)
        adj[(adj < INF) & (rng.random(adj.shape) < 0.5)] *= -1.0
        args = _t(dist, adj, spur, ban, cap)
        got, path = emulate_bf_step(*args, 4, 16)
        assert bool(path.all())
        assert torch.equal(got, ref.bf_relax_ref(*args))
        np.testing.assert_array_equal(got.numpy(),
                                      _pallas_bf(dist, adj, spur, ban, cap))

    def test_nan_cap_takes_the_dense_path(self):
        """A NaN cap fails cap <= INF, so the block runs dense, whose
        clamp (nw > NaN is false) matches the plain step."""
        adj, dist, _, spur, ban, cap = bf_inputs(6, 1, 3, 32, 0.05, False,
                                                 one_hot=False)
        cap[0, 1] = np.nan
        args = _t(dist, adj, spur, ban, cap)
        got, path = emulate_bf_step(*args, 4, 16)
        assert path.tolist() == [[0]]
        assert torch.equal(got, ref.bf_relax_ref(*args))


class TestKtropStep:
    @pytest.mark.parametrize("k", [1, 4, 10])
    @pytest.mark.parametrize("density", [0.02, 0.3])
    def test_list_step_matches_reference_and_pallas(self, density, k):
        """From mid-relaxation states (D >= 0, ascending), the fold over
        the list == the plain step == repro's Pallas ktrop_relax
        (interpret; it takes z % 128 == 0), bitwise, three steps on."""
        rng = np.random.default_rng(k + int(100 * density))
        z = 128
        adj = _vfrag_slab(rng, 2, z, density=density)
        src = rng.integers(z, size=2).astype(np.int32)
        D = ref.ktrop_solve_ref(*_t(adj, src), k, 2)[0]
        lists = in_edge_lists(_t(adj)[0])
        for _ in range(3):
            assert bool((D >= 0).all())
            got = list_ktrop_step(D, lists)
            want = ref.ktrop_relax_ref(D, _t(adj)[0])
            assert torch.equal(got, want)
            pallas = np.asarray(jax_ops.ktrop_relax_step(
                jnp.asarray(D.numpy()), jnp.asarray(adj)))
            np.testing.assert_array_equal(got.numpy(), pallas)
            D = want

    @pytest.mark.parametrize("z", [1, 33, 97])
    def test_kernel_emulation_at_ragged_z(self, z):
        """The whole step with the launcher's slots == the plain step at
        z % 4 != 0; dense rows overflow the slots."""
        rng = np.random.default_rng(z)
        for density in (0.02, 0.6):
            adj = _t(_vfrag_slab(rng, 3, z, density=density))[0]
            src = torch.from_numpy(rng.integers(z, size=3).astype(np.int32))
            D = ref.ktrop_solve_ref(adj, src, 10, 2)[0]
            got, path = emulate_ktrop_step(D, adj, ktrop.step_layout(10, z)[0])
            assert torch.equal(got, ref.ktrop_relax_ref(D, adj))
            if z > 1 and density > 0.5:
                assert not bool(path.any())

    def test_negative_level_needs_the_dense_path(self):
        """D[0, u] = -1e37 makes -1e37 + INF = 2.9e38 a level below INF
        at a non-edge: the list misses it, the check sends the row dense."""
        z, k = 3, 2
        adj = np.full((1, z, z), INF, np.float32)
        np.fill_diagonal(adj[0], 0.0)
        D = np.full((1, k, z), INF, np.float32)
        D[0, 0, 0] = -1e37
        D_t, adj_t = _t(D, adj)
        want = ref.ktrop_relax_ref(D_t, adj_t)
        assert float(want[0, 0, 1]) < INF
        assert not torch.equal(list_ktrop_step(D_t, in_edge_lists(adj_t)),
                               want)
        got, path = emulate_ktrop_step(D_t, adj_t, 4)
        assert torch.equal(got, want) and path.tolist() == [0]

    def test_negative_adj_needs_no_dense_path(self):
        """A negative weight is an edge: kept in the list, bitwise the
        plain step on an ascending D >= 0."""
        rng = np.random.default_rng(3)
        adj = _vfrag_slab(rng, 2, 40, density=0.05)
        adj[(adj < INF) & (adj > 0) & (rng.random(adj.shape) < 0.3)] = -2.0
        D = np.sort(rng.integers(0, 30, (2, 4, 40)).astype(np.float32),
                    axis=1)
        D_t, adj_t = _t(D, adj)
        got, path = emulate_ktrop_step(D_t, adj_t, 16)
        assert bool(path.all())
        assert torch.equal(got, ref.ktrop_relax_ref(D_t, adj_t))


class TestLaunchers:
    def test_main_shapes_layouts(self):
        """The refine_dense step block (J=32, z=256) takes 12 slots and 3
        stages for three blocks per SM; the levels step block (k=10) 10
        slots and 3 stages for five; both keep at least 32 KiB of the row
        in flight per SM."""
        def blocks(smem):
            return _build.SM_SMEM // (smem + _build.SM_SMEM_PER_BLOCK)

        jt = bf_relax.tile_width(32, 256, bf_relax.step_smem)
        slots, stages, smem = bf_relax.step_layout(jt, 256)
        assert (jt, slots, stages, blocks(smem)) == (32, 12, 3, 3)
        assert blocks(smem) * stages * _build.ROW_CHUNK * 4 >= 32 * 1024
        slots, stages, smem = ktrop.step_layout(10, 256)
        assert (slots, stages, blocks(smem)) == (10, 3, 5)
        assert blocks(smem) * stages * _build.ROW_CHUNK * 4 >= 32 * 1024

    @pytest.mark.parametrize("J,z", [(1, 1), (33, 97), (5, 1000), (8, 2048)])
    def test_step_shared_memory_fits(self, J, z):
        jt = bf_relax.tile_width(J, z, bf_relax.step_smem)
        assert bf_relax.step_smem(jt, z) <= _build.SMEM_LIMIT
        assert bf_relax.step_smem(jt, z) >= _build.row_stage_smem(3)

    def test_step_size_limits(self):
        assert ktrop.step_smem(16, 1000) <= _build.SMEM_LIMIT
        with pytest.raises(ValueError, match=r"2\^31"):
            bf_relax.relax_step(torch.zeros(1, 1, 46_341), *(None,) * 4)
        with pytest.raises(ValueError, match="shared memory"):
            ktrop.relax_step(torch.zeros(1, 16, 4096), torch.zeros(1, 1, 1))
