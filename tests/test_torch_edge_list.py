"""The fused solves' in-edge list, emulated with plain tensors.

On the card, ``bf_solve_grouped`` and ``ktrop_solve`` read each adjacency
row once and relax only its finite entries (adj < INF), from a list of
every vertex's in-edges in ascending source order (``csrc/in_edges.cuh``).
Here that list is built from the same adjacency and the relaxations are
run over it with plain tensors: terms of skipped entries simply do not
exist (the emulation pads with +inf).  The results must equal the dense
plain versions (``kernels.ref``) and ``repro``'s solvers bit for bit,
values, parents and per-row iteration counts alike.  A tie between two
in-edges pins the order rule the kernel follows."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.engine import dense as jax_dense
from repro.engine.backend import _pallas_grouped_solver
from repro.engine.yen_engine import grouped_solver as jax_grouped_solver
from repro_torch.engine.dense import _REL_TOL
from repro_torch.kernels import ref
from tests.test_kernels import rand_slab
from tests.test_torch_ktrop import _vfrag_slab

INF = ref.INF
POS_INF = float("inf")


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


# ---------------------------------------------------------------------------
# the emulation
# ---------------------------------------------------------------------------
def in_edge_lists(adj, descending=False):
    """Each vertex's finite in-edges as [S,P,z] sources, weights and a
    validity mask: slot p of column v holds the p-th u (ascending, or
    descending if asked) with adj[s,u,v] < INF; empty slots have u = 0,
    w = +inf."""
    S, z, _ = adj.shape
    u = torch.arange(z).view(1, z, 1).expand(S, z, z)
    valid_u = adj < INF
    key = torch.where(valid_u, z - 1 - u if descending else u, z)
    key = key.sort(dim=1).values
    P = max(int(valid_u.sum(dim=1).max()), 1)
    key = key[:, :P]
    valid = key < z
    eu = torch.where(valid, z - 1 - key if descending else key, 0)
    ew = torch.where(valid, adj.gather(1, eu), POS_INF)
    return eu, ew, valid


def _at_sources(x, eu):
    """x [S,J,z] gathered at the list's sources → [S,J,P,z]."""
    S, J, z = x.shape
    P = eu.shape[1]
    idx = eu.reshape(S, 1, P * z).expand(S, J, P * z)
    return x.gather(2, idx).view(S, J, P, z)


def list_relax(dist, lists, spur, ban, cap):
    """:func:`ref.bf_relax_ref` over the in-edge list only."""
    eu, ew, valid = lists
    c = _at_sources(dist, eu) + ew[:, None]
    c = torch.where(_at_sources(spur, eu) & ban[:, :, None, :], INF, c)
    c = torch.where(valid[:, None], c, POS_INF)
    new = torch.minimum(dist, c.amin(dim=2).clamp(max=INF))  # starts at INF
    return torch.where(new > cap[:, :, None], INF, new)


def list_parents(adj, dist, lists, spur, ban):
    """``bf_parents_grouped`` with the argmin taken over the list in its
    order (the first slot of the min wins, as the kernel's strict <)."""
    eu, ew, valid = lists
    S, J, z = dist.shape
    v = torch.arange(z).view(1, 1, z)
    w = torch.where(eu == v, INF, ew)  # the diagonal is no hop
    d_no_spur = torch.where(spur, INF, dist)
    c = _at_sources(d_no_spur, eu) + w[:, None]
    c = torch.where(valid[:, None], c, POS_INF)
    slot = c.argmin(dim=2, keepdim=True)
    best_val = c.amin(dim=2)
    best_u = eu[:, None].expand(S, J, -1, z).gather(2, slot)[:, :, 0]
    # the spur candidate reads its one adjacency entry, as in the kernel
    eye = torch.eye(z, dtype=torch.bool)
    adj_nd = torch.where(eye, INF, adj)
    d_spur = torch.where(spur, dist, INF).amin(dim=2)
    spur_idx = spur.to(torch.uint8).argmax(dim=2)
    spur_row = adj_nd.gather(1, spur_idx[:, :, None].expand(-1, -1, z))
    spur_part = torch.where(ban, INF, d_spur[:, :, None] + spur_row)
    spur_part = torch.where(spur.any(dim=2, keepdim=True), spur_part, INF)
    best_u = torch.where(spur_part < best_val, spur_idx[:, :, None], best_u)
    best_val = torch.minimum(best_val, spur_part)
    ok = (best_val - dist).abs() <= _REL_TOL * torch.clamp(dist.abs(), min=1.0)
    keep = ok & (dist < INF / 2) & ~(dist <= 0.0)
    return torch.where(keep, best_u, -1).to(torch.int32)


def list_bf_solve(adj, init, banned_v, spur, ban, cap, descending=False):
    """The fused BF solve over the list: (dist, parents, iters per row)."""
    lists = in_edge_lists(adj, descending)
    S, _, z = init.shape
    dist = torch.where(banned_v, INF, init)
    iters = torch.zeros(S, dtype=torch.int32)
    active = torch.ones(S, dtype=torch.bool)
    for _ in range(z):
        new = list_relax(dist, lists, spur, ban, cap)
        new = torch.where(banned_v, INF, new)
        iters += active
        active &= (new < dist).flatten(1).any(dim=1)
        dist = new
    return dist, list_parents(adj, dist, lists, spur, ban), iters


def list_ktrop_step(D, lists):
    """``ktrop_step(distinct=True)`` with candidates from the list only."""
    eu, ew, valid = lists
    S, k, z = D.shape
    cand = torch.where(valid[:, None], _at_sources(D, eu) + ew[:, None],
                       POS_INF)
    cand = cand.permute(0, 3, 1, 2).reshape(S, z, -1)
    allv = torch.cat([D.transpose(1, 2), cand], dim=-1).sort(dim=-1).values
    dup = torch.zeros_like(allv, dtype=torch.bool)
    dup[..., 1:] = allv[..., 1:] == allv[..., :-1]
    allv = torch.where(dup, INF, allv).sort(dim=-1).values
    return allv[..., :k].transpose(1, 2).contiguous()


def list_ktrop_solve(adj, src, k, max_iters=None):
    """The fused ktrop solve over the list: (D, iters per row)."""
    lists = in_edge_lists(adj)
    S, z, _ = adj.shape
    D = torch.full((S, k, z), INF)
    D[torch.arange(S), 0, src.long()] = 0.0
    iters = torch.zeros(S, dtype=torch.int32)
    active = torch.ones(S, dtype=torch.bool)
    for _ in range(z * k + 8 if max_iters is None else max_iters):
        new = list_ktrop_step(D, lists)
        iters += active
        active &= (new < D).flatten(1).any(dim=1)
        D = new
        if not bool(active.any()):
            break
    return D, iters


def list_ok(adj):
    """Per slab row: every kept weight (adj < INF) is ≥ 0, the check the
    fused solves make as they build the list (a NaN is not kept)."""
    return ~((adj < INF) & (adj < 0)).flatten(1).any(dim=1)


def checked_bf_solve(adj, init, banned_v, spur, ban, cap):
    """The fused BF solve as the kernel runs it (one block per slab row,
    as at every J ≤ 32 here): from the list where the row's kept weights,
    initial distances (after the banned-vertex mask) and caps pass the
    checks (≥ 0, ≥ 0, ≤ INF; a NaN fails), else the dense loop.  Returns
    (dist, parents, iters per row, list per row)."""
    d0 = torch.where(banned_v, INF, init)
    use = (list_ok(adj) & (d0 >= 0).flatten(1).all(dim=1)
           & (cap <= INF).all(dim=1))
    ld, lp, lit = list_bf_solve(adj, init, banned_v, spur, ban, cap)
    dd, dp, dit = ref.bf_solve_grouped_ref(adj, init, banned_v, spur, ban,
                                           cap, with_iters=True)
    row = use.view(-1, 1, 1)
    return (torch.where(row, ld, dd), torch.where(row, lp, dp),
            torch.where(use, lit, dit), use)


def checked_ktrop_solve(adj, src, k, max_iters=None):
    """The fused ktrop solve as the kernel runs it: from the list where
    the row's kept weights are all ≥ 0, else the dense loop.  Returns
    (D, iters per row, list per row)."""
    use = list_ok(adj)
    lD, lit = list_ktrop_solve(adj, src, k, max_iters)
    dD, dit = ref.ktrop_solve_ref(adj, src, k, max_iters)
    return (torch.where(use.view(-1, 1, 1), lD, dD),
            torch.where(use, lit, dit), use)


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------
def bf_inputs(seed, S, J, z, density, cap_inf, one_hot=True):
    """``rand_slab`` adjacency and distances at ``density``, Yen-style
    (one-hot, some problems spur-less) or general spur masks, banned
    vertices and next hops, finite caps or INF, and an all-INF padding
    problem."""
    rng = np.random.default_rng(seed)
    adj, init = rand_slab(rng, S, J, z, density=density)
    if one_hot:
        so = np.zeros((S, J, z), bool)
        hit = rng.random((S, J)) < 0.7
        np.put_along_axis(so, rng.integers(z, size=(S, J, 1)), hit[..., None],
                          axis=2)
    else:
        so = rng.random((S, J, z)) < 0.05
    bv = (rng.random((S, J, z)) < 0.05) & ~so
    bn = rng.random((S, J, z)) < 0.1
    cap = (np.full((S, J), INF, np.float32) if cap_inf
           else rng.uniform(20.0, 90.0, (S, J)).astype(np.float32))
    init[:, J - 1, :] = INF  # a padding problem must no-op
    so[:, J - 1, :] = False
    return adj, init, bv, so, bn, cap


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------
class TestBellmanFord:
    @pytest.mark.parametrize("one_hot", [True, False])
    @pytest.mark.parametrize("cap_inf", [False, True])
    @pytest.mark.parametrize("density", [0.02, 0.3])
    @pytest.mark.parametrize("S,J,z", [(2, 3, 24), (3, 5, 61), (2, 8, 96)])
    def test_list_solve_is_bitwise(self, S, J, z, density, cap_inf, one_hot):
        """The list solve == the dense plain solve (dist, parents, per-row
        iterations), bitwise; with Yen-style one-hot spurs (the grouped
        solver's contract) also == repro's jnp grouped solver."""
        args = bf_inputs(z * 10 + J, S, J, z, density, cap_inf, one_hot)
        targs = _t(*args)
        d, p, it = list_bf_solve(*targs)
        wd, wp, wit = ref.bf_solve_grouped_ref(*targs, with_iters=True)
        assert torch.equal(d, wd) and torch.equal(p, wp)
        assert torch.equal(it, wit)
        if not one_hot:
            return
        jd, jp = jax_grouped_solver(S, J, z)(*(jnp.asarray(a) for a in args))
        np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
        np.testing.assert_array_equal(p.numpy(), np.asarray(jp))

    @pytest.mark.parametrize("cap_inf", [False, True])
    @pytest.mark.parametrize("density", [0.02, 0.3])
    def test_list_solve_matches_pallas(self, density, cap_inf):
        """... and == repro's Pallas fixed point in interpret mode."""
        S, J, z = 2, 4, 40
        args = bf_inputs(7, S, J, z, density, cap_inf)
        d, p, _ = list_bf_solve(*_t(*args))
        pd, pp = _pallas_grouped_solver(S, J, z, True)(
            *(jnp.asarray(a) for a in args))
        np.testing.assert_array_equal(d.numpy(), np.asarray(pd))
        np.testing.assert_array_equal(p.numpy(), np.asarray(pp))

    def test_road_rows_sit_far_below_the_budget(self):
        """A 16x16 road grid row (the refine_dense shape) has at most 5
        in-edges per vertex, the diagonal included: far below the
        kernel's 16 slots, 1,216 entries of 65,536."""
        side = 16
        z = side * side
        adj = np.full((1, z, z), INF, np.float32)
        np.fill_diagonal(adj[0], 0.0)
        for v in range(z):
            r, c = divmod(v, side)
            for rr, cc in ((r, c + 1), (r + 1, c)):
                if rr < side and cc < side:
                    adj[0, v, rr * side + cc] = adj[0, rr * side + cc, v] = 1.0
        eu, _, valid = in_edge_lists(_t(adj)[0])
        assert eu.shape[1] == 5 and int(valid.sum()) == 1216

    def test_tie_needs_ascending_order(self):
        """Two in-edges of v=3 tie (0→1→3 and 0→2→3, both 3): the dense
        argmin keeps u=1, the list in ascending u keeps u=1 too, and a
        list walked in descending u would keep u=2."""
        z = 4
        adj = np.full((1, z, z), INF, np.float32)
        np.fill_diagonal(adj[0], 0.0)
        adj[0, 0, 1], adj[0, 0, 2], adj[0, 1, 3], adj[0, 2, 3] = 1, 1, 2, 2
        init = np.full((1, 1, z), INF, np.float32)
        init[0, 0, 0] = 0.0
        no = np.zeros((1, 1, z), bool)
        cap = np.full((1, 1), INF, np.float32)
        args = _t(adj, init, no, no, no, cap)
        _, want_p = ref.bf_solve_grouped_ref(*args)
        _, p, _ = list_bf_solve(*args)
        _, p_desc, _ = list_bf_solve(*args, descending=True)
        assert want_p[0, 0].tolist() == [-1, 0, 0, 1]
        assert torch.equal(p, want_p)
        assert p_desc[0, 0, 3] == 2


class TestKtrop:
    @pytest.mark.parametrize("k", [1, 10, 16])
    @pytest.mark.parametrize("density", [0.02, 0.3])
    @pytest.mark.parametrize("z", [1, 33, 96])
    def test_list_solve_is_bitwise(self, z, density, k):
        """The list solve == the dense plain solve (D and per-row
        iterations) == repro's ktrop_solve, bitwise, to the fixed point."""
        rng = np.random.default_rng(100 * z + k)
        adj = _vfrag_slab(rng, 3, z, density=density)
        src = rng.integers(z, size=3).astype(np.int32)
        targs = _t(adj, src)
        D, it = list_ktrop_solve(*targs, k)
        wD, wit = ref.ktrop_solve_ref(*targs, k)
        assert torch.equal(D, wD) and torch.equal(it, wit)
        want = np.asarray(jax_dense.ktrop_solve(jnp.asarray(adj),
                                                jnp.asarray(src), k))
        np.testing.assert_array_equal(D.numpy(), want)

    @pytest.mark.parametrize("k", [1, 10])
    def test_list_solve_with_binding_cap(self, k):
        """Capped at 3 relaxations, mid-way to the fixed point."""
        rng = np.random.default_rng(k)
        adj = _vfrag_slab(rng, 2, 48, density=0.05)
        src = rng.integers(48, size=2).astype(np.int32)
        D, it = list_ktrop_solve(*_t(adj, src), k, max_iters=3)
        wD, wit = ref.ktrop_solve_ref(*_t(adj, src), k, 3)
        assert torch.equal(D, wD) and torch.equal(it, wit)
        want = np.asarray(jax_dense.ktrop_solve(
            jnp.asarray(adj), jnp.asarray(src), k, max_iters=3))
        np.testing.assert_array_equal(D.numpy(), want)


# ---------------------------------------------------------------------------
# inputs the fused solves must check before taking the list
# ---------------------------------------------------------------------------
def _bf_precondition_case(case):
    """``bf_inputs(7, 2, 3, 24, 0.02, True)`` with one precondition of the
    list broken: every INF initial distance +inf under caps of +inf; one
    initial distance of -1e37 (row 1); one edge weight of -1e37 out of a
    source (row 1).  Returns (inputs, the rows the kernel may run from
    its list, whether the list alone keeps the bytes)."""
    adj, init, bv, so, bn, cap = bf_inputs(7, 2, 3, 24, 0.02, True)
    if case == "+inf distances, cap +inf":
        init[init >= INF] = POS_INF
        cap[:] = POS_INF
        # the caps fail the check; with the accumulators starting at INF
        # (the Pallas kernel's) a skipped term cannot win even so
        return (adj, init, bv, so, bn, cap), [False, False], True
    if case == "-1e37 distance":
        init[1, 0, 1] = -1e37
        bv[1, 0, 1] = False
    else:  # a negative weight takes distances below 0 mid-solve
        src = int(np.argmax(init[1, 0] == 0.0))
        adj[1, src, (src + 1) % 24] = -1e37
    return (adj, init, bv, so, bn, cap), [True, False], False


class TestPreconditions:
    @pytest.mark.parametrize("case", ["+inf distances, cap +inf",
                                      "-1e37 distance", "-1e37 weight"])
    def test_bf_solve_checks_its_inputs(self, case):
        """Where a block's caps exceed INF, an initial distance is < 0 or
        a kept weight is < 0, the fused BF solve runs its dense loop: the
        checked solve gives repro's bytes (jnp and Pallas fixed points,
        dist and parents) and the plain version's iterations, where the
        list alone may not."""
        args, rows, list_alone_exact = _bf_precondition_case(case)
        targs = _t(*args)
        d, p, it, use = checked_bf_solve(*targs)
        assert use.tolist() == rows
        wd, wp, wit = ref.bf_solve_grouped_ref(*targs, with_iters=True)
        assert torch.equal(d, wd) and torch.equal(p, wp)
        assert torch.equal(it, wit)
        S, J, z = args[1].shape
        jargs = [jnp.asarray(a) for a in args]
        for jd, jp in (jax_grouped_solver(S, J, z)(*jargs),
                       _pallas_grouped_solver(S, J, z, True)(*jargs)):
            np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
            np.testing.assert_array_equal(p.numpy(), np.asarray(jp))
        ld, _, _ = list_bf_solve(*targs)
        assert np.array_equal(ld.numpy(), np.asarray(jd)) == list_alone_exact

    def test_ktrop_solve_checks_its_weights(self):
        """A row with a kept weight of -1e37 out of its source runs the
        dense loop: the checked solve gives repro's D and the plain
        version's iterations (k=4, 30 iterations), the list alone not."""
        rng = np.random.default_rng(4)
        adj = _vfrag_slab(rng, 3, 33, density=0.05)
        src = rng.integers(33, size=3).astype(np.int32)
        adj[0, src[0], (src[0] + 1) % 33] = -1e37
        targs = _t(adj, src)
        D, it, use = checked_ktrop_solve(*targs, 4, 30)
        assert use.tolist() == [False, True, True]
        wD, wit = ref.ktrop_solve_ref(*targs, 4, 30)
        assert torch.equal(D, wD) and torch.equal(it, wit)
        want = np.asarray(jax_dense.ktrop_solve(
            jnp.asarray(adj), jnp.asarray(src), 4, max_iters=30))
        np.testing.assert_array_equal(D.numpy(), want)
        lD, _ = list_ktrop_solve(*targs, 4, 30)
        assert not np.array_equal(lD.numpy(), want)
