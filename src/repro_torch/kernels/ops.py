"""Public wrappers around the Hopper kernels, with launch counters.

On a CUDA tensor a wrapper launches its kernel (``kernels/bf_relax.py``,
``kernels/ktrop.py``, ``kernels/bound_dist.py``) or raises; on a CPU
tensor it runs the kernel's plain PyTorch version (``kernels/ref.py``),
only because the tensor lies on the CPU.  There is no fallback from one
to the other.

``LAUNCHES`` counts kernel launches per wrapper, so a run can show that
its main path went through the kernels (``reset_launches`` zeroes it).
"""

from __future__ import annotations

import torch

from . import bf_relax, bound_dist as _bound_dist, ktrop, ref

INF = ref.INF

#: queries per block of the TPU kernel's blocked ``bound_dist`` contract
BOUND_DIST_BLOCK = 256

LAUNCHES = {"bf_relax_step": 0, "bf_solve_grouped": 0,
            "ktrop_relax_step": 0, "ktrop_solve": 0, "bound_dist": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _on_cpu(t: torch.Tensor) -> bool:
    return t.device.type == "cpu"


def bf_relax_step(dist, adj, spur_onehot, banned_next, cap=None):
    """One fused masked BF relaxation (the Pallas ``bf_relax`` contract):
    dist [S,J,z], adj [S,z,z], spur_onehot/banned_next [S,J,z] 0/1 masks
    (any dtype; nonzero = set), cap [S,J] (default INF) → [S,J,z] f32."""
    S, J, _ = dist.shape
    if cap is None:
        cap = torch.full((S, J), INF, dtype=torch.float32, device=dist.device)
    args = (dist.float().contiguous(), adj.float().contiguous(),
            spur_onehot.bool().contiguous(), banned_next.bool().contiguous(),
            cap.float().contiguous())
    if _on_cpu(dist):
        return ref.bf_relax_ref(*args)
    out = bf_relax.relax_step(*args)
    LAUNCHES["bf_relax_step"] += 1
    return out


def bf_solve_grouped(adj, init, banned_v, spur_onehot, banned_next, cap,
                     max_iters: int | None = None, with_iters: bool = False):
    """Converged masked grouped Bellman–Ford plus parents: (dist [S,J,z]
    f32, parents [S,J,z] int32), the ``SolverBackend.solve_grouped``
    contract, in one kernel launch on the card.  At most ``max_iters``
    (default z) relaxations; ``with_iters`` adds iters [S] int32, the
    relaxations each slab row ran (their maximum is the reference's
    global count).

    The kernel relaxes only each row's finite entries (adj < INF), from
    a list in shared memory.  That gives the plain version's bytes for
    adj ≥ 0, init ≥ 0 and cap ≤ INF, which every caller meets (serving
    caps are ``cand − pre + 1e-9`` or INF): a skipped term is ≥ INF, so
    it can change a minimum only where the minimum already exceeds INF,
    and there the cap clamp sends both to INF; in the parent epilogue it
    can never be the argmin of a reached vertex (``csrc/in_edges.cuh``)."""
    args = (adj.float().contiguous(), init.float().contiguous(),
            banned_v.bool().contiguous(), spur_onehot.bool().contiguous(),
            banned_next.bool().contiguous(), cap.float().contiguous())
    if _on_cpu(init):
        return ref.bf_solve_grouped_ref(*args, max_iters=max_iters,
                                        with_iters=with_iters)
    dist, parent, iters, _ = bf_relax.solve_grouped(*args,
                                                    max_iters=max_iters)
    LAUNCHES["bf_solve_grouped"] += 1
    if with_iters:  # a row's count is the largest of its blocks'
        return dist, parent, iters.amax(dim=1)
    return dist, parent


def ktrop_relax_step(D, adj):
    """One k-distinct tropical relaxation (the Pallas ``ktrop_relax``
    contract at any z): D [S,k,z] ascending along k, adj [S,z,z] → new D
    [S,k,z] f32.  k ≤ 16 on the card."""
    args = (D.float().contiguous(), adj.float().contiguous())
    if _on_cpu(D):
        return ref.ktrop_relax_ref(*args)
    out = ktrop.relax_step(*args)
    LAUNCHES["ktrop_relax_step"] += 1
    return out


def ktrop_solve(adj, src, k: int, max_iters: int | None = None,
                with_iters: bool = False):
    """k distinct smallest walk distances from ``src`` to every vertex,
    ``engine.dense.ktrop_solve``'s contract in one kernel launch on the
    card: adj [S,z,z], src int [S] → D [S,k,z] f32 ascending (INF
    padded), after at most ``max_iters`` (default z·k+8) relaxations.
    ``with_iters`` returns (D, iters [S] int32), the relaxations each
    row ran.

    The kernel folds only each row's finite entries (adj < INF), from a
    list in shared memory: for adj ≥ 0 a skipped entry's candidates are
    ≥ INF and are never among the k smallest distinct values below INF,
    so the result is the plain version's, bit for bit."""
    adj = adj.float().contiguous()
    src = src.to(torch.int32).contiguous()
    if _on_cpu(adj):
        D, iters = ref.ktrop_solve_ref(adj, src, k, max_iters)
    else:
        D, iters, _ = ktrop.solve(adj, src, k, max_iters)
        LAUNCHES["ktrop_solve"] += 1
    return (D, iters) if with_iters else D


def bound_dist(w_sorted, n_sorted, cum_before, sub, phi):
    """Bound distances of B queries, each on its own subgraph's
    ascending profile: w_sorted/n_sorted/cum_before [S,E], sub [B] int
    (any order), phi [B] → BD [B] f32 (``ref.bound_dist_ref``'s
    signature).

    On the card the queries are grouped by subgraph first; each sum is
    the one taken in ascending e, one rounding per step, stopping at the
    first e with cum_before[e] ≥ φ: ``ref.bound_dist_seq_ref``, bit for
    bit, whatever the grouping.  That stop drops only terms w·(+0) = +0,
    so it gives the full clip-sum's sequential bytes, for w ≥ 0, n ≥ 0
    and cum_before the exclusive running count of n (non-decreasing),
    which every caller meets (the ``maintain`` step builds it as
    cum_n − n).  φ and cum_before hold no NaN."""
    args = (w_sorted.float().contiguous(), n_sorted.float().contiguous(),
            cum_before.float().contiguous(), sub.to(torch.int32).contiguous(),
            phi.float().contiguous())
    if _on_cpu(phi):
        return ref.bound_dist_ref(*args)
    out = _bound_dist.bound_dist(*args)
    LAUNCHES["bound_dist"] += 1
    return out


def bound_dist_blocked(w_sorted, n_sorted, cum_before, sub_blocked, phi):
    """The TPU kernel's blocked signature: sub_blocked [ceil(B/256)] is
    the subgraph of each block of 256 consecutive queries.  Expands it
    to one index per query and runs :func:`bound_dist` (which groups
    them again on the card)."""
    B = phi.shape[0]
    n_blocks = -(-B // BOUND_DIST_BLOCK)
    if sub_blocked.shape != (n_blocks,):
        raise ValueError(f"sub_blocked must have shape ({n_blocks},) for "
                         f"B={B}, got {tuple(sub_blocked.shape)}")
    sub = sub_blocked.repeat_interleave(BOUND_DIST_BLOCK)[:B]
    return bound_dist(w_sorted, n_sorted, cum_before, sub, phi)
