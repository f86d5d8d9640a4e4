"""Public wrappers around the Hopper kernels, with launch counters.

On a CUDA tensor a wrapper launches its kernel (``kernels/bf_relax.py``,
``kernels/ktrop.py``, ``kernels/bound_dist.py``, ``kernels/level_walk.py``)
or raises; on a CPU
tensor it runs the kernel's plain PyTorch version (``kernels/ref.py``),
only because the tensor lies on the CPU.  There is no fallback from one
to the other.

``LAUNCHES`` counts kernel launches per wrapper, so a run can show that
its main path went through the kernels (``reset_launches`` zeroes it).

A tensor on the meta device is the caller's choice of "shapes only" (the
dry-run, ``launch.roofline.trace_costs``): the wrapper returns empty meta
outputs of the plain version's shapes and dtypes, reports the kernel's
cost to every sink in ``COST_SINKS`` and launches and counts nothing.
The cost is each input read once and each output written once, and the
reference's min-plus count (``repro/launch/report.py``): 2·S·J·z² per
BF relaxation, 2·S·k·z² per ktrop relaxation, 2·B·E for ``bound_dist``;
a fixed point counts its iteration budget.  ``level_walks`` counts no
min-plus operation (it subtracts and compares along each walk).
"""

from __future__ import annotations

import torch

from . import bf_relax, bound_dist as _bound_dist, ktrop, level_walk, ref

INF = ref.INF

#: queries per block of the TPU kernel's blocked ``bound_dist`` contract
BOUND_DIST_BLOCK = 256

LAUNCHES = {"bf_relax_step": 0, "bf_solve_grouped": 0,
            "ktrop_relax_step": 0, "ktrop_solve": 0, "bound_dist": 0,
            "level_walks": 0}


#: callables ``sink(kernel, n_bytes, minplus_ops)`` that a shapes-only
#: trace registers while it runs (``launch.roofline.trace_costs``)
COST_SINKS: list = []


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _on_cpu(t: torch.Tensor) -> bool:
    return t.device.type == "cpu"


def _on_meta(t: torch.Tensor) -> bool:
    return t.device.type == "meta"


def _meta_out(kernel, n_bytes, minplus_ops, *outs):
    """Report a kernel's cost and return its empty meta outputs, each
    given as (shape, dtype)."""
    for sink in COST_SINKS:
        sink(kernel, int(n_bytes), float(minplus_ops))
    made = tuple(torch.empty(shape, dtype=dtype, device="meta")
                 for shape, dtype in outs)
    return made[0] if len(made) == 1 else made


def bf_relax_step(dist, adj, spur_onehot, banned_next, cap=None):
    """One fused masked BF relaxation (the Pallas ``bf_relax`` contract):
    dist [S,J,z], adj [S,z,z], spur_onehot/banned_next [S,J,z] 0/1 masks
    (any dtype; nonzero = set), cap [S,J] (default INF) → [S,J,z] f32.

    On the card a block whose distances are all ≥ 0 and whose caps are
    all ≤ INF relaxes only the row's finite entries, from a list built as
    the row streams in; any other block scans every entry.  Both give
    the plain version's bytes (``csrc/in_edges.cuh``)."""
    S, J, z = dist.shape
    if _on_meta(dist):  # in: dist, adj, cap f32, two masks; out: f32
        n = S * J * z
        return _meta_out("bf_relax_step",
                         4 * (2 * n + S * z * z + S * J) + 2 * n,
                         2.0 * S * J * z * z, ((S, J, z), torch.float32))
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

    A block relaxes only its row's finite entries (adj < INF), from a
    list in shared memory, where its weights are all ≥ 0, its initial
    distances ≥ 0 and its caps ≤ INF (no NaN): every distance then stays
    ≥ 0, so a skipped term is ≥ INF and never beats the relaxation's
    minimum, which starts at INF; in the parent epilogue it can never be
    the argmin of a reached vertex (``csrc/in_edges.cuh``).  The kernel
    checks these per block and runs the dense loop over every entry where
    one fails.  Both give the plain version's bytes.  ``max_iters=0`` on
    a converged field returns the field and its parents."""
    if _on_meta(init):  # in: adj, init, cap f32, three masks
        S, J, z = init.shape
        n, it = S * J * z, z if max_iters is None else int(max_iters)
        outs = [((S, J, z), torch.float32), ((S, J, z), torch.int32)]
        if with_iters:
            outs.append(((S,), torch.int32))
        return _meta_out(
            "bf_solve_grouped",
            4 * (S * z * z + n + S * J) + 3 * n + 8 * n
            + (4 * S if with_iters else 0),
            2.0 * S * J * z * z * it, *outs)
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
    [S,k,z] f32.  k ≤ 16 on the card, and D[s] must fit in a block's
    shared memory (z up to about 3,000 at k = 16).  A row with D[s] ≥ 0
    folds only its finite entries, from a list built as the row streams
    in; any other row scans every u; both give the plain version's
    bytes."""
    if _on_meta(D):
        S, k, z = D.shape
        return _meta_out("ktrop_relax_step",
                         4 * (2 * S * k * z + S * z * z),
                         2.0 * S * k * z * z, ((S, k, z), torch.float32))
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
    list in shared memory, where the row's weights are all ≥ 0: a
    skipped entry's candidates are then ≥ INF and are never among the k
    smallest distinct values below INF.  A row with a negative weight
    folds every entry.  Both give the plain version's bytes."""
    if _on_meta(adj):
        S, z, _ = adj.shape
        it = z * k + 8 if max_iters is None else int(max_iters)
        outs = [((S, k, z), torch.float32)]
        if with_iters:
            outs.append(((S,), torch.int32))
        return _meta_out(
            "ktrop_solve",
            4 * (S * z * z + S + S * k * z)
            + (4 * S if with_iters else 0),
            2.0 * S * k * z * z * it, *outs)
    adj = adj.float().contiguous()
    src = src.to(torch.int32).contiguous()
    if _on_cpu(adj):
        D, iters = ref.ktrop_solve_ref(adj, src, k, max_iters)
    else:
        D, iters, _ = ktrop.solve(adj, src, k, max_iters)
        LAUNCHES["ktrop_solve"] += 1
    return (D, iters) if with_iters else D


def level_walks(D, row_sub, row_src, row_max_len, in_ptr, in_src, in_w,
                in_eid, walk_ptr, walk_dst, walk_level):
    """The representative walk of each (source, target, level) of a
    batch of ``ktrop_solve`` rows, ``core.bounding.extract_level_path``'s
    rule: (verts [W,z] int32, eids [W,z] int32, n [W] int32), with the
    signature of ``ref.level_walks_ref``.  Walk w of row s runs from
    row_src[s] to walk_dst[w] with total weight walk_level[w] over the
    in-edges of subgraph row_sub[s]; verts[w,:n] are its vertices from
    the source, eids[w,:n-1] the in_eid of its steps, n = 0 where the
    level has no simple walk of at most row_max_len[s] vertices.  Entries
    past a walk's end are not specified (the plain version writes -1).

    Levels, weights and remainders must be integers below 2^24 (sums of
    vfrag counts), so that f32 holds them exactly: the kernel then gives
    the plain version's walks bit for bit."""
    if _on_meta(D):  # in: D, row and walk arrays, in-edge table; out
        S, k, z = D.shape
        G, H, W = in_ptr.shape[0], in_src.shape[0], walk_dst.shape[0]
        return _meta_out(
            "level_walks",
            4 * (S * k * z + 3 * S + G * (z + 1) + 3 * H + S + 1 + 2 * W)
            + 4 * (2 * W * z + W), 0.0,
            ((W, z), torch.int32), ((W, z), torch.int32),
            ((W,), torch.int32))
    i32 = [t.to(torch.int32).contiguous() for t in
           (row_sub, row_src, row_max_len, in_ptr, in_src)]
    args = (D.float().contiguous(), *i32, in_w.float().contiguous(),
            in_eid.to(torch.int32).contiguous(),
            walk_ptr.to(torch.int32).contiguous(),
            walk_dst.to(torch.int32).contiguous(),
            walk_level.float().contiguous())
    if _on_cpu(D):
        return ref.level_walks_ref(*args)
    ptr = args[4]
    h_max = int((ptr[:, -1] - ptr[:, 0]).max()) if ptr.shape[0] else 0
    out = level_walk.walks(*args, h_max=h_max)
    LAUNCHES["level_walks"] += 1
    return out


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
    if _on_meta(phi):  # in: three [S,E] f32, sub i32, phi f32; out f32
        S, E = w_sorted.shape
        B = phi.shape[0]
        return _meta_out("bound_dist", 4 * (3 * S * E + 3 * B),
                         2.0 * B * E, ((B,), torch.float32))
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
