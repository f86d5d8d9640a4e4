#!/usr/bin/env python3
"""On-card smoke test of the repro_torch port (NVIDIA H100).

    python3 chip_smoke.py

Drives the port on one CUDA card and fails (non-zero exit) on the first
phase that does not hold:

1. environment: torch/CUDA versions and the card's name and power limit;
2. build: compiles every CUDA source of ``src/repro_torch/csrc`` with
   nvcc (one process per source, all at once) and prints ptxas' report;
3. kernels at ragged shapes: ``bf_relax_step`` and ``bf_solve_grouped``
   against their plain PyTorch versions on the same inputs, bitwise, at
   densities 30% and 2%, finite caps and cap = INF, J in {33, 40} and
   z % 4 != 0; each kernel's per-block report of which path it ran (its
   in-edge list, or the dense loop or scan where a column is over the
   list's budget or, for the step, where a distance is < 0 or a cap >
   INF) must be what the data dictates, and both paths must have run;
   ``bf_relax_step`` also on adjacency views that start off a 16-byte
   boundary and on inputs that fail each of its checks (a negative
   distance, cap = +inf, a NaN cap) or that need none (negative
   weights, +inf distances);
4. the fused solve at the refine_dense shape (S=8192 slab rows, z=256,
   J=32) on road-like adjacency with Yen-style masks and finite caps:
   both kernels against their plain versions on every row, bitwise, and
   timed with CUDA events beside their bounds, every block on its list;
   the refine_dense cell's step (capped at 64 iterations) gives the same
   bytes; then the fused solve at the serving slab shape (S=64, z=96,
   J in {8, 32}), bitwise and timed;
5. serving: ``KSPService(engine="cuda_bf", device="cuda")`` answers 32
   queries (trips of 8-16 hops), one UpdateBatch, and 32 more on a
   64x64 road grid; the same trace on the port's plain ``dense_bf``
   engine must give the same (paths, epoch), a few answers must match
   host Yen on the full graph, and the serving run must have launched
   ``bf_solve_grouped``;
6. index kernels at ragged shapes: ``ktrop_relax_step`` and
   ``ktrop_solve`` bitwise against their plain versions at z in
   {1, 33, 96, 200, 256}, densities 30% and 2%, k in {1, 2, 10, 16}, and
   both at z=1000, 30% (over the list's budget, dense) and 0.4%, with
   their path reports checked as in 3; ``ktrop_relax_step`` also on
   offset views, a negative level (dense) and negative weights (list);
   ``bound_dist`` bitwise against ``bound_dist_seq_ref`` (the sum in the
   kernel's order) and within rtol 2e-5 of ``bound_dist_ref``, its
   grouping against ``group_by_subgraph``,
   under a permutation of the queries and over two launches, at E in
   {1, 37, 2048} (and ``bound_dist_blocked`` there), all queries on one
   subgraph, Zipf-like subgraphs, most subgraphs empty, B=0, B=300,001,
   E=20,000 (79 segments) and running counts that are not exact (the
   kernel's loop), wholly or from the middle of each row;
7. the kspdg ``levels`` cell (S=8192, z=256, k=10, 48 iterations) on
   road-like subgraphs with integer vfrag weights, through the cell's own
   step: the step kernel bitwise against the plain step on every row
   (its inputs checked on the host to take the list path, and it did),
   the fused solve (D and per-row iterations) bitwise against the plain
   solve on every row, every row on its list;
8. the kspdg ``maintain`` cell (S=122,880, E=2,048, B=4,000,000) through
   the cell's own step (profile sort + ``bound_dist``), against the plain
   ``dense.bound_dist_batch`` (rtol 1e-4, atol 1e-3) and against
   ``bound_dist_ref`` (rtol 2e-5), with a float64 clip-sum as a third
   opinion on one chunk; ``bound_dist`` bitwise against
   ``bound_dist_seq_ref`` on that chunk, under a permutation of all the
   queries and over two launches, its grouping against
   ``group_by_subgraph``; the step, the profile sort, the grouping and the
   evaluation timed; then ``kspdg_smoke(device="cuda")``.

It imports nothing of JAX or of the reference package.  Without a card
it exits non-zero and prints no result.  The last three lines are the
kernels JSON, the nvidia-smi name/power-limit line, and the ok JSON.
"""

from __future__ import annotations

import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# NVIDIA H100 SXM data-sheet peaks (dense, no sparsity, at 700 W): HBM3
# bandwidth and float32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

SEED = 0
DENSE_S, DENSE_Z, DENSE_J = 8192, 256, 32  # refine_dense shape inventory
PLAIN_CHUNK = 256  # slab rows per plain-version call (bounds its memory)
LEVELS_K, LEVELS_ITERS = 10, 48  # the levels cell's ktrop_solve arguments
BD_CHUNK = 1 << 18  # queries per plain bound-distance call
# bound_dist at ragged and skewed shapes: (name, S, E, B, the queries'
# subgraphs, exact running counts: True, False (fractional counts: the
# kernel's loop) or "half" (exact on the first half of each row))
BOUND_DIST_CASES = [
    ("E=1", 5, 1, 1000, "uniform", True),
    ("E=37", 5, 37, 1000, "uniform", True),
    ("E=2048", 5, 2048, 1000, "uniform", True),
    ("one subgraph", 64, 2048, 200_000, "one", True),
    ("zipf", 4096, 512, 300_000, "zipf", True),
    ("most empty", 100_000, 64, 50_000, "sparse", True),
    ("B=0", 16, 256, 0, "uniform", True),
    ("B=300001 E=301", 2048, 301, 300_001, "uniform", True),
    ("E=20000", 16, 20_000, 5_000, "uniform", True),
    ("inexact", 64, 700, 20_000, "uniform", False),
    ("half exact", 64, 700, 20_000, "uniform", "half"),
]


def log(*parts):
    print(*parts, flush=True)


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / FP32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def cuda_ms(torch, fn, repeats: int) -> float:
    """Median of ``repeats`` CUDA-event timings of ``fn()``."""
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def chunked(torch, fn, n_rows: int, *args):
    """Apply a row-independent plain function chunk by chunk over S."""
    outs = [fn(*(a[i:i + PLAIN_CHUNK] for a in args))
            for i in range(0, n_rows, PLAIN_CHUNK)]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(parts) for parts in zip(*outs))
    return torch.cat(outs)


def check(ok, what) -> None:
    """Fail the run (also under ``python -O``, unlike assert)."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def max_abs_err(torch, got, want) -> float:
    return float((got.double() - want.double()).abs().max())


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------
def ragged_inputs(np, rng, S, J, z, one_hot, density=0.3, cap_inf=False):
    """Slab at ``density`` (finite entries), mid-relaxation distances and
    masks (general or Yen-style), finite caps or INF (the default of
    ``ops.bf_relax_step``), and an all-INF padding problem."""
    from repro_torch.kernels.ref import INF

    adj = rng.uniform(1.0, 50.0, (S, z, z)).astype(np.float32)
    adj[rng.random((S, z, z)) > density] = INF
    for s in range(S):
        np.fill_diagonal(adj[s], 0.0)
    init = np.full((S, J, z), INF, np.float32)
    src = rng.integers(z, size=(S, J))
    np.put_along_axis(init, src[:, :, None], 0.0, axis=2)
    part = init[:, :, : z // 4]
    init[:, :, : z // 4] = np.where(
        rng.random(part.shape) < 0.5,
        rng.uniform(0, 30, part.shape).astype(np.float32), part)
    if one_hot:
        so = np.zeros((S, J, z), bool)
        np.put_along_axis(so, src[:, :, None], True, axis=2)
    else:
        so = rng.random((S, J, z)) < 0.05
    bv = (rng.random((S, J, z)) < 0.05) & ~so
    bn = rng.random((S, J, z)) < 0.1
    cap = rng.uniform(20.0, 80.0, (S, J)).astype(np.float32)
    if cap_inf:
        cap[:] = INF
    init[:, J - 1, :] = INF  # a padding problem must no-op
    so[:, J - 1, :] = False
    return adj, init, bv, so, bn, cap


def road_inputs(torch, S, J, z, device):
    """Solve inputs made on the card from a seed: each slab row a road
    grid of z vertices (16x16 at the refine_dense z=256, 8x12 at the
    serving z=96; 2-4 neighbours per vertex, integer weights 1-100, 0
    diagonal); each problem a Yen spur search with a one-hot spur (its
    source), banned root-path vertices, banned next hops and a finite
    cap."""
    from repro_torch.kernels.ref import INF

    gen = torch.Generator(device=device).manual_seed(SEED)
    rows = max(d for d in range(1, int(z ** 0.5) + 1) if z % d == 0)
    cols = z // rows
    v = torch.arange(z, device=device)
    r, c = v // cols, v % cols
    right, down = v[c < cols - 1], v[r < rows - 1]
    eu = torch.cat([right, down])
    ev = torch.cat([right + 1, down + cols])
    w = torch.randint(1, 101, (S, eu.numel()), generator=gen,
                      device=device).float()
    adj = torch.full((S, z, z), INF, device=device)
    adj[:, eu, ev] = w
    adj[:, ev, eu] = w
    adj[:, v, v] = 0.0
    spur = torch.randint(0, z, (S, J), generator=gen, device=device)
    so = torch.nn.functional.one_hot(spur, z).bool()
    init = torch.where(so, 0.0, torch.full((S, J, z), INF, device=device))
    bv = (torch.rand((S, J, z), generator=gen, device=device) < 0.04) & ~so
    bn = torch.rand((S, J, z), generator=gen, device=device) < 0.02
    cap = 400.0 + 1600.0 * torch.rand((S, J), generator=gen, device=device)
    return adj, init.contiguous(), bv, so.contiguous(), bn, cap


def list_expected(torch, adj, slots):
    """Per slab row, whether the fused solves can run from their in-edge
    list: every column of the row has at most ``slots`` finite entries."""
    from repro_torch.kernels.ref import INF

    return (adj < INF).sum(dim=1).amax(dim=1) <= slots if slots else \
        torch.zeros(adj.shape[0], dtype=torch.bool, device=adj.device)


def bf_step_path(torch, dist, cap, adj, jt, slots):
    """The path each ``bf_relax_step`` block must take [S, ceil(J/jt)]:
    its in-edge list (1) where its distances are all >= 0, its caps all
    <= INF and every column of the row within the list's slots, else the
    dense scan (0)."""
    from repro_torch.kernels.ref import INF

    S, J, _ = dist.shape
    ok = (dist >= 0).all(dim=2) & (cap <= INF)
    fits = list_expected(torch, adj, slots)
    return torch.stack([ok[:, j0:j0 + jt].all(dim=1) & fits
                        for j0 in range(0, J, jt)], dim=1).int()


def ktrop_step_path(torch, D, adj, slots):
    """The path each ``ktrop_relax_step`` row must take [S]: the list (1)
    where D[s] >= 0 and every column fits its slots, else every u (0)."""
    return ((D >= 0).flatten(1).all(dim=1)
            & list_expected(torch, adj, slots)).int()


def offset_copy(torch, t, floats):
    """A contiguous copy of ``t`` whose storage starts ``floats`` f32
    past a fresh allocation (off a 16-byte boundary unless floats % 4 is
    0): the view a slice such as ``big[1:]`` gives."""
    big = torch.empty(t.numel() + floats, dtype=t.dtype, device=t.device)
    view = big[floats:].view(t.shape)
    view.copy_(t)
    return view


def bf_solve_ops(torch, adj, iters, J, jt):
    """Operations the fused BF solve needs on this data: 2·jn·nnz(adj[s])
    add+min per block and iteration (jn problems of the block), plus the
    same once for the parent epilogue."""
    from repro_torch.kernels.ref import INF

    nnz = (adj < INF).sum(dim=(1, 2)).double()
    jn = torch.tensor([min(jt, J - t) for t in range(0, J, jt)],
                      dtype=torch.float64, device=adj.device)
    return float((2.0 * nnz[:, None] * jn[None, :]
                  * (iters.double() + 1.0)).sum())


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------
def phase_build():
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    libs = _build.build_all()
    log(f"[build] {len(libs)} CUDA source(s) built in "
        f"{time.perf_counter() - t0:.2f} s: "
        + ", ".join(p.name for p in libs.values()))
    for name, info in _build.BUILD_INFO.items():
        regs = [int(n) for n in re.findall(r"Used (\d+) registers", info["log"])]
        spills = [int(n) for n in
                  re.findall(r"(\d+) bytes spill stores", info["log"])]
        log(f"[build] {name}: {len(regs)} kernel instantiations, "
            f"{min(regs)}-{max(regs)} registers per thread, at most "
            f"{max(spills)} bytes of spill stores (ptxas -v)")
    # registers of each kernel's instantiation (template argument)
    for name, kernel in (("bf_relax", "bf_relax_step_kernel"),
                         ("bf_relax", "bf_solve_grouped_kernel"),
                         ("ktrop", "ktrop_relax_step_kernel"),
                         ("ktrop", "ktrop_solve_kernel")):
        per = {}
        entry = None
        ptxas = _build.BUILD_INFO.get(name, {}).get("log", "")
        for line in ptxas.splitlines():
            m = re.search(r"entry function '(\S+)'", line)
            if m:
                t = re.search(kernel + r"ILi(\d+)E", m.group(1))
                entry = int(t.group(1)) if t else None
            m = re.search(r"Used (\d+) registers", line)
            if m and entry is not None:
                per[entry] = int(m.group(1))
                entry = None
        log(f"[build] {kernel} registers per thread by template argument "
            f"(ptxas -v): {dict(sorted(per.items()))}")


def phase_ragged(torch, np, dev):
    from repro_torch.engine import dense
    from repro_torch.kernels import _build, bf_relax, ops, ref

    rng = np.random.default_rng(SEED)
    shapes = [(3, 1, 96), (2, 3, 200), (4, 8, 128), (2, 40, 33),
              (1, 5, 1000), (5, 32, 256), (2, 33, 97), (2, 40, 250)]
    # (one-hot spurs, density, cap = INF): 30% rows run the dense loop
    # (except at z=33), 2% rows the in-edge list
    variants = [(False, 0.3, False), (True, 0.3, False), (True, 0.3, True),
                (True, 0.02, False), (False, 0.02, True)]
    loops = {"list": 0, "dense": 0}
    step_paths = {"list": 0, "dense": 0}
    for S, J, z in shapes:
        jt = bf_relax.tile_width(J, z, bf_relax.solve_smem)
        slots = _build.edge_list_slots(bf_relax.tile_smem(jt, z), z)
        for one_hot, density, cap_inf in variants:
            args = [torch.from_numpy(a).to(dev) for a in ragged_inputs(
                np, rng, S, J, z, one_hot, density, cap_inf)]
            adj, init, bv, so, bn, cap = args
            what = (S, J, z, one_hot, density, cap_inf)
            got = ops.bf_relax_step(init, adj, so, bn, cap)
            want = ref.bf_relax_ref(init, adj, so, bn, cap)
            check(torch.equal(got, want), ("bf_relax_step", what))
            check_bf_step(torch, init, adj, so, bn, cap, want, what,
                          step_paths)
            d, p = ops.bf_solve_grouped(*args)
            wd, wp, wit = ref.bf_solve_grouped_ref(*args, with_iters=True)
            check(torch.equal(d, wd) and torch.equal(p, wp),
                  ("bf_solve_grouped", what))
            ld, lp, lit, used = bf_relax.solve_grouped(*args)
            check(torch.equal(ld, d) and torch.equal(lp, p)
                  and torch.equal(lit.amax(dim=1), wit),
                  ("bf_solve_grouped iterations per row", what))
            check(torch.equal(used.bool(), list_expected(torch, adj, slots)
                              [:, None].expand_as(used)),
                  ("bf_solve_grouped loop report", what))
            if z == 1000 and density == 0.3:
                check(not used.any(), "z=1000 at 30% ran the in-edge list")
            n_list = int(used.sum())
            loops["list"] += n_list
            loops["dense"] += used.numel() - n_list
            if one_hot and density == 0.3:  # the dense engine's formulation
                dd, _ = dense.bf_solve_grouped(adj, init, bv, so, bn, cap=cap)
                check(torch.equal(d, dd), ("dense dist", what))
                dp = dense.bf_parents_grouped(adj, dd, so, bn)
                check(torch.equal(p, dp), ("dense parents", what))
    torch.cuda.synchronize()
    check(loops["list"] > 0 and loops["dense"] > 0,
          ("both loops of bf_solve_grouped ran", loops))
    log(f"[ragged] bf_relax_step and bf_solve_grouped (dist, parents and "
        f"iterations per row) bitwise equal to plain at (S,J,z) in {shapes}, "
        f"general and one-hot masks, densities 30% and 2%, finite caps and "
        f"cap = INF; solve blocks by loop {loops}, step blocks by path "
        f"{step_paths}, each as the data dictates (every column within the "
        f"list's slots; for the step also distances >= 0 and caps <= INF), "
        f"z=1000 at 30% all dense")
    cases = bf_step_cases(torch, np, rng, dev)
    torch.cuda.synchronize()
    log(f"[ragged] bf_relax_step bitwise equal to plain, with the path each "
        f"block must take, on adjacency views off a 16-byte boundary and "
        f"inputs that fail or need no check: " + "; ".join(
            f"{name} {paths}" for name, paths in cases.items()))


def check_bf_step(torch, dist, adj, so, bn, cap, want, what, paths):
    """``bf_relax_step`` through its launcher: bitwise ``want`` and the
    path report ``bf_step_path`` dictates; counts the paths in ``paths``."""
    from repro_torch.kernels import bf_relax

    S, J, z = dist.shape
    jt = bf_relax.tile_width(J, z, bf_relax.step_smem)
    got, path = bf_relax.relax_step(dist, adj, so, bn, cap, with_path=True)
    check(torch.equal(got, want), ("bf_relax_step", what))
    check(torch.equal(path, bf_step_path(
        torch, dist, cap, adj, jt, bf_relax.step_layout(jt, z)[0])),
        ("bf_relax_step path report", what, path.tolist()))
    n_list = int(path.sum())
    paths["list"] += n_list
    paths["dense"] += path.numel() - n_list


def bf_step_cases(torch, np, rng, dev):
    """``bf_relax_step`` on list rows (density 2%, or 1/z where lower) on
    adjacency views that start 1, 2 or 3 floats off a 16-byte boundary or
    one row in (as ``big[1:]``), and on inputs that fail a check (a
    negative distance, where d + INF < INF may win at a non-edge; cap =
    +inf; a NaN cap) or need none (negative weights are edges; +inf
    distances); bitwise against the plain step, with the path each block
    must take.  Returns the paths by case."""
    from repro_torch.kernels import ref

    out = {}
    for S, J, z in ((2, 33, 97), (3, 8, 256), (2, 5, 1000)):
        adj, init, _, so, bn, cap = (torch.from_numpy(a).to(dev) for a in
                                     ragged_inputs(np, rng, S, J, z, True,
                                                   min(0.02, 1.0 / z)))
        neg_d = init.clone()
        neg_d[0, 0, 1] = -1e37
        inf_d = init.clone()
        inf_d[:, :, -1] = float("inf")
        cap_inf = cap.clone()
        cap_inf[S - 1, 0] = float("inf")
        cap_nan = cap.clone()
        cap_nan[0, J - 1] = float("nan")
        neg_w = adj.clone()
        flip = (neg_w < ref.INF) & (torch.rand(neg_w.shape, device=dev) < 0.3)
        neg_w[flip] *= -1.0
        cases = [("aligned", init, adj, cap)]
        cases += [(f"offset {f}", init, offset_copy(torch, adj, f), cap)
                  for f in (1, 2, 3, z * z)]
        cases += [("negative distance", neg_d, adj, cap),
                  ("+inf distances", inf_d, adj, cap),
                  ("cap=+inf", init, adj, cap_inf),
                  ("NaN cap", init, adj, cap_nan),
                  ("negative weights", init, neg_w, cap)]
        for name, dist, a, c in cases:
            paths = {"list": 0, "dense": 0}
            want = ref.bf_relax_ref(dist, a, so, bn, c)
            check_bf_step(torch, dist, a, so, bn, c, want, (name, S, J, z),
                          paths)
            key = f"{name} (S,J,z)={(S, J, z)}"
            out[key] = paths
            dense_wanted = name in ("negative distance", "cap=+inf",
                                    "NaN cap")
            check(paths["dense"] > 0 if dense_wanted else
                  paths["dense"] == 0, ("bf_relax_step path", key, paths))
    return out


def phase_refine_dense(torch, dev, cell):
    from repro_torch.engine import dense
    from repro_torch.kernels import bf_relax, ops, ref

    S, J, z = DENSE_S, DENSE_J, DENSE_Z
    adj, init, bv, so, bn, cap = road_inputs(torch, S, J, z, dev)
    torch.cuda.synchronize()
    adj_bytes = adj.numel() * 4
    log(f"[refine_dense] S={S} J={J} z={z}: adjacency "
        f"{adj_bytes / 2**30:.2f} GiB on the card")
    rows = torch.arange(S, device=dev)

    # --- one relaxation (bf_relax_step); its inputs meet the list path's
    # checks (distances >= 0, caps <= INF, every column within the slots),
    # so the list path is the one timed
    step_jt = bf_relax.tile_width(J, z, bf_relax.step_smem)
    step_slots = bf_relax.step_layout(step_jt, z)[0]
    check(bool(bf_step_path(torch, init, cap, adj, step_jt, step_slots).all()),
          "refine_dense step inputs fail the list path's checks")
    _, step_path = bf_relax.relax_step(init, adj, so, bn, cap, with_path=True)
    check(bool(step_path.all()), "refine_dense step blocks ran dense")
    step_ms = cuda_ms(torch, lambda: ops.bf_relax_step(init, adj, so, bn, cap),
                      repeats=7)
    got = ops.bf_relax_step(init, adj, so, bn, cap)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    want = chunked(torch, ref.bf_relax_ref, S, init, adj, so, bn, cap)
    end.record()
    torch.cuda.synchronize()
    step_plain_ms = start.elapsed_time(end)
    check(torch.equal(got, want), "bf_relax_step differs at refine_dense")
    step_err = max_abs_err(torch, got, want)
    n = S * J * z
    step_bytes = adj_bytes + n * 4 * 2 + n * 2 + S * J * 4
    step_bound, step_by = bound_ms(step_bytes, 2.0 * S * J * z * z)
    log(f"[refine_dense] bf_relax_step: {step_ms:.3f} ms (median of 7), "
        f"{step_bytes / step_ms / 1e6:.0f} GB/s of the {step_bytes / 1e9:.3f} "
        f"GB it must move, plain {step_plain_ms:.1f} ms, bound "
        f"{step_bound:.3f} ms ({step_by}); every block on its in-edge list "
        f"({bf_relax.step_smem(step_jt, z)} B of shared memory per block, "
        f"{bf_relax.step_blocks_per_sm(J, z)} blocks per SM); bitwise equal "
        f"on all {S} rows")

    # --- the fused fixed point with parents (bf_solve_grouped)
    dist, parent, iters, used = bf_relax.solve_grouped(adj, init, bv, so, bn,
                                                       cap)
    check(bool(used.all()), ("refine_dense blocks ran the dense loop",
                             int(used.numel() - used.sum())))
    solve_ms = cuda_ms(
        torch, lambda: ops.bf_solve_grouped(adj, init, bv, so, bn, cap),
        repeats=5)
    start.record()
    want_d, want_p, want_it = chunked(
        torch, lambda *a: ref.bf_solve_grouped_ref(*a, with_iters=True), S,
        adj, init, bv, so, bn, cap)
    end.record()
    torch.cuda.synchronize()
    solve_plain_ms = start.elapsed_time(end)
    check(torch.equal(dist, want_d), "bf_solve_grouped dist differs")
    check(torch.equal(parent, want_p), "bf_solve_grouped parents differ")
    check(torch.equal(iters.amax(dim=1), want_it),
          "bf_solve_grouped iterations per row differ")
    # the refine_dense cell's own step: its 64-iteration cap does not bind
    check(int(want_it.max()) < 64, "refine_dense rows need 64+ iterations")
    check(tuple(cell.arg_specs[0].shape) == (S, z, z), "refine_dense shape")
    cd, cp, cit = cell.step_fn(adj, init, bv, so, bn, cap)
    check(torch.equal(cd, dist) and torch.equal(cp, parent)
          and torch.equal(cit, want_it),
          "the refine_dense cell's step differs")
    # the dense engine's formulation on a subset of rows (one-hot spurs)
    sub = rows[:: S // 64]
    dd, _ = dense.bf_solve_grouped(adj[sub], init[sub], bv[sub], so[sub],
                                   bn[sub], cap=cap[sub])
    dp = dense.bf_parents_grouped(adj[sub], dd, so[sub], bn[sub])
    check(torch.equal(dd, dist[sub]) and torch.equal(dp, parent[sub]),
          "the dense engine's solve differs on the checked rows")
    it = iters.double()
    # this run's work: the kept (u, v) pairs of each row, per problem,
    # iteration and the parent epilogue
    jt = bf_relax.tile_width(J, z, bf_relax.solve_smem)
    smem = bf_relax.solve_smem(jt, z)
    # the fixed cost: tile loads, the one read of the row, the epilogue
    fixed_ms = cuda_ms(torch, lambda: bf_relax.solve_grouped(
        adj, init, bv, so, bn, cap, max_iters=0), repeats=5)
    solve_bound, solve_by = bound_ms(
        adj_bytes + n * 4 * 3 + n * 3 + S * J * 4,
        bf_solve_ops(torch, adj, iters, J, jt))
    reached = (dist < ref.INF / 2).double().mean()
    log(f"[refine_dense] bf_solve_grouped: {solve_ms:.3f} ms (median of 5), "
        f"plain {solve_plain_ms:.1f} ms, bound {solve_bound:.3f} ms "
        f"({solve_by}); iterations per block max {int(it.max())} mean "
        f"{float(it.mean()):.2f}; reached share {float(reached):.3f}; "
        f"in-edge list on {int(used.sum())} of {used.numel()} blocks "
        f"({smem} B of shared memory per block, "
        f"{bf_relax.solve_blocks_per_sm(J, z)} blocks per SM); with "
        f"max_iters=0 (loads, list build, epilogue) {fixed_ms:.3f} ms; "
        f"dist, parents and iterations per row bitwise equal to plain on "
        f"all {S} rows, and to the refine_dense cell's step")
    return {
        "bf_relax_step": dict(ms=step_ms, plain_ms=step_plain_ms,
                              bound_ms=step_bound, bound_by=step_by,
                              max_abs_err=step_err),
        "bf_solve_grouped": dict(ms=solve_ms, plain_ms=solve_plain_ms,
                                 bound_ms=solve_bound, bound_by=solve_by,
                                 max_abs_err=max_abs_err(torch, dist, want_d),
                                 list_blocks=int(used.sum()),
                                 dense_blocks=int(used.numel() - used.sum())),
    }


def phase_serving_shape(torch, dev):
    """``bf_solve_grouped`` at the serving slab shape (S=64 rows, z=96) on
    road-like rows, J in {8, 32}: bitwise against the plain version and
    timed (median of 21 CUDA-event timings of one launch)."""
    from repro_torch.kernels import bf_relax, ops, ref

    times = {}
    for J in (8, 32):
        args = road_inputs(torch, 64, J, 96, dev)
        d, p, it, used = bf_relax.solve_grouped(*args)
        wd, wp, wit = ref.bf_solve_grouped_ref(*args, with_iters=True)
        check(torch.equal(d, wd) and torch.equal(p, wp)
              and torch.equal(it.amax(dim=1), wit),
              ("bf_solve_grouped at the serving shape", J))
        check(bool(used.all()), ("serving-shape blocks ran the dense loop", J))
        ms = cuda_ms(torch, lambda: ops.bf_solve_grouped(*args), repeats=21)
        times[f"S64_J{J}_z96"] = ms
        log(f"[serving-shape] bf_solve_grouped S=64 J={J} z=96: {ms:.4f} ms "
            f"(median of 21), {bf_relax.solve_blocks_per_sm(J, 96)} blocks "
            f"per SM, iterations per block max {int(it.max())}, "
            f"in-edge list on all {used.numel()} blocks, bitwise equal to "
            f"plain")
    return times


def local_trips(np, g, n, rng, lo=8, hi=16):
    """``n`` (s, t) pairs, t drawn among the vertices ``lo``..``hi`` hops
    from a random s (city-scale trips).  Long random pairs are avoided:
    the reference host join (``core/kspdg.py::_k_best_joins``) grows
    combinatorially on some of them (one 34-hop pair took 58 s of host
    time on a CPU), which is host work this check does not measure."""
    out = []
    while len(out) < n:
        s = int(rng.integers(g.n))
        hops = np.full(g.n, -1)
        hops[s] = 0
        frontier = [s]
        for h in range(1, hi + 1):
            nxt = []
            for u in frontier:
                for v in g.csr_dst[g.csr_indptr[u]:g.csr_indptr[u + 1]]:
                    if hops[v] < 0:
                        hops[v] = h
                        nxt.append(int(v))
            frontier = nxt
        cand = np.nonzero((hops >= lo) & (hops <= hi))[0]
        if cand.size:
            out.append((s, int(rng.choice(cand))))
    return out


def build_service(engine):
    """A fresh 64x64 road grid, its DTLP index (z=32, xi=4) and a
    4-worker service on the card."""
    from repro_torch.core.dtlp import DTLP
    from repro_torch.data.roadnet import grid_road_network
    from repro_torch.service import KSPService, ServiceConfig

    g = grid_road_network(64, 64, seed=SEED)
    t0 = time.perf_counter()
    d = DTLP.build(g, z=32, xi=4)
    build_s = time.perf_counter() - t0
    svc = KSPService(d, ServiceConfig(engine=engine, n_workers=4,
                                      device="cuda", max_in_flight=8))
    return svc, build_s, g


def phase_serving(torch, np):
    from repro_torch.core.sssp import graph_view
    from repro_torch.core.yen import ksp
    from repro_torch.data.roadnet import WeightUpdateStream, grid_road_network
    from repro_torch.kernels import ops
    from repro_torch.service import QueryRequest, UpdateBatch

    g0 = grid_road_network(64, 64, seed=SEED)
    queries = local_trips(np, g0, 64, np.random.default_rng(SEED))
    # one traffic update: 5% of the edges move by up to +-50% of their
    # initial weight.  (At the stream's default of 50% of the edges the
    # DTLP bounds drift so far that some queries need hundreds of KSP-DG
    # iterations of host work; ROADMAP queue 1, item 11.)
    batch = WeightUpdateStream(g0, alpha=0.05, tau=0.5,
                               seed=SEED).next_batch()

    def serve(engine):
        svc, build_s, g = build_service(engine)
        ops.reset_launches()
        t0 = time.perf_counter()
        tickets = svc.replay([QueryRequest(s, t, 3) for s, t in queries[:32]])
        svc.update(UpdateBatch(*batch))
        tickets += svc.replay([QueryRequest(s, t, 3) for s, t in queries[32:]])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)
        answers = [(tk.result.paths, tk.result.epoch) for tk in tickets]
        lat = sorted(tk.result.latency_ms for tk in tickets)
        slabs = [tuple(w.slab.adj.shape) for w in svc.cluster.workers
                 if w.slab is not None]
        log(f"[serving] {engine}: grid {g.n} vertices {g.m} edges, DTLP "
            f"build {build_s:.1f} s, slabs {slabs}; {len(tickets)} queries + "
            f"1 update in {wall:.2f} s = {len(tickets) / wall:.2f} qps, "
            f"latency p50 {np.percentile(lat, 50):.1f} ms p99 "
            f"{np.percentile(lat, 99):.1f} ms; launches {launches}")
        return svc, answers, launches

    svc, answers, launches = serve("cuda_bf")
    check(launches["bf_solve_grouped"] > 0, "serving never launched the kernel")
    check([e for _, e in answers] == [0] * 32 + [1] * 32,
          "results not stamped epoch 0 before the update and 1 after")
    check(all(paths for paths, _ in answers), "a query found no path")
    check(all(np.isfinite(d) and d > 0 for paths, _ in answers
              for d, _ in paths), "a path length is not finite and positive")

    # host Yen on the full graph: epoch 0 on a fresh graph, epoch 1 on the
    # service's own (updated) graph
    checks = [(g0, i) for i in range(4)] + [(svc.dtlp.graph, 32 + i)
                                             for i in range(4)]
    for g, i in checks:
        s, t = queries[i]
        want = [round(x, 5) for x, _ in ksp(graph_view(g), s, t, 3)]
        check([round(x, 5) for x, _ in answers[i][0]] == want,
              ("host Yen differs", i, want))
    log(f"[serving] cuda_bf answers equal host Yen on {len(checks)} queries "
        "(4 per epoch)")

    _, plain_answers, plain_launches = serve("dense_bf")
    check(plain_answers == answers, "cuda_bf and dense_bf answers differ")
    check(plain_launches["bf_solve_grouped"] == 0,
          "the plain engine launched the kernel")
    log("[serving] cuda_bf (paths, epoch) equal the plain dense_bf engine's "
        "on all 64 queries")
    return launches


def phase_ragged_index(torch, np, dev):
    from repro_torch.kernels import _build, ktrop, ops, ref

    rng = np.random.default_rng(SEED)
    loops = {"list": 0, "dense": 0}
    # (z, density, k values): 30% rows run the dense loop (z > 1), 2% rows
    # the in-edge list; z=1000 at 30% (about 300 entries per column) is
    # over any list budget
    cases = [(z, density, (1, 2, 10, 16)) for z in (1, 33, 96, 200, 256)
             for density in (0.3, 0.02)] + [(1000, 0.3, (10,)),
                                            (1000, 0.004, (10,))]
    step_paths = {"list": 0, "dense": 0}
    for z, density, ks in cases:
        S = 3
        adj = rng.integers(1, 9, (S, z, z)).astype(np.float32)
        adj[rng.random((S, z, z)) > density] = ref.INF
        for s in range(S):
            np.fill_diagonal(adj[s], 0.0)
        adj = torch.from_numpy(adj).to(dev)
        src = torch.from_numpy(rng.integers(0, z, S).astype(np.int32)).to(dev)
        for k in ks:
            want_d, want_it = ref.ktrop_solve_ref(adj, src, k)
            d, it = ops.ktrop_solve(adj, src, k, with_iters=True)
            check(torch.equal(d, want_d) and torch.equal(it, want_it),
                  ("ktrop_solve", z, density, k))
            ld, lit, used = ktrop.solve(adj, src, k)
            slots = _build.edge_list_slots(2 * k * z * 4, z)
            check(torch.equal(ld, d) and torch.equal(lit, it)
                  and torch.equal(used.bool(),
                                  list_expected(torch, adj, slots)),
                  ("ktrop_solve loop report", z, density, k))
            if z == 1000 and density == 0.3:
                check(not used.any(), "z=1000 at 30% ran the in-edge list")
            loops["list"] += int(used.sum())
            loops["dense"] += used.numel() - int(used.sum())
            d3, it3 = ops.ktrop_solve(adj, src, k, 3, with_iters=True)  # cap
            w3, wit3 = ref.ktrop_solve_ref(adj, src, k, 3)
            check(torch.equal(d3, w3) and torch.equal(it3, wit3),
                  ("ktrop_solve max_iters=3", z, density, k))
            D = w3  # a mid-relaxation state, ascending along k
            for _ in range(2):
                got = ops.ktrop_relax_step(D, adj)
                want = ref.ktrop_relax_ref(D, adj)
                check(torch.equal(got, want), ("ktrop_relax_step", z, k))
                check(not torch.isinf(got).any(), ("+inf in ktrop", z, k))
                check_ktrop_step(torch, D, adj, want, (z, density, k),
                                 step_paths)
                D = want
    check(loops["list"] > 0 and loops["dense"] > 0,
          ("both loops of ktrop_solve ran", loops))
    torch.cuda.synchronize()
    check(step_paths["list"] > 0 and step_paths["dense"] > 0,
          ("both paths of ktrop_relax_step ran", step_paths))
    log("[ragged-index] ktrop_relax_step and ktrop_solve (D and iterations "
        "per row, to the fixed point and capped at 3) bitwise equal to "
        "plain at z in {1, 33, 96, 200, 256}, densities 30% and 2%, k in "
        "{1, 2, 10, 16}, and at z=1000, 30% and 0.4%, k=10; solve rows by "
        f"loop {loops}, step rows by path {step_paths}, each as the data "
        "dictates, z=1000 at 30% all dense")
    cases = ktrop_step_cases(torch, np, rng, dev)
    torch.cuda.synchronize()
    log("[ragged-index] ktrop_relax_step bitwise equal to plain, with the "
        "path each row must take, on adjacency views off a 16-byte "
        "boundary, a negative level and negative weights: " + "; ".join(
            f"{name} {paths}" for name, paths in cases.items()))
    times = {}
    for what, S, E, B, kind, exact in BOUND_DIST_CASES:
        w, n, cb, sub, phi = profile_inputs(torch, np, rng, S, E, B, kind,
                                            exact, dev)
        got, ms = check_bound_dist(torch, w, n, cb, sub, phi, what)
        times[what] = ms
        if what.startswith("E="):  # the TPU kernel's blocked signature
            sub_blocked = torch.from_numpy(rng.integers(
                0, S, -(-B // 256)).astype(np.int32)).to(dev)
            sub_q = sub_blocked.repeat_interleave(256)[:B]
            got_b = ops.bound_dist_blocked(w, n, cb, sub_blocked, phi)
            check(torch.equal(got_b, ref.bound_dist_seq_ref(w, n, cb, sub_q,
                                                             phi)),
                  ("bound_dist_blocked vs bound_dist_seq_ref", what))
            torch.testing.assert_close(
                got_b, ref.bound_dist_ref(w, n, cb, sub_q, phi), rtol=2e-5,
                atol=0.0)
    check_evaluate_refusals(torch, np, rng, dev)
    torch.cuda.synchronize()
    log("[ragged-index] bound_dist bitwise equal to bound_dist_seq_ref and "
        "within rtol 2e-5 of bound_dist_ref, its grouping equal to "
        "group_by_subgraph (counts, offsets; ids per bucket), invariant "
        "under a permutation of the queries and equal over two launches, "
        "on every case; bound_dist_blocked likewise at E in {1, 37, 2048}; "
        "the evaluation refuses a grouping with a field on the CPU or made "
        "for another S; ms (median of 5) by case: "
        + ", ".join(f"{k} {v:.4f}" for k, v in times.items()))
    return times


def check_ktrop_step(torch, D, adj, want, what, paths):
    """``ktrop_relax_step`` through its launcher: bitwise ``want`` and the
    path report ``ktrop_step_path`` dictates; counts the paths."""
    from repro_torch.kernels import ktrop

    S, k, z = D.shape
    got, path = ktrop.relax_step(D, adj, with_path=True)
    check(torch.equal(got, want), ("ktrop_relax_step", what))
    check(torch.equal(path, ktrop_step_path(torch, D, adj,
                                            ktrop.step_layout(k, z)[0])),
          ("ktrop_relax_step path report", what, path.tolist()))
    paths["list"] += int(path.sum())
    paths["dense"] += S - int(path.sum())


def ktrop_step_cases(torch, np, rng, dev):
    """``ktrop_relax_step`` on list rows (density 2%, or 1/z where lower)
    from a mid-relaxation D, on adjacency views 1, 2 or 3 floats
    off a 16-byte boundary or one row in, with a level of -1e37 (dense:
    -1e37 + INF < INF may enter at a non-edge) and with negative weights
    (edges, list); bitwise against the plain step.  Paths by case."""
    from repro_torch.kernels import ref

    out = {}
    k = 10
    for z in (33, 256, 1000):
        S = 3
        a = rng.integers(1, 9, (S, z, z)).astype(np.float32)
        a[rng.random((S, z, z)) > min(0.02, 1.0 / z)] = ref.INF
        for s in range(S):
            np.fill_diagonal(a[s], 0.0)
        adj = torch.from_numpy(a).to(dev)
        src = torch.from_numpy(rng.integers(0, z, S).astype(np.int32)).to(dev)
        D = ref.ktrop_solve_ref(adj, src, k, 3)[0]
        neg_d = D.clone()
        neg_d[1, 0, 0] = -1e37  # level 0 stays the smallest: ascending
        neg_w = adj.clone()
        flip = (neg_w < ref.INF) & (torch.rand(neg_w.shape, device=dev) < 0.3)
        neg_w[flip] *= -1.0
        cases = [("aligned", D, adj)]
        cases += [(f"offset {f}", D, offset_copy(torch, adj, f))
                  for f in (1, 2, 3, z * z)]
        cases += [("negative level", neg_d, adj),
                  ("negative weights", D, neg_w)]
        for name, d, w in cases:
            paths = {"list": 0, "dense": 0}
            check_ktrop_step(torch, d, w, ref.ktrop_relax_ref(d, w),
                             (name, z), paths)
            key = f"{name} z={z}"
            out[key] = paths
            check(paths == ({"list": S - 1, "dense": 1}
                            if name == "negative level" else
                            {"list": S, "dense": 0}),
                  ("ktrop_relax_step path", key, paths))
    return out


def check_evaluate_refusals(torch, np, rng, dev):
    """The evaluation half of the launcher raises ValueError, before any
    launch, on a grouping that has a field the kernel reads on the CPU, or
    that was made for another number of subgraphs."""
    from repro_torch.kernels import bound_dist as launcher

    S = 8
    w, n, cb, sub, phi = profile_inputs(torch, np, rng, S, 64, 100,
                                        "uniform", True, dev)
    groups = launcher.group(sub, phi, S)
    bad = [(f"{name} on the CPU",
            groups._replace(**{name: getattr(groups, name).cpu()}))
           for name in ("order", "phi_sorted", "item_off", "items")]
    bad.append(("made for S + 1", launcher.group(sub, phi, S + 1)))
    for what, wrong in bad:
        try:
            launcher.evaluate(w, n, cb, wrong)
        except ValueError:
            continue
        check(False, ("bound_dist evaluation took a grouping", what))
    torch.cuda.synchronize()


def profile_inputs(torch, np, rng, S, E, B, kind, exact, dev):
    """A sorted profile (unit weights in [0.1, 5), vfrag counts 1-8, a
    padded tail of up to E/4 entries per row: w = INF, n = 0) with its
    exclusive running count in f32, and B queries with φ up to 1.1 times
    the largest row total on subgraphs drawn uniformly ("uniform"), all on
    one ("one"), Zipf-like ("zipf") or among 1% of them ("sparse")."""
    from repro_torch.kernels.ref import INF

    w = np.sort(rng.uniform(0.1, 5.0, (S, E)).astype(np.float32), -1)
    n = rng.integers(1, 9, (S, E)).astype(np.float32)
    if exact is not True:  # fractional counts: rounded running counts
        n[:, E // 2 if exact == "half" else 0:] += np.float32(0.1)
    pad = rng.integers(0, E // 4 + 1, S)
    tail = np.arange(E)[None, :] >= (E - pad)[:, None]
    w[tail] = INF
    n[tail] = 0.0
    cb = np.concatenate([np.zeros((S, 1), np.float32),
                         np.cumsum(n, -1, dtype=np.float32)[:, :-1]], -1)
    if kind == "uniform":
        sub = rng.integers(0, S, B)
    elif kind == "one":
        sub = np.full(B, S // 3)
    elif kind == "zipf":
        sub = np.minimum(rng.zipf(1.3, B) - 1, S - 1)
    else:
        sub = rng.choice(rng.choice(S, max(1, S // 100), replace=False), B)
    phi = rng.uniform(0, 1.1 * float(n.sum(-1).max()), B).astype(np.float32)
    return [torch.from_numpy(a).to(dev) for a in
            (w, n, cb, sub.astype(np.int32), phi)]


def check_groups(torch, groups, sub, phi, S, what):
    """The kernel's grouping against ``ref.group_by_subgraph``: counts and
    offsets equal, the ids a permutation with each in its own subgraph's
    bucket (the order inside a bucket is free), φ in bucket order."""
    from repro_torch.kernels import ref

    counts, offsets, order = ref.group_by_subgraph(sub, S)
    check(torch.equal(groups.counts, counts)
          and torch.equal(groups.offsets, offsets),
          ("bound_dist grouping: counts or offsets", what))
    ids = groups.order.long()
    check(torch.equal(torch.sort(ids).values,
                      torch.arange(ids.numel(), device=ids.device)),
          ("bound_dist grouping: ids are not a permutation", what))
    check(torch.equal(sub[ids], sub[order.long()]),
          ("bound_dist grouping: an id in another bucket", what))
    check(torch.equal(groups.phi_sorted, phi[ids]),
          ("bound_dist grouping: phi out of bucket order", what))


def check_bound_dist(torch, w, n, cb, sub, phi, what):
    """``ops.bound_dist`` bitwise against ``bound_dist_seq_ref`` and within
    rtol 2e-5 of ``bound_dist_ref``, its grouping against the plain one,
    invariant under a permutation of the queries and over two launches.
    Returns (BD, ms: median of 5)."""
    from repro_torch.kernels import bound_dist as launcher
    from repro_torch.kernels import ops, ref

    S, B = w.shape[0], phi.shape[0]
    got = ops.bound_dist(w, n, cb, sub, phi)
    check(torch.equal(got, ref.bound_dist_seq_ref(w, n, cb, sub, phi)),
          ("bound_dist vs bound_dist_seq_ref", what))
    if B:
        torch.testing.assert_close(
            got, torch.cat([ref.bound_dist_ref(w, n, cb, sub[i:i + BD_CHUNK],
                                               phi[i:i + BD_CHUNK])
                            for i in range(0, B, BD_CHUNK)]),
            rtol=2e-5, atol=0.0)
    check_groups(torch, launcher.group(sub, phi, S), sub, phi, S, what)
    gen = torch.Generator(device=phi.device).manual_seed(SEED + 5)
    perm = torch.randperm(B, generator=gen, device=phi.device)
    check(torch.equal(ops.bound_dist(w, n, cb, sub[perm], phi[perm]),
                      got[perm]),
          ("bound_dist under a permutation of the queries", what))
    check(torch.equal(ops.bound_dist(w, n, cb, sub, phi), got),
          ("bound_dist over two launches", what))
    return got, cuda_ms(torch, lambda: ops.bound_dist(w, n, cb, sub, phi),
                        repeats=5)


def timed(torch, fn):
    """One CUDA-event timing of ``fn()``: (result, ms)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def phase_levels(torch, dev, cell):
    from repro_torch.kernels import ktrop, ops, ref

    step = cell.step_fn
    (S, z, _), _ = (spec.shape for spec in cell.arg_specs)
    k, iters_cap = LEVELS_K, LEVELS_ITERS
    adj = road_inputs(torch, S, 1, z, dev)[0]  # integer vfrag weights 1-100
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    src = torch.randint(0, z, (S,), generator=gen, device=dev,
                        dtype=torch.int32)
    torch.cuda.synchronize()
    log(f"[levels] {cell.name} ({cell.note}): adjacency "
        f"{adj.numel() * 4 / 2**30:.2f} GiB on the card")

    # --- the cell's own step (the main path), counted
    ops.reset_launches()
    D = step(adj, src)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    check(launches["ktrop_solve"] == 1, ("levels launches", launches))
    check(tuple(D.shape) == (S, k, z), "levels output shape")

    # --- the fused solve: iterations, time, the plain fixed point
    D2, iters, used = ktrop.solve(adj, src, k, iters_cap)
    check(torch.equal(D, D2), "levels: the step and the launcher differ")
    check(bool(used.all()), ("levels rows ran the dense loop",
                             int(used.numel() - used.sum())))
    solve_ms = cuda_ms(torch, lambda: step(adj, src), repeats=5)
    fixed_ms = cuda_ms(torch, lambda: ktrop.solve(adj, src, k, 0), repeats=5)
    (want_d, want_it), solve_plain_ms = timed(torch, lambda: chunked(
        torch, lambda a, s: ref.ktrop_solve_ref(a, s, k, iters_cap), S,
        adj, src))
    check(torch.equal(D, want_d), "ktrop_solve differs from plain")
    check(torch.equal(iters, want_it), "ktrop_solve iterations differ")
    it = iters.double()
    finite = (D < ref.INF).double().sum(dim=1)  # levels found per vertex
    adj_bytes = adj.numel() * 4
    n_d = S * k * z
    # operations this data needs per row and relaxation: a (u, v) pair with
    # no edge costs one add and one compare (the early exit), an edge at
    # most k of each
    nnz = (adj < ref.INF).sum(dim=(1, 2)).double()
    row_ops = 2.0 * (z * z + k * nnz)  # the step's dense scan
    # the solve folds each row's in-edges only: at most k add+compare
    # pairs per finite entry and relaxation
    solve_bound, solve_by = bound_ms(
        adj_bytes + S * 4 + n_d * 4 + S * 4,
        float((2.0 * k * nnz * iters.double()).sum()))
    log(f"[levels] ktrop_solve: {solve_ms:.3f} ms (median of 5), plain "
        f"{solve_plain_ms:.1f} ms (in {PLAIN_CHUNK}-row chunks), bound "
        f"{solve_bound:.3f} ms ({solve_by}); iterations per row max "
        f"{int(it.max())} mean {float(it.mean()):.2f} (cap {iters_cap}); "
        f"levels found per vertex mean {float(finite.mean()):.2f}; finite "
        f"adjacency entries per row mean {float(nnz.mean()):.1f} of {z * z}; "
        f"in-edge list on {int(used.sum())} of {S} rows "
        f"({ktrop.solve_smem(k, z)} B of shared memory per block, "
        f"{ktrop.solve_blocks_per_sm(k, z)} blocks per SM); with "
        f"max_iters=0 (D0, list build, store) {fixed_ms:.3f} ms; D and "
        f"iterations bitwise equal to plain on all {S} rows")

    # --- one relaxation from a mid-relaxation state (ktrop_relax_step);
    # D >= 0 and every column within the slots: the list path is timed
    Dm = ops.ktrop_solve(adj, src, k, 8)
    slots = ktrop.step_layout(k, z)[0]
    check(bool(ktrop_step_path(torch, Dm, adj, slots).all()),
          "levels step inputs fail the list path's checks")
    _, step_path = ktrop.relax_step(Dm, adj, with_path=True)
    check(bool(step_path.all()), "levels step rows ran dense")
    step_ms = cuda_ms(torch, lambda: ops.ktrop_relax_step(Dm, adj), repeats=7)
    got = ops.ktrop_relax_step(Dm, adj)
    want, step_plain_ms = timed(
        torch, lambda: chunked(torch, ref.ktrop_relax_ref, S, Dm, adj))
    check(torch.equal(got, want), "ktrop_relax_step differs at levels")
    step_bytes = adj_bytes + 2 * n_d * 4
    step_bound, step_by = bound_ms(step_bytes, float(row_ops.sum()))
    log(f"[levels] ktrop_relax_step: {step_ms:.3f} ms (median of 7), "
        f"{step_bytes / step_ms / 1e6:.0f} GB/s of the {step_bytes / 1e9:.3f} "
        f"GB it must move, plain {step_plain_ms:.1f} ms, bound "
        f"{step_bound:.3f} ms ({step_by}); every row on its in-edge list "
        f"({ktrop.step_smem(k, z)} B of shared memory per block, "
        f"{ktrop.step_blocks_per_sm(k, z)} blocks per SM); bitwise equal on "
        f"all {S} rows")
    return launches, {
        "ktrop_relax_step": dict(ms=step_ms, plain_ms=step_plain_ms,
                                 bound_ms=step_bound, bound_by=step_by,
                                 max_abs_err=max_abs_err(torch, got, want)),
        "ktrop_solve": dict(ms=solve_ms, plain_ms=solve_plain_ms,
                            bound_ms=solve_bound, bound_by=solve_by,
                            max_abs_err=max_abs_err(torch, D, want_d),
                            list_blocks=int(used.sum()),
                            dense_blocks=int(used.numel() - used.sum())),
    }


def maintain_inputs(torch, S, E, B, dev):
    """A maintain-sized profile made on the card from a seed: per
    subgraph 1,024-2,048 real edges with unit weights in [0.5, 1.5) and
    vfrag counts 1-16, the rest padding (w = INF, n = 0), unsorted; B
    bounding paths on uniform subgraphs with integer φ ≤ the total
    fragments of their own subgraph."""
    from repro_torch.kernels.ref import INF

    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    unit_w = 0.5 + torch.rand((S, E), generator=gen, device=dev)
    unit_n = torch.randint(1, 17, (S, E), generator=gen, device=dev).float()
    n_real = torch.randint(E // 2, E + 1, (S, 1), generator=gen, device=dev)
    pad = torch.rand((S, E), generator=gen, device=dev).argsort(dim=1) \
        >= n_real  # a random set of E - n_real padded slots per row
    unit_w.masked_fill_(pad, INF)
    unit_n.masked_fill_(pad, 0.0)
    sub = torch.randint(0, S, (B,), generator=gen, device=dev,
                        dtype=torch.int32)
    total = unit_n.sum(dim=1)
    phi = torch.floor(torch.rand((B,), generator=gen, device=dev)
                      * (total[sub.long()] + 1.0)).clamp_(max=total[sub.long()])
    return unit_w, unit_n, sub, phi


def bound_dist_need(torch, cb, sub, phi):
    """What ``bound_dist`` must move and compute on this run's data:
    (bytes, operations).  A query sums its terms up to its stop k (the
    first e with cum_before[e] >= φ, else E), so a subgraph's row is needed
    up to the largest stop of its queries: w and n below it, cum_before up
    to it (the stop test), 12 bytes per entry at most; rows without a
    query are not needed.  Each query reads sub and φ and writes BD (12
    bytes) and does 5 operations per term (subtract, min, multiply, add
    and the stop test)."""
    S, E = cb.shape
    sub_l = sub.long()
    stop = torch.empty_like(sub_l)
    for i in range(0, sub_l.numel(), BD_CHUNK):
        ge = cb[sub_l[i:i + BD_CHUNK]] >= phi[i:i + BD_CHUNK, None]
        stop[i:i + BD_CHUNK] = torch.where(ge.any(dim=1),
                                           ge.int().argmax(dim=1), E)
    row = torch.zeros(S, dtype=torch.long, device=cb.device).scatter_reduce_(
        0, sub_l, stop, "amax")
    has = torch.bincount(sub_l, minlength=S) > 0
    row_bytes = (8 * row + 4 * torch.clamp(row + 1, max=E)) * has
    return (float(row_bytes.sum()) + 12.0 * sub.numel(),
            5.0 * float(stop.sum()))


def phase_maintain(torch, dev, cell):
    from repro_torch.engine import dense
    from repro_torch.kernels import bound_dist as launcher
    from repro_torch.kernels import ops, ref

    step = cell.step_fn
    (S, E), _, (B,), _ = (spec.shape for spec in cell.arg_specs)
    unit_w, unit_n, sub, phi = maintain_inputs(torch, S, E, B, dev)
    torch.cuda.synchronize()
    log(f"[maintain] {cell.name} ({cell.note}): profile "
        f"{unit_w.numel() * 4 / 1e9:.3f} GB per [S,E] array")

    # --- the cell's own step (the main path), counted
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    bd = step(unit_w, unit_n, sub, phi)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    check(launches["bound_dist"] == 1, ("maintain launches", launches))
    check(tuple(bd.shape) == (B,) and bool(torch.isfinite(bd).all()),
          "maintain output is not [B] and finite")
    step_ms = cuda_ms(torch, lambda: step(unit_w, unit_n, sub, phi),
                      repeats=3)

    # --- the profile the step sorts, and the kernel on it alone
    (w_s, n_s, cum_n), sort_ms = timed(
        torch, lambda: dense.sort_profile(unit_w, unit_n))
    cb = cum_n.sub_(n_s)
    got = ops.bound_dist(w_s, n_s, cb, sub, phi)
    check(torch.equal(got, bd), "maintain: the step and the kernel differ")
    kernel_ms = cuda_ms(torch, lambda: ops.bound_dist(w_s, n_s, cb, sub, phi),
                        repeats=5)
    # its two parts: the grouping on the card, then the evaluation
    groups = launcher.group(sub, phi, S)
    check_groups(torch, groups, sub, phi, S, "maintain")
    check(torch.equal(launcher.evaluate(w_s, n_s, cb, groups), got),
          "maintain: the evaluation alone differs")
    group_ms = cuda_ms(torch, lambda: launcher.group(sub, phi, S), repeats=5)
    eval_ms = cuda_ms(torch, lambda: launcher.evaluate(w_s, n_s, cb, groups),
                      repeats=5)
    del groups
    # the same sum in the kernel's order, bit for bit, on the first chunk
    q = slice(0, BD_CHUNK)
    check(torch.equal(got[q], ref.bound_dist_seq_ref(w_s, n_s, cb, sub[q],
                                                     phi[q])),
          "maintain: bound_dist differs from bound_dist_seq_ref")
    # the loop form at this shape: running counts shifted by 0.5 past the
    # first entry are not exact, so every row runs the per-query loop from
    # its first segment on; on integer φ each query stops where it stops
    # on cb, so it sums as many terms
    cb_loop = cb + 0.5
    cb_loop[:, 0] = cb[:, 0]
    got_loop = ops.bound_dist(w_s, n_s, cb_loop, sub, phi)
    check(torch.equal(got_loop[q], ref.bound_dist_seq_ref(
              w_s, n_s, cb_loop, sub[q], phi[q])),
          "maintain: the loop form differs from bound_dist_seq_ref")
    loop_ms = cuda_ms(torch, lambda: ops.bound_dist(w_s, n_s, cb_loop, sub,
                                                    phi), repeats=5)
    del got_loop, cb_loop
    # the queries in another order, and a second launch
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    perm = torch.randperm(B, generator=gen, device=dev)
    check(torch.equal(ops.bound_dist(w_s, n_s, cb, sub[perm], phi[perm]),
                      got[perm]),
          "maintain: bound_dist under a permutation of the queries")
    del perm
    check(torch.equal(ops.bound_dist(w_s, n_s, cb, sub, phi), got),
          "maintain: bound_dist over two launches")
    want_ref, ref_ms = timed(torch, lambda: torch.cat([
        ref.bound_dist_ref(w_s, n_s, cb, sub[i:i + BD_CHUNK],
                           phi[i:i + BD_CHUNK])
        for i in range(0, B, BD_CHUNK)]))
    torch.testing.assert_close(got, want_ref, rtol=2e-5, atol=0.0)
    want, plain_ms = timed(torch, lambda: torch.cat([
        dense.bound_dist_batch(unit_w, unit_n, sub[i:i + BD_CHUNK],
                               phi[i:i + BD_CHUNK])
        for i in range(0, B, BD_CHUNK)]))
    rel = ((got.double() - want.double()).abs()
           / want.double().abs().clamp(min=1e-30))
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-3)
    # a third opinion: the clip-sum in float64 on the first chunk
    sq = sub[q].long()
    take = torch.minimum((phi[q].double()[:, None] - cb[sq].double())
                         .clamp(min=0.0), n_s[sq].double())
    f64 = (torch.where(n_s[sq] > 0, w_s[sq].double(), 0.0) * take).sum(dim=1)

    def rel64(x):
        return float(((x[q].double() - f64).abs()
                      / f64.abs().clamp(min=1e-30)).max())

    need_bytes, need_ops = bound_dist_need(torch, cb, sub, phi)
    kb, kby = bound_ms(need_bytes, need_ops)
    whole_ms, _ = bound_ms(3 * S * E * 4 + B * 12, 0.0)
    log(f"[maintain] step (sort + bound_dist) {step_ms:.3f} ms (median of "
        f"3), peak {peak / 1e9:.2f} GB allocated; profile sort "
        f"{sort_ms:.3f} ms; bound_dist {kernel_ms:.3f} ms (median of 5): "
        f"grouping {group_ms:.3f} ms, evaluation {eval_ms:.3f} ms; the "
        f"per-query loop form on this shape (counts not exact) "
        f"{loop_ms:.3f} ms (median of 5); bound {kb:.3f} ms ({kby}: "
        f"{need_bytes / 1e9:.3f} GB and {need_ops:.4g} operations this "
        f"data needs; the whole profile {whole_ms:.3f} ms); plain "
        f"bound_dist_ref {ref_ms:.1f} ms, plain "
        f"dense.bound_dist_batch {plain_ms:.1f} ms (in chunks of "
        f"{BD_CHUNK}); bitwise equal to bound_dist_seq_ref on {BD_CHUNK} "
        f"queries, to itself under a permutation of all {B} queries and over "
        f"two launches; grouping equal to group_by_subgraph; largest "
        f"relative error vs bound_dist_batch {float(rel.max()):.3e}; vs a "
        f"float64 clip-sum on {BD_CHUNK} queries: kernel {rel64(got):.3e}, "
        f"bound_dist_batch {rel64(want):.3e}, bound_dist_ref "
        f"{rel64(want_ref):.3e}")
    return launches, {
        "bound_dist": dict(ms=kernel_ms, plain_ms=ref_ms, bound_ms=kb,
                           bound_by=kby,
                           max_abs_err=max_abs_err(torch, got, want_ref),
                           group_ms=group_ms, eval_ms=eval_ms,
                           loop_form_ms=loop_ms, need_bytes=need_bytes,
                           need_ops=need_ops, whole_profile_bound_ms=whole_ms,
                           sort_ms=sort_ms, step_ms=step_ms,
                           step_peak_gb=peak / 1e9),
    }


def phase_kspdg_smoke():
    from repro_torch.configs.base import get_arch

    out = get_arch("kspdg").smoke_fn(device="cuda")
    check(out == {"engine_ksp_checked": 6}, ("kspdg_smoke", out))
    log(f"[kspdg_smoke] engine_ksp on the card equals host Yen: {out}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is "
              "False); nothing was run", file=sys.stderr)
        return 1
    import numpy as np

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)} "
        f"x{torch.cuda.device_count()}; nvidia-smi: {smi}")
    t_start = time.perf_counter()

    phase_build()
    from repro_torch.configs.base import get_arch

    cells = {cell.shape: cell for cell in get_arch("kspdg").cells()}
    phase_ragged(torch, np, dev)
    timings = phase_refine_dense(torch, dev, cells["refine_dense"])
    timings["bf_solve_grouped"]["serving_shape_ms"] = phase_serving_shape(
        torch, dev)
    launches = phase_serving(torch, np)
    bound_dist_cases = phase_ragged_index(torch, np, dev)
    torch.cuda.empty_cache()
    for path, shape in ((phase_levels, "levels"),
                        (phase_maintain, "maintain")):
        path_launches, path_timings = path(torch, dev, cells[shape])
        timings.update(path_timings)
        launches = {name: launches.get(name, 0) + n
                    for name, n in path_launches.items()}
        torch.cuda.empty_cache()
    timings["bound_dist"]["cases_ms"] = bound_dist_cases
    phase_kspdg_smoke()

    sources = {  # kernel -> (CUDA source, the TPU kernel it replaces)
        "bf_relax_step": ("bf_relax.cu", "src/repro/kernels/bf_relax.py:69"),
        "bf_solve_grouped": ("bf_relax.cu",
                             "src/repro/kernels/bf_relax.py:69"),
        "ktrop_relax_step": ("ktrop.cu", "src/repro/kernels/ktrop.py:56"),
        "ktrop_solve": ("ktrop.cu", "src/repro/kernels/ktrop.py:56"),
        "bound_dist": ("bound_dist.cu",
                       "src/repro/kernels/bound_dist.py:36"),
    }
    check(launches["ktrop_solve"] > 0 and launches["bound_dist"] > 0,
          ("the index cells did not launch their kernels", launches))
    kernels = [
        dict(name=name, route="cuda", source=f"src/repro_torch/csrc/{src}",
             replaces=replaces, launches=launches[name], library_ms=None,
             **timings[name])
        for name, (src, replaces) in sources.items()
    ]
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
