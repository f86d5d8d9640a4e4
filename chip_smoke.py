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
   weights, +inf distances), here also at the serving slab shapes
   (S=64, z=96, J in {8, 32}); ``bf_solve_grouped`` on inputs that fail
   its checks (+inf distances under caps of +inf, an initial distance
   or an edge weight of -1e37, a NaN cap), dense where they fail;
4. the fused solve at the refine_dense shape (S=8192 slab rows, z=256,
   J=32) on road-like adjacency with Yen-style masks and finite caps:
   both kernels against their plain versions on every row, bitwise, and
   timed with CUDA events beside their bounds, every block on its list;
   the refine_dense cell's step (capped at 64 iterations) gives the same
   bytes, and the epilogue (``max_iters=0``) returns the converged field
   and its parents unchanged; then the fused solve at the serving slab shape (S=64, z=96,
   J in {8, 32}), bitwise and timed, and there also ``bf_relax_step``
   and the parent epilogue (``max_iters=0``) bitwise against their plain
   versions;
5. the index build: the 64x64 road grid's DTLP index (z=32, xi=4, the
   city-open network) built on the card, one ``ktrop_solve`` and one
   ``level_walks`` launch, every boundary source and walk batched; then
   ``level_walks`` on the build's own inputs bitwise against its plain
   version, and timed;
   serving: ``KSPService(engine="cuda_bf", device="cuda")`` answers 32
   queries (trips of 8-16 hops), one UpdateBatch, and 32 more on a
   64x64 road grid; the same trace on the port's plain ``dense_bf``
   engine must give the same (paths, epoch), a few answers must match
   host Yen on the full graph, and the serving run must have launched
   ``bf_solve_grouped`` (each service serves its own copy of that
   index);
   then the multi-device path: ``shard_refine.make_refine_fn`` with
   ``CudaBackend`` at the refine_dense shape on a 1-shard mesh of the
   card and on 2 logical shards of it, bitwise the fused solve, one
   ``bf_solve_grouped`` launch per shard and no ``bf_relax_step``, its
   wall time beside the fused solve's; the same trace served on
   ``cuda_bf`` over a 1-shard mesh, barrier and streaming, equal to the
   non-mesh answers, launching ``bf_solve_grouped`` only; and the driver
   ``python -m repro_torch.launch.serve --engine cuda_bf --mesh`` (a
   10x10 grid, a worker killed and revived) ending in "serving run
   complete" with no EMPTY line;
6. index kernels at ragged shapes: ``ktrop_relax_step`` and
   ``ktrop_solve`` bitwise against their plain versions at z in
   {1, 33, 96, 200, 256}, densities 30% and 2%, k in {1, 2, 10, 16}, and
   both at z=1000, 30% (over the list's budget, dense) and 0.4%, with
   their path reports checked as in 3; ``ktrop_solve`` with an edge
   weight of -1e37 (its row dense); ``ktrop_relax_step`` also on
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
   evaluation timed; then ``kspdg_smoke(device="cuda")``;
9. LM serving (plain PyTorch: this path reaches no TPU kernel):
   starcoder2-3b at full width and depth from a seeded generator, a
   128-token prompt decoded one token per step against the full forward
   (``lm_backbone`` + unembed) within 8e-2 on the logits, 12 requests
   (prompts of 16-128 tokens, 32 new each) through ``DecodeServer`` with
   8 slots and max_len 4096 (every token greedy given its prefix), the
   B=8 decode step timed beside its weight-read bound; gemma3-27b at full
   width cut to 6 layers, 1,100 positions through the mixed per-layer
   cache and the stacked cache, within 5e-2 of each other; one train and
   decode step of the moonshot (MoE) and deepseek-v3 (MoE, MLA, MTP)
   smoke configs;
10. training (plain PyTorch: this path reaches no TPU kernel either),
   every family at its published widths and depths from seeded
   generators, every input made with numpy through
   ``repro_torch.data.pipeline``: gin-tu on a Cora-sized graph (2,708
   nodes, 10,556 directed edges, 1,433 features), dimenet on
   ``molecule_batch(128, 30, 64)`` with its triplets, graphsage-reddit on
   five fresh ``NeighborSampler`` blocks (1,024 seeds, fanouts 15-10) of a
   232,965-node host graph with Reddit's 114,615,892 directed edges, and
   meshgraphnet on one such block, both padded to the minibatch_lg cell
   (169,984 nodes, 168,960 edges): 5 AdamW steps each; BST at
   ``bst_arch.CFG`` (10M x 32 item table, 1M x 32 profile table) on
   65,536 ``ClickStream`` examples: 3 dense AdamW steps over every
   parameter and 3 ``bst_sparse_train_step``s, then ``bst_serve`` at 512
   examples and ``bst_retrieval`` over 1,000,000 candidates.  Each
   case's first step's loss and gradient norm within rtol 1e-4 of the
   port's own CPU run of the same step (meshgraphnet on a 128-seed block,
   BST on the first 4,096 examples), serve probabilities within 1e-5 of
   the CPU's, every loss finite, the loss after the last step below the
   first where a case repeats its batch; the sparse steps leave every
   untouched row bit-identical and move every row of the first batch;
   each case prints a ``[training]`` line with its median step ms (CUDA
   events) and peak memory, and meshgraphnet's and BST's steps are traced
   by ``torch.profiler`` (kernels per step, the device's busy share,
   kernel time by category).  Then ``python -m repro_torch.launch.train
   --arch gin-tu --steps 10 --ckpt-every 5`` and the same with
   ``--resume --steps 15`` (which must print "resumed from step 10" and
   "done: 15 steps"), and ``examples/torch_train_lm_resume.py`` on the
   card (the resumed run equal to the uninterrupted one within rtol
   1e-5);
11. dry-run: ``python -m repro_torch.launch.dryrun --all --mesh all``
   (every registered cell's own step traced on the meta device and
   costed in H100 terms, the TPU meshes' per-device argument bytes) runs
   in the background and must end in "done: 123 ok, 9 skipped
   (documented), 0 errors", with the card's name and power limit in
   every traced record; meanwhile 11 cells run at full shape through
   their own ``step_fn`` (refine_dense, levels, maintain, gin-tu
   full_graph_sm, dimenet molecule, graphsage-reddit and meshgraphnet
   minibatch_lg, BST train_batch, serve_p99 and retrieval_cand,
   starcoder2-3b decode_32k at B=128 on its 4,096-slot ring): each
   traced argument + temporary peak within 15% of the measured peak,
   each median step not under the traced memory time of its ops that
   overflow the L2 nor, outside kspdg, under the traced compute time;
   then both hill-climbs (``launch.hillclimb_gemma``,
   ``launch.hillclimb_bst``) measure their variants beside the traced
   ratios.  The kernels' bounds charge min-plus operations at the H100's
   FADD/FMNMX issue rate (``repro_torch.launch.roofline``).

It imports nothing of JAX or of the reference package.  Without a card
it exits non-zero and prints no result.  The last three lines are the
kernels JSON, the nvidia-smi name/power-limit line, and the ok JSON.
"""

from __future__ import annotations

import json
import os
import pickle
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

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
    """The least time of a kernel that moves ``n_bytes`` and issues
    ``n_ops`` min-plus operations (float32 adds and min/max, one issue
    slot each), at the H100 data sheet's HBM rate and FADD/FMNMX issue
    rate (``repro_torch.launch.roofline``)."""
    from repro_torch.launch.roofline import HBM_BW, MINPLUS_OPS

    t_bytes = n_bytes / HBM_BW
    t_ops = n_ops / MINPLUS_OPS
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


def solve_path(torch, adj, slots, init=None, banned_v=None, cap=None,
               jt=None):
    """The loop each fused-solve block must run: its in-edge list (1)
    where every column of the row is within the list's slots and every
    kept weight is >= 0 and, for BF (``init`` given; blocks of ``jt``
    problems), every initial distance after the banned-vertex mask is
    >= 0 and every cap <= INF (no NaN); else the dense loop (0).  BF
    [S, ceil(J/jt)], ktrop [S]."""
    from repro_torch.kernels.ref import INF

    ok = list_expected(torch, adj, slots) & ~(
        (adj < INF) & (adj < 0)).flatten(1).any(dim=1)
    if init is None:
        return ok.int()
    d0 = torch.where(banned_v, INF, init)
    good = (d0 >= 0).all(dim=2) & (cap <= INF)
    J = init.shape[1]
    return torch.stack([good[:, j0:j0 + jt].all(dim=1) & ok
                        for j0 in range(0, J, jt)], dim=1).int()


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


def bf_step_ops(torch, adj, path, J, jt):
    """Operations one ``bf_relax_step`` needs on this data: per block of
    jn problems, 2·jn·nnz(adj[s]) add+min where it relaxes its in-edge
    list (``path`` 1), 2·jn·z² where it scans every entry (0)."""
    from repro_torch.kernels.ref import INF

    z = adj.shape[-1]
    nnz = (adj < INF).sum(dim=(1, 2)).double()
    jn = torch.tensor([min(jt, J - t) for t in range(0, J, jt)],
                      dtype=torch.float64, device=adj.device)
    per_row = torch.where(path.bool(), nnz[:, None], float(z * z))
    return float((2.0 * per_row * jn[None, :]).sum())


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
            check(torch.equal(used, solve_path(torch, adj, slots, init, bv,
                                               cap, jt)),
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
    cases = bf_solve_cases(torch, np, rng, dev)
    torch.cuda.synchronize()
    log(f"[ragged] bf_solve_grouped (dist, parents and iterations per row) "
        f"bitwise equal to plain, with the loop each block must run, on "
        f"inputs that fail the list's checks: " + "; ".join(
            f"{name} {loops}" for name, loops in cases.items()))


def bf_solve_cases(torch, np, rng, dev):
    """``bf_solve_grouped`` on list rows (density 2%, or 1/z where lower)
    with one of the list's preconditions broken: every INF initial
    distance +inf under caps of +inf (every block dense, by its cap
    check); one initial distance of -1e37 (its block dense); one edge
    weight of -1e37 out of a source (its row's blocks dense: a negative
    distance mid-solve makes d + INF < INF); a NaN cap (its block dense).
    Bitwise against the plain solve, with the loop each block must run.
    Returns the loops by case."""
    from repro_torch.kernels import _build, bf_relax, ref

    out = {}
    for S, J, z in ((2, 3, 24), (2, 33, 97), (3, 8, 256)):
        args = [torch.from_numpy(a).to(dev) for a in ragged_inputs(
            np, rng, S, J, z, True, min(0.02, 1.0 / z))]
        adj, init, bv, so, bn, cap = args
        jt = bf_relax.tile_width(J, z, bf_relax.solve_smem)
        slots = _build.edge_list_slots(bf_relax.tile_smem(jt, z), z)
        inf_d, inf_cap = init.clone(), cap.clone()
        inf_d[inf_d >= ref.INF] = float("inf")
        inf_cap[:] = float("inf")
        neg_d, no_bv = init.clone(), bv.clone()
        neg_d[1, 0, 1] = -1e37
        no_bv[1, 0, 1] = False
        neg_w = adj.clone()
        src = int(init[1, 0].argmin())  # the closest vertex: a source
        neg_w[1, src, (src + 1) % z] = -1e37
        nan_cap = cap.clone()
        nan_cap[0, J - 1] = float("nan")
        cases = [("+inf distances, cap +inf", adj, inf_d, bv, inf_cap),
                 ("-1e37 distance", adj, neg_d, no_bv, cap),
                 ("-1e37 weight", neg_w, init, bv, cap),
                 ("NaN cap", adj, init, bv, nan_cap)]
        for name, a, d0, b, c in cases:
            full = (a, d0, b, so, bn, c)
            d, p, it, used = bf_relax.solve_grouped(*full)
            wd, wp, wit = ref.bf_solve_grouped_ref(*full, with_iters=True)
            key = f"{name} (S,J,z)={(S, J, z)}"
            check(torch.equal(d, wd) and torch.equal(p, wp)
                  and torch.equal(it.amax(dim=1), wit),
                  ("bf_solve_grouped", key))
            want = solve_path(torch, a, slots, d0, b, c, jt)
            check(torch.equal(used, want) and not bool(want.all()),
                  ("bf_solve_grouped loop report", key, used.tolist()))
            n_list = int(used.sum())
            out[key] = {"list": n_list, "dense": used.numel() - n_list}
    return out


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
    for S, J, z in ((2, 33, 97), (3, 8, 256), (2, 5, 1000), (64, 8, 96),
                    (64, 32, 96)):
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
    step_bound, step_by = bound_ms(
        step_bytes, bf_step_ops(torch, adj, step_path, J, step_jt))
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
    d0, p0 = ops.bf_solve_grouped(adj, dist, bv, so, bn, cap, max_iters=0)
    check(torch.equal(d0, dist) and torch.equal(p0, parent),
          "max_iters=0 changed a converged field or its parents")
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
        f"max_iters=0 (loads, list build, epilogue) {fixed_ms:.3f} ms, "
        f"the converged field and its parents unchanged by it; dist, "
        f"parents and iterations per row bitwise equal to plain on all "
        f"{S} rows, and to the refine_dense cell's step")
    return {
        "bf_relax_step": dict(ms=step_ms, plain_ms=step_plain_ms,
                              bound_ms=step_bound, bound_by=step_by,
                              max_abs_err=step_err),
        "bf_solve_grouped": dict(ms=solve_ms, plain_ms=solve_plain_ms,
                                 bound_ms=solve_bound, bound_by=solve_by,
                                 epilogue_ms=fixed_ms,
                                 max_abs_err=max_abs_err(torch, dist, want_d),
                                 list_blocks=int(used.sum()),
                                 dense_blocks=int(used.numel() - used.sum())),
    }


def phase_serving_shape(torch, dev):
    """``bf_solve_grouped`` at the serving slab shape (S=64 rows, z=96) on
    road-like rows, J in {8, 32}: bitwise against the plain version and
    timed (median of 21 CUDA-event timings of one launch).  At the same
    shapes, ``bf_relax_step`` (bitwise against the plain step, on its
    list path) and the parent epilogue
    ``bf_solve_grouped(..., max_iters=0)`` (bitwise against its
    plain version on a field 3 relaxations in and on the converged field,
    where it returns that field and its parents unchanged)."""
    from repro_torch.kernels import bf_relax, ops, ref

    times = {}
    for J in (8, 32):
        args = road_inputs(torch, 64, J, 96, dev)
        adj, init, bv, so, bn, cap = args
        d, p, it, used = bf_relax.solve_grouped(*args)
        wd, wp, wit = ref.bf_solve_grouped_ref(*args, with_iters=True)
        check(torch.equal(d, wd) and torch.equal(p, wp)
              and torch.equal(it.amax(dim=1), wit),
              ("bf_solve_grouped at the serving shape", J))
        check(bool(used.all()), ("serving-shape blocks ran the dense loop", J))
        step_paths = {"list": 0, "dense": 0}
        check_bf_step(torch, init, adj, so, bn, cap,
                      ref.bf_relax_ref(init, adj, so, bn, cap),
                      ("serving shape", J), step_paths)
        check(step_paths["dense"] == 0,
              ("serving-shape step blocks ran dense", J, step_paths))
        mid = ref.bf_solve_grouped_ref(*args, max_iters=3)[0]
        for name, field in (("mid-solve", mid), ("converged", wd)):
            ed, ep = ops.bf_solve_grouped(adj, field, bv, so, bn, cap,
                                          max_iters=0)
            pd, pp = ref.bf_solve_grouped_ref(adj, field, bv, so, bn, cap,
                                              max_iters=0)
            check(torch.equal(ed, pd) and torch.equal(ep, pp),
                  ("max_iters=0 differs from plain", name, J))
        check(torch.equal(ed, wd) and torch.equal(ep, wp),
              ("max_iters=0 changed a converged field or its parents", J))
        ms = cuda_ms(torch, lambda: ops.bf_solve_grouped(*args), repeats=21)
        times[f"S64_J{J}_z96"] = ms
        log(f"[serving-shape] bf_solve_grouped S=64 J={J} z=96: {ms:.4f} ms "
            f"(median of 21), {bf_relax.solve_blocks_per_sm(J, 96)} blocks "
            f"per SM, iterations per block max {int(it.max())}, "
            f"in-edge list on all {used.numel()} blocks, bitwise equal to "
            f"plain; bf_relax_step bitwise equal to plain with its "
            f"{step_paths['list']} blocks on the list; the epilogue "
            f"(max_iters=0) bitwise equal to plain on a field 3 relaxations "
            f"in and on the converged field, the converged one unchanged")
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


_INDEX = {}


def phase_index_build(torch, np):
    """The 64x64 road grid's DTLP index (z=32, xi=4: city-open's network)
    built on the card, as ``KSPService.build`` builds it there.  The
    launch counts are set to 0 just before the build and read just after:
    one ``ktrop_solve`` and one ``level_walks``, every boundary source and
    every walk batched (``host_sources`` 0).  Then ``level_walks`` on the
    build's own inputs against ``ref.level_walks_ref`` on the card, every
    length and every vertex and edge id of a walk equal, and timed beside
    its bound.  The index is kept for the serving phases."""
    from repro_torch.core.dtlp import DTLP
    from repro_torch.data.roadnet import grid_road_network
    from repro_torch.kernels import ops, ref

    calls = []
    launch = ops.level_walks

    def recording(*args):
        calls.append(args)
        return launch(*args)

    g = grid_road_network(64, 64, seed=SEED)
    ops.level_walks = recording
    try:
        ops.reset_launches()
        t0 = time.perf_counter()
        d = DTLP.build(g, z=32, xi=4, device="cuda")
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)
    finally:
        ops.level_walks = launch
    st = d.stats
    n_src = sum(int(sg.boundary_local.shape[0])
                for sg in d.partition.subgraphs)
    check(launches["ktrop_solve"] == 1 and launches["level_walks"] == 1
          and len(calls) == 1, ("index build launches", launches))
    (args,) = calls
    D, W = args[0], args[9].shape[0]
    check((st.device_sources, st.host_sources, st.device_walks)
          == (n_src, 0, W), ("index build counts", st))
    _INDEX["build_s"] = build_s
    _INDEX["bytes"] = pickle.dumps(d, protocol=pickle.HIGHEST_PROTOCOL)

    want, plain_ms = timed(torch, lambda: ref.level_walks_ref(*args))
    got = ops.level_walks(*args)
    torch.cuda.synchronize()
    col = torch.arange(D.shape[2], device=D.device)
    n = want[2].long()[:, None]
    errs = [max_abs_err(torch, got[2], want[2])] + [
        max_abs_err(torch, a[mask], b[mask]) if bool(mask.any()) else 0.0
        for a, b, mask in ((got[0], want[0], col < n),
                           (got[1], want[1], col < n - 1))]
    check(max(errs) == 0.0, ("level_walks differs from plain", errs))
    check(st.simple_walks == int((want[2] > 0).sum()),
          ("simple walks", st.simple_walks))
    ms = cuda_ms(torch, lambda: ops.level_walks(*args), repeats=7)
    # inputs read once, each vertex and edge id of a simple walk and
    # every length written once
    n_bytes = (sum(t.numel() * t.element_size() for t in args)
               + 8 * int(want[2].sum()) + 4 * W)
    kb, kby = bound_ms(n_bytes, 0.0)
    S, k, z = D.shape
    log(f"[index] DTLP build of the 64x64 grid on the card: {build_s:.2f} s "
        f"(bounding {st.bounding_s:.2f} s); {st.device_sources} sources and "
        f"{st.device_walks} walks batched ({st.simple_walks} simple), "
        f"{st.host_sources} on the host; launches {launches}; level_walks "
        f"(S={S} k={k} z={z}, {W} walks, {args[5].shape[0]} in-edges) "
        f"{ms:.3f} ms (median of 7), plain {plain_ms:.1f} ms, bound "
        f"{kb:.4f} ms ({kby}); every walk equal to plain")
    return launches, {"level_walks": dict(
        ms=ms, plain_ms=plain_ms, bound_ms=kb, bound_by=kby,
        max_abs_err=max(errs), walks=W, shape=[S, k, z])}


def build_service(engine, mesh=None, update_mode="barrier"):
    """A fresh copy of the 64x64 road grid's DTLP index, as
    :func:`phase_index_build` built it on the card, and a 4-worker
    service on the card (on ``mesh`` if given).  Each service gets its
    own copy, unpickled from the bytes of the build, since serving an
    update changes the index."""
    from repro_torch.service import KSPService, ServiceConfig

    check(_INDEX, "the serving phases need phase_index_build's index")
    d = pickle.loads(_INDEX["bytes"])
    svc = KSPService(d, ServiceConfig(engine=engine, n_workers=4,
                                      device="cuda", max_in_flight=8,
                                      mesh=mesh, update_mode=update_mode))
    return svc, _INDEX["build_s"], d.graph


def serving_trace(np):
    """The serving trace: 64 trips of 8-16 hops on the 64x64 grid and one
    traffic update, 5% of the edges moving by up to +-50% of their
    initial weight.  (At the stream's default of 50% of the edges the
    DTLP bounds drift so far that some queries need hundreds of KSP-DG
    iterations of host work; ROADMAP queue 1, item 11.)"""
    from repro_torch.data.roadnet import WeightUpdateStream, grid_road_network

    g0 = grid_road_network(64, 64, seed=SEED)
    queries = local_trips(np, g0, 64, np.random.default_rng(SEED))
    batch = WeightUpdateStream(g0, alpha=0.05, tau=0.5,
                               seed=SEED).next_batch()
    return g0, queries, batch


def serve(torch, engine, queries, batch, mesh=None,
          update_mode="barrier", label=None):
    """Serve 32 queries, the update, 32 queries; the launch counts are
    set to 0 just before and read just after.  Returns (service,
    [(paths, epoch)], launches)."""
    from repro_torch.kernels import ops
    from repro_torch.service import QueryRequest, UpdateBatch

    svc, build_s, g = build_service(engine, mesh, update_mode)
    ops.reset_launches()
    t0 = time.perf_counter()
    tickets = svc.replay([QueryRequest(s, t, 3) for s, t in queries[:32]])
    svc.update(UpdateBatch(*batch))
    tickets += svc.replay([QueryRequest(s, t, 3) for s, t in queries[32:]])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    answers = [(tk.result.paths, tk.result.epoch) for tk in tickets]
    slabs = [tuple(w.slab.adj.shape) for w in svc.cluster.workers
             if w.slab is not None]
    log(f"[serving] {label or engine}: grid {g.n} vertices {g.m} edges, "
        f"DTLP build {build_s:.1f} s (once), slabs {slabs}; {len(tickets)} "
        f"queries + 1 update in {wall:.2f} s; launches {launches}")
    return svc, answers, launches


def phase_serving(torch, np):
    from repro_torch.core.sssp import graph_view
    from repro_torch.core.yen import ksp

    g0, queries, batch = serving_trace(np)
    svc, answers, launches = serve(torch, "cuda_bf", queries, batch)
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

    _, plain_answers, plain_launches = serve(torch, "dense_bf", queries,
                                             batch)
    check(plain_answers == answers, "cuda_bf and dense_bf answers differ")
    check(plain_launches["bf_solve_grouped"] == 0,
          "the plain engine launched the kernel")
    log("[serving] cuda_bf (paths, epoch) equal the plain dense_bf engine's "
        "on all 64 queries")
    return launches, answers


def phase_mesh_refine(torch, dev, fused_ms):
    """``make_refine_fn`` with ``CudaBackend`` at the refine_dense shape,
    on a 1-shard mesh of the card and on 2 logical shards of it: dist and
    parents bitwise the fused ``bf_solve_grouped``'s, one fused launch
    per shard and no ``bf_relax_step``, its wall time beside the fused
    solve's ``fused_ms``."""
    from repro_torch.dist.shard_refine import make_refine_fn
    from repro_torch.engine.backend import CudaBackend
    from repro_torch.kernels import bf_relax, ops
    from repro_torch.launch.mesh import make_host_mesh

    S, J, z = DENSE_S, DENSE_J, DENSE_Z
    args = road_inputs(torch, S, J, z, dev)
    want_d, want_p, _, _ = bf_relax.solve_grouped(*args)
    out = {}
    for n in (1, 2):
        refine = make_refine_fn(make_host_mesh(device=[dev] * n),
                                backend=CudaBackend())
        walls = []
        for _ in range(3):
            ops.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            d, p = refine(*args)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            launches = dict(ops.LAUNCHES)
            check(torch.equal(d, want_d) and torch.equal(p, want_p),
                  ("mesh refine differs from the fused solve", n))
        check(launches["bf_solve_grouped"] == n
              and launches["bf_relax_step"] == 0,
              ("mesh refine launches", n, launches))
        wall = statistics.median(walls)
        out[f"{n}_shard"] = dict(wall_ms=wall, launches=launches)
        log(f"[mesh-refine] {n} shard(s) on {dev}: S={S} J={J} z={z}, "
            f"launches {launches}, wall {wall:.3f} ms (median of 3, host "
            f"clock around a synchronize); dist and parents bitwise the "
            f"fused solve's ({fused_ms:.3f} ms, CUDA events)")
    return out


def phase_mesh_serving(torch, np, answers):
    """The serving trace on ``cuda_bf`` over a 1-shard mesh of the card,
    barrier and streaming: every (paths, epoch) equal to the non-mesh
    run's (its update lands between two drained replays, so both modes
    serve the same answers), with ``bf_solve_grouped`` launched and
    ``bf_relax_step`` not."""
    from repro_torch.launch.mesh import make_host_mesh

    _, queries, batch = serving_trace(np)
    mesh = make_host_mesh(1)
    out = {}
    for mode in ("barrier", "streaming"):
        _, got, launches = serve(
            torch, "cuda_bf", queries, batch, mesh=mesh,
            update_mode=mode, label=f"cuda_bf on a 1-shard mesh, {mode}")
        check(got == answers, ("mesh serving answers differ", mode))
        check(launches["bf_solve_grouped"] > 0
              and launches["bf_relax_step"] == 0,
              ("mesh serving launches", mode, launches))
        out[mode] = dict(launches=launches)
    log("[mesh-serving] (paths, epoch) of all 64 queries equal the "
        "non-mesh cuda_bf run's in both modes")
    return out


def phase_driver():
    """``python -m repro_torch.launch.serve --engine cuda_bf --mesh`` as a
    user starts it (a 10x10 grid, worker 1 killed and revived): its
    output must end in "serving run complete" with no EMPTY line."""
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--engine",
           "cuda_bf", "--mesh", "--rows", "10", "--cols", "10",
           "--workers", "4", "--queries", "8", "--epochs", "3", "--kill",
           "1", "--revive"]
    t0 = time.perf_counter()
    run = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                         timeout=600, env=dict(os.environ,
                                               PYTHONPATH=str(ROOT / "src")))
    wall = time.perf_counter() - t0
    lines = run.stdout.strip().splitlines()
    check(run.returncode == 0, ("the serving driver failed", run.returncode,
                                run.stderr[-2000:]))
    check(bool(lines) and lines[-1].startswith("serving run complete"),
          ("the serving driver did not complete", lines[-3:]))
    check(not any("EMPTY" in line for line in lines),
          "the serving driver returned EMPTY results")
    for line in lines:
        if line.startswith(("mesh refine", "epoch", "stale", "serving")):
            log(f"[driver] {line}")
    log(f"[driver] {' '.join(cmd[1:])}: exit 0 in {wall:.1f} s")


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
                  and torch.equal(used, solve_path(torch, adj, slots)),
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
    weight_loops = ktrop_solve_weight_case(torch, np, rng, dev)
    log("[ragged-index] ktrop_solve (D and iterations per row) bitwise "
        "equal to plain with a kept weight of -1e37 out of row 0's source "
        f"(k=4, 30 iterations), row 0 dense: {weight_loops}")
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


def ktrop_solve_weight_case(torch, np, rng, dev):
    """``ktrop_solve`` on list rows (density 5%, and 1/z at z=1000) with
    an edge weight of -1e37 out of row 0's source: that row runs the
    dense loop (levels go below 0 mid-solve, where D + INF < INF), the
    others their list; bitwise against the plain solve.  Loops by z."""
    from repro_torch.kernels import _build, ktrop, ref

    out = {}
    k = 4
    for z in (33, 256, 1000):
        S = 3
        a = rng.integers(1, 9, (S, z, z)).astype(np.float32)
        a[rng.random((S, z, z)) > min(0.05, 1.0 / z)] = ref.INF
        for s in range(S):
            np.fill_diagonal(a[s], 0.0)
        src = rng.integers(0, z, S).astype(np.int32)
        a[0, src[0], (src[0] + 1) % z] = -1e37
        adj = torch.from_numpy(a).to(dev)
        src = torch.from_numpy(src).to(dev)
        D, it, used = ktrop.solve(adj, src, k, 30)
        wD, wit = ref.ktrop_solve_ref(adj, src, k, 30)
        check(torch.equal(D, wD) and torch.equal(it, wit),
              ("ktrop_solve with a -1e37 weight", z))
        want = solve_path(torch, adj, _build.edge_list_slots(2 * k * z * 4, z))
        check(torch.equal(used, want) and used.tolist()[0] == 0,
              ("ktrop_solve loop report with a -1e37 weight", z,
               used.tolist()))
        out[f"z={z}"] = used.tolist()
    return out


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
    nnz = (adj < ref.INF).sum(dim=(1, 2)).double()
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
    # operations this data needs per row: on its in-edge list at most k
    # add+compare pairs per finite entry; a row that scans every u also
    # pays one add and one compare (the early exit) per pair without an
    # edge
    row_ops = torch.where(step_path.bool(), 2.0 * k * nnz,
                          2.0 * (z * z + k * nnz))
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


# ---------------------------------------------------------------------------
# LM serving (no TPU kernel on this path: plain PyTorch on the card)
# ---------------------------------------------------------------------------
# Teacher-forced decode against the full forward: two bf16 evaluations of
# one 30-layer model whose products round in other orders (one row against
# 128).  bf16 keeps 8 significant bits: at |logit| in [4, 8) an ulp is
# 2^-5 = 0.031, and the bound is 2.5 of them, 8e-2 — the reference's own
# bound for two such evaluations (tests/test_serve.py, MLA decode parity).
# scripts/lm_decode_error.py measures each against a float32 forward.
LM_DECODE_ATOL = 8e-2
# The mixed against the stacked cache: one evaluation but for the order of
# the attention sums; the reference's bound (tests/test_serve.py).
LM_CACHE_ATOL = 5e-2
LM_SLOTS, LM_MAX_LEN, LM_PROMPT, LM_NEW, LM_REQUESTS = 8, 4096, 128, 32, 12
GEMMA_LAYERS, GEMMA_POSITIONS = 6, 1100


def lm_logits(torch, T, params, cfg, tokens):
    """Every position's logits [S, V] (float32) from one full forward."""
    with torch.no_grad():
        h, _ = T.lm_backbone(params, tokens[None], cfg)
        return (h[0] @ T._unembed(params, cfg).to(torch.bfloat16)).float()


def check_greedy(logits, tokens, what):
    """Each token is the argmax of its logits, or within 2 x the bound of
    it where the top two are that close (a bf16 tie may go either way)."""
    best = logits.max(dim=-1).values
    mine = logits.gather(-1, tokens[:, None])[:, 0]
    check(bool((mine >= best - 2 * LM_DECODE_ATOL).all()),
          (what, "a served token is not greedy",
           float((best - mine).max())))


def lm_teacher_forced(torch, np, T, params, cfg, dev):
    """Decode a 128-token prompt one token per step and hold each
    position's logits against the full forward on the same prefix."""
    rng = np.random.default_rng(SEED)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab, LM_PROMPT)).to(dev)
    fwd = lm_logits(torch, T, params, cfg, prompt)
    cache = T.init_cache(T.cache_spec(cfg, 1, LM_MAX_LEN), dev)
    dec = torch.empty_like(fwd)
    for pos in range(LM_PROMPT):
        lg, cache = T.lm_decode_step(params, cache, prompt[pos].view(1, 1),
                                     pos, cfg)
        dec[pos] = lg[0].float()
    check(bool(torch.isfinite(dec).all() and torch.isfinite(fwd).all()),
          "NaN in the teacher-forced logits")
    err = max_abs_err(torch, dec, fwd)
    check(err <= LM_DECODE_ATOL, ("teacher-forced decode vs forward", err))
    top2 = fwd.topk(2, dim=-1).values
    sure = (top2[:, 0] - top2[:, 1]) > 2 * LM_DECODE_ATOL
    check(bool((dec.argmax(-1) == fwd.argmax(-1))[sure].all()),
          "teacher-forced argmax differs where the margin is clear")
    return err, float(fwd.abs().max()), int(sure.sum())


def lm_serve_requests(torch, np, T, params, cfg, dev):
    """12 requests (prompts of 16-128 tokens, 32 new each) through a
    DecodeServer of 8 slots; every request finishes, slots are recycled,
    and every served token is greedy given its own prefix."""
    from repro_torch.serve.engine import DecodeServer, Request

    rng = np.random.default_rng(SEED + 1)
    reqs = [Request(rid=i, prompt=[int(x) for x in rng.integers(
        0, cfg.vocab, int(rng.integers(16, LM_PROMPT + 1)))],
        max_new=LM_NEW) for i in range(LM_REQUESTS)]
    srv = DecodeServer(params, cfg, batch_slots=LM_SLOTS,
                       max_len=LM_MAX_LEN, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done, steps = srv.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(len(done) == LM_REQUESTS and srv.active == 0,
          ("requests left unserved", len(done), srv.active))
    check(all(r.done and len(r.out) == LM_NEW for r in reqs),
          "a request did not get its 32 tokens")
    for r in reqs:
        toks = torch.tensor(r.prompt + r.out, device=dev)
        logits = lm_logits(torch, T, srv.params, cfg, toks[:-1])
        check_greedy(logits[len(r.prompt) - 1:], toks[len(r.prompt):],
                     ("request", r.rid))
    return srv, steps, wall


def lm_decode_timing(torch, T, srv, cfg, dev):
    """One decode step at B=8 on the server's weights and cache (positions
    200-207): the median CUDA-event time, and the median host time to
    enqueue it (no synchronisation inside): when the two are equal, the
    card waits on the host."""
    tokens = torch.arange(LM_SLOTS, device=dev).view(LM_SLOTS, 1)
    pos = torch.arange(200, 200 + LM_SLOTS, device=dev)

    def step():
        return T.lm_decode_step(srv.params, srv.cache, tokens, pos, cfg)

    for _ in range(3):
        step()
    enqueue = []
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        enqueue.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return cuda_ms(torch, step, 20), statistics.median(enqueue)


def lm_mixed_vs_stacked(torch, np, T, cfg, dev):
    """gemma3-27b at full width, 6 layers (5 local, 1 global): 1,100
    positions (past the 1,024 window) through the per-layer mixed cache
    and through the stacked cache, on the same tokens."""
    from repro_torch.models.common import DEFAULT_POLICY

    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = T.compute_copy(T.init_lm(gen, cfg, DEFAULT_POLICY, device=dev))
    max_len = GEMMA_POSITIONS + 52
    mixed = T.init_cache(T.cache_spec_mixed(cfg, 1, max_len), dev)
    stacked = T.init_cache(T.cache_spec(cfg, 1, max_len), dev)
    check([c["k"].shape[1] for c in mixed] == [cfg.window] * 5 + [max_len],
          "gemma3 6-layer mixed cache sizes")
    toks = torch.from_numpy(np.random.default_rng(SEED + 2).integers(
        0, cfg.vocab, GEMMA_POSITIONS)).to(dev)
    worst = torch.zeros((), device=dev)
    same = torch.zeros((), dtype=torch.int64, device=dev)
    t0 = time.perf_counter()
    for pos in range(GEMMA_POSITIONS):
        t = toks[pos].view(1, 1)
        lm, mixed = T.lm_decode_step(params, mixed, t, pos, cfg)
        ls, stacked = T.lm_decode_step(params, stacked, t, pos, cfg)
        worst = torch.maximum(worst, (lm.float() - ls.float()).abs().max())
        same += (lm == ls).all()  # on the card: no host sync per step
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    worst = float(worst)
    check(np.isfinite(worst) and worst <= LM_CACHE_ATOL,
          ("gemma3 mixed vs stacked cache", worst))
    return worst, int(same), wall, params


def phase_lm_serving(torch, np, dev, smi):
    """The LM serving path on the card: starcoder2-3b at full width and
    depth (teacher-forced decode, 12 requests through DecodeServer, the
    B=8 decode step timed), gemma3-27b at full width cut to 6 layers
    (mixed vs stacked cache), and one train and decode step of the MoE
    and MLA smoke configs."""
    import dataclasses

    from repro_torch.configs import gemma3_27b, starcoder2_3b
    from repro_torch.configs.base import get_arch
    from repro_torch.models import transformer as T
    from repro_torch.models.common import (DEFAULT_POLICY, count_params,
                                           tree_bytes)

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg = starcoder2_3b.CFG
    gen = torch.Generator(device=dev).manual_seed(SEED)
    t0 = time.perf_counter()
    master = T.init_lm(gen, cfg, DEFAULT_POLICY, device=dev)
    check(count_params(master) == cfg.param_count(), "starcoder2 params")
    params = T.compute_copy(master)
    torch.cuda.synchronize()
    n_params, f32_bytes = count_params(master), tree_bytes(master)
    del master
    weight_bytes = tree_bytes(params)
    log(f"[lm_serving] starcoder2-3b: {cfg.n_layers} layers, d={cfg.d_model},"
        f" {n_params:,} params ({f32_bytes / 1e9:.2f} GB float32, bf16 copy "
        f"{weight_bytes / 1e9:.2f} GB) made from seed {SEED} in "
        f"{time.perf_counter() - t0:.2f} s")
    err, logit_max, sure = lm_teacher_forced(torch, np, T, params, cfg, dev)
    log(f"[lm_serving] teacher-forced decode of {LM_PROMPT} positions vs the "
        f"forward: max |dlogit| {err:.4f} (bound {LM_DECODE_ATOL}, |logit| <= "
        f"{logit_max:.2f}); argmax equal at all {sure} clear positions")
    srv, steps, wall = lm_serve_requests(torch, np, T, params, cfg, dev)
    n_tok = LM_REQUESTS * LM_NEW
    log(f"[lm_serving] DecodeServer ({LM_SLOTS} slots, max_len {LM_MAX_LEN}):"
        f" {LM_REQUESTS} requests, {n_tok} tokens in {steps} steps, "
        f"{wall:.2f} s ({n_tok / wall:.1f} new tokens/s, "
        f"{steps * LM_SLOTS / wall:.1f} slot-steps/s); every token greedy")
    step_ms, enqueue_ms = lm_decode_timing(torch, T, srv, cfg, dev)
    cache_bytes = tree_bytes(srv.cache)
    peak = torch.cuda.max_memory_allocated()
    from repro_torch.launch.roofline import HBM_BW

    bound = weight_bytes / HBM_BW * 1e3
    log(f"[lm_serving] decode step B={LM_SLOTS}: {step_ms:.3f} ms median "
        f"({LM_SLOTS / step_ms * 1e3:.1f} tokens/s; the host takes "
        f"{enqueue_ms:.3f} ms to enqueue it); weight-read bound "
        f"{bound:.3f} ms ({weight_bytes / 1e9:.2f} GB bf16 at "
        f"{HBM_BW / 1e12:.2f} TB/s; the {cache_bytes / 1e9:.2f} GB "
        f"ring cache read too: {(weight_bytes + cache_bytes) / HBM_BW * 1e3:.3f} ms);"
        f" peak {peak / 1e9:.2f} GB; {smi}")
    del srv, params
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    gcfg = dataclasses.replace(gemma3_27b.CFG, n_layers=GEMMA_LAYERS)
    worst, same, wall, gparams = lm_mixed_vs_stacked(torch, np, T, gcfg, dev)
    log(f"[lm_serving] gemma3-27b x{GEMMA_LAYERS} layers (5 local of window "
        f"{gcfg.window}, 1 global; {gcfg.param_count():,} params, bf16 "
        f"{tree_bytes(gparams) / 1e9:.2f} GB): {GEMMA_POSITIONS} positions, "
        f"mixed vs stacked cache max |dlogit| {worst:.4f}, bitwise equal at "
        f"{same}/{GEMMA_POSITIONS}; {wall:.2f} s for both; peak "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    del gparams
    torch.cuda.empty_cache()
    for name in ("moonshot-v1-16b-a3b", "deepseek-v3-671b"):
        out = get_arch(name).smoke_fn(device="cuda")
        log(f"[lm_serving] {name} smoke (MoE{', MLA, MTP' if 'v3' in name else ''})"
            f" on the card: 3 train steps and a decode step, losses "
            f"{[round(x, 4) for x in out['losses']]}")
    log(f"[lm_serving] phase passed in {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# Training (no TPU kernel on this path: plain PyTorch on the card)
# ---------------------------------------------------------------------------
# The card against the port's own CPU run of the same step on the same
# params and batch: the first step's loss and global gradient norm.  Both
# are float32 sums taken in other orders (CUDA's index_add_ adds in no
# fixed order, the products block differently): 1e-4 relative.
TRAIN_RTOL = 1e-4
SERVE_ATOL = 1e-5  # BST CTR probabilities, card vs CPU
RETRIEVAL_RTOL = 1e-5  # retrieval scores, of the largest |score|
GNN_STEPS, BST_STEPS = 5, 3
# the train driver's peak learning rate, reached over the 5 steps: a step
# of 1e-3 from the first one sends dimenet's untrained loss (about 4.6e3)
# up 20x (a CPU run of the port)
TRAIN_LR, TRAIN_WARMUP = 3e-4, GNN_STEPS
# Reddit, the minibatch_lg host graph: its nodes and its 114,615,892
# directed edges, generated whole (no cut); the sampled block is padded to
# the cell's 169,984 nodes and 168,960 edges
REDDIT_NODES, REDDIT_EDGES = 232_965, 114_615_892
CORA_NODES, CORA_EDGES = 2_708, 10_556  # gin-tu's full_graph_sm
MOLECULES, ATOMS, MOLECULE_EDGES = 128, 30, 64  # dimenet's molecule shape
# the CPU opinion of the two largest cases runs on a slice: meshgraphnet
# on a block of 128 seeds padded to 1/8 of the cell, BST on the batch's
# first 4,096 examples (the whole tables)
MGN_SLICE_SEEDS, BST_SLICE = 128, 4_096
SERVE_REPEATS = 10
TRACED_STEPS = 2  # steps of a case traced by torch.profiler
KERNEL_CATEGORIES = [  # (category, kernel-name pattern): first match wins
    ("products", r"gemm|sm90_xmma|sm80_xmma|cutlass|cublas|splitK"),
    ("gathers/scatters", r"index|scatter|gather|embedding|take"),
    ("norms", r"norm"),
    ("reductions", r"reduce|softmax"),
    ("elementwise", r"elementwise|vectorized|unrolled|copy|fill|where|cat"),
]


def to_dev(torch, np, batch, dev):
    return {k: torch.from_numpy(np.asarray(v)).to(dev)
            for k, v in batch.items()}


def on_cpu(torch, tree):
    from repro_torch.models.common import tree_map

    return tree_map(lambda t: t.detach().cpu(), tree)


def timed_steps(torch, step, state, batches):
    """``state = step(*state, batch)[:-1]`` for each batch (made before its
    timing starts): (final state, metrics per step, CUDA-event ms per
    step)."""
    metrics, ms = [], []
    for batch in batches:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = step(*state, batch)
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
        state, m = out[:-1], out[-1]
        check(all(bool(torch.isfinite(v)) for v in m.values()),
              ("a non-finite metric", {k: float(v) for k, v in m.items()}))
        metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics, ms


def cpu_opinion(torch, np, step, state, batch, card, what):
    """The same step on the CPU, on the CPU copies of ``state`` and the
    numpy ``batch``: its loss and gradient norm against the card's
    (``card``, that step's metrics).  Returns (CPU seconds, relative
    errors)."""
    state = on_cpu(torch, state)
    t0 = time.perf_counter()
    cpu = step(*state, to_dev(torch, np, batch, "cpu"))[-1]
    secs = time.perf_counter() - t0
    errs = {}
    for k in ("loss", "grad_norm"):
        want = float(cpu[k])
        errs[k] = abs(card[k] - want) / max(abs(want), 1e-30)
        check(errs[k] <= TRAIN_RTOL,
              (what, f"card vs CPU {k}", card[k], want, errs[k]))
    return secs, errs


def train_line(what, ms, metrics, peak, secs, errs, opinion, extra=""):
    times = ", ".join(f"{t:.2f}" for t in ms)
    losses = ", ".join(f"{m['loss']:.4f}" for m in metrics)
    log(f"[training] {what}: {len(ms)} steps, step "
        f"{statistics.median(ms):.3f} ms median (CUDA events; {times}), "
        f"losses {losses}{extra}, "
        f"gnorm {metrics[0]['grad_norm']:.4f}; peak "
        f"{peak / 1e9:.3f} GB; CPU opinion on {opinion} ({secs:.1f} s): "
        f"loss rel {errs['loss']:.2e}, gnorm rel {errs['grad_norm']:.2e}")


def cora_like(np, dp):
    """full_graph_sm: the first number of random edges that gives Cora's
    2,708 nodes and 10,556 directed edges at the seed (1,433 features, 7
    classes)."""
    for m in range(CORA_EDGES // 2 - CORA_NODES, CORA_EDGES):
        g = dp.random_gnn_graph(CORA_NODES, m, 1_433, 7, seed=SEED)
        if g["edge_src"].shape[0] == CORA_EDGES:
            return g
    raise RuntimeError("no Cora-sized graph at this seed")


def reddit_host(torch, np, dp):
    """The minibatch_lg host graph as CSR: ``random_gnn_graph`` with enough
    random edges, its last undirected pairs dropped to leave exactly
    REDDIT_EDGES directed edges; 602 features, 41 classes."""
    n, half = REDDIT_NODES, REDDIT_EDGES // 2
    t0 = time.perf_counter()
    g = dp.random_gnn_graph(n, half - (n - 1) + 2_000, 602, 41, seed=SEED)
    u = g["edge_src"].shape[0] // 2  # undirected pairs: k and k + u
    check(u >= half, ("too few host edges", u, half))
    keep = np.r_[0:half, u:u + half]
    src, dst = g["edge_src"][keep], g["edge_dst"][keep]
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    order = torch.sort(torch.from_numpy(src), stable=True)[1].numpy()
    nbr = dst[order]
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(src, minlength=n), out=indptr[1:])
    t_csr = time.perf_counter() - t0
    check(indptr[-1] == REDDIT_EDGES, ("host edges", indptr[-1]))
    log(f"[training] graphsage-reddit host graph: {n:,} nodes, "
        f"{REDDIT_EDGES:,} directed edges (Reddit's; no cut), mean degree "
        f"{REDDIT_EDGES / n:.1f}, min {int(np.diff(indptr).min())}; made in "
        f"{t_gen:.1f} s, CSR in {t_csr:.1f} s (host)")
    return indptr, nbr, g["node_feat"], g["labels"]


def padded_block(np, block, feat, n_pad, e_pad):
    """A sampled block padded to ``n_pad`` nodes and ``e_pad`` edges (the
    cell's shape): padding nodes have zero features, padding edges join
    the last padding node to itself."""
    k, e = block["nodes"].shape[0], block["edge_src"].shape[0]
    check(k < n_pad and e <= e_pad, ("block over the cell", k, e))
    node_feat = np.zeros((n_pad, feat.shape[1]), np.float32)
    node_feat[:k] = feat[block["nodes"]]
    src = np.full(e_pad, n_pad - 1, np.int32)
    dst = np.full(e_pad, n_pad - 1, np.int32)
    src[:e], dst[:e] = block["edge_src"], block["edge_dst"]
    return {"node_feat": node_feat, "edge_src": src, "edge_dst": dst}, k, e


def busy_share(spans, wall_us):
    """The union of the [start, end) ``spans`` over ``wall_us``."""
    covered, end = 0.0, None
    for s, e in sorted(spans):
        if end is None or s > end:
            covered, end = covered + e - s, e
        elif e > end:
            covered, end = covered + e - end, e
    return covered / wall_us


def trace_steps(torch, what, step, state, batch):
    """TRACED_STEPS more steps on ``state`` under ``torch.profiler``:
    kernels per step, kernel ms per step, the device's busy share of the
    traced window (kernel intervals over its wall time), kernel time by
    category and the three longest kernels."""
    import collections

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(TRACED_STEPS):
            step(*state, batch)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        log(f"[training] {what} trace: no device events (not measured)")
        return
    by_cat, by_name = collections.Counter(), collections.Counter()
    for e in kernels:
        us = e.time_range.elapsed_us()
        cat = next((c for c, pat in KERNEL_CATEGORIES
                    if re.search(pat, e.name, re.IGNORECASE)), "other")
        by_cat[cat] += us
        by_name[e.name] += us
    total = sum(by_cat.values())
    cats = "; ".join(f"{c} {us / TRACED_STEPS / 1e3:.2f} ms "
                     f"({us / total:.0%})" for c, us in by_cat.most_common())
    top = "; ".join(f"{us / TRACED_STEPS / 1e3:.2f} ms {name[:60]}"
                    for name, us in by_name.most_common(3))
    share = busy_share([(e.time_range.start, e.time_range.end)
                        for e in kernels], wall_us)
    log(f"[training] {what} trace ({TRACED_STEPS} steps, torch.profiler): "
        f"{len(kernels) / TRACED_STEPS:.0f} kernels and "
        f"{total / TRACED_STEPS / 1e3:.2f} ms of kernel time per step, "
        f"{wall_us / TRACED_STEPS / 1e3:.2f} ms wall; device busy share "
        f"{share:.3f}; {cats}; longest: {top}")


def gnn_case(torch, np, dev, name, shape, batches, opinion=None,
             repeated=True, trace=False):
    """Train the published config of ``name`` at ``shape`` on the card,
    one step per batch (numpy batches; the first is the CPU opinion's
    unless ``opinion`` gives a slice).  A case that repeats one batch must
    end below its first loss; with ``trace``, its step is also traced."""
    import functools

    from repro_torch.configs.base import get_arch
    from repro_torch.configs.gnn_family import shape_cfg
    from repro_torch.models import gnn as G
    from repro_torch.train.optim import OptConfig, init_opt
    from repro_torch.train.steps import make_train_step

    base = get_arch(name).smoke_fn.args[0]  # the published config
    cfg = shape_cfg(base, shape)
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = G.init_gnn(gen, cfg, device=dev)
    opt_cfg = OptConfig(peak_lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP)
    opt = init_opt(params, opt_cfg)
    step = make_train_step(functools.partial(G.gnn_loss, cfg=cfg), opt_cfg)
    dev_batches = (to_dev(torch, np, b, dev) for b in batches())
    (p1, _), metrics, ms = timed_steps(torch, step, (params, opt),
                                       dev_batches)
    peak = torch.cuda.max_memory_allocated()
    extra = ""
    if repeated:
        last = to_dev(torch, np, next(iter(batches())), dev)
        with torch.no_grad():
            after = float(G.gnn_loss(p1, last, cfg)[0])
        check(np.isfinite(after) and after < metrics[0]["loss"],
              (name, "the loss did not fall", metrics[0]["loss"], after))
        extra = f" (after the last step {after:.4f})"
    if opinion is None:
        label, batch0 = "the whole first batch", next(iter(batches()))
        card = metrics[0]
    else:
        label, batch0 = opinion
        card = step(params, opt, to_dev(torch, np, batch0, dev))[-1]
        card = {k: float(v) for k, v in card.items()}
    secs, errs = cpu_opinion(torch, np, step, (params, opt), batch0, card,
                             name)
    dims = ("" if cfg.kind == "dimenet"
            else f", in {cfg.in_dim}, out {cfg.out_dim}")
    what = f"{name} {shape} ({cfg.n_layers} layers, d={cfg.d_hidden}{dims})"
    train_line(what, ms, metrics, peak, secs, errs, label, extra)
    if trace:
        trace_steps(torch, name, step, (params, opt),
                    to_dev(torch, np, next(iter(batches())), dev))
    del params, opt, p1
    torch.cuda.empty_cache()


def phase_gnn_training(torch, np, dev):
    from repro_torch.configs.gnn_family import GNN_SHAPES
    from repro_torch.data import pipeline as dp

    cora = cora_like(np, dp)
    gnn_case(torch, np, dev, "gin-tu", "full_graph_sm",
                             lambda: [cora] * GNN_STEPS)

    mol = dp.molecule_batch(MOLECULES, ATOMS, MOLECULE_EDGES, seed=SEED)
    log(f"[training] dimenet molecule batch: {MOLECULES} graphs x {ATOMS} "
        f"atoms, {mol['edge_src'].shape[0]:,} directed edges, "
        f"{mol['t_kj'].shape[0]:,} triplets (build_triplets)")
    gnn_case(torch, np, dev, "dimenet", "molecule",
             lambda: [mol] * GNN_STEPS)

    meta = GNN_SHAPES["minibatch_lg"]
    indptr, nbr, feat, labels = reddit_host(torch, np, dp)
    sampler = dp.NeighborSampler(indptr, nbr, fanouts=(15, 10), seed=SEED)
    rng = np.random.default_rng(SEED)
    sizes = []

    def sage_block():
        seeds = rng.choice(REDDIT_NODES, meta["seeds"], replace=False)
        t0 = time.perf_counter()
        block = sampler.sample(seeds)
        b, k, e = padded_block(np, block, feat, meta["n"], meta["e"])
        sizes.append((k, e, time.perf_counter() - t0))
        lab = np.zeros(meta["n"], np.int32)
        lab[:k] = labels[block["nodes"]]
        b["labels"] = lab
        b["train_mask"] = (np.arange(meta["n"]) < block["n_seeds"]).astype(
            np.float32)
        return b

    blocks = [sage_block() for _ in range(GNN_STEPS)]
    log(f"[training] graphsage-reddit blocks ({meta['seeds']:,} seeds, "
        f"fanouts 15-10, padded to {meta['n']:,} nodes / {meta['e']:,} "
        "edges): "
        + "; ".join(f"{k:,} nodes {e:,} edges {t:.2f} s" for k, e, t in sizes))
    gnn_case(
        torch, np, dev, "graphsage-reddit", "minibatch_lg", lambda: blocks,
        repeated=False)
    del blocks

    def mgn_batch(n_seeds, n_pad, e_pad):
        seeds = rng.choice(REDDIT_NODES, n_seeds, replace=False)
        block = sampler.sample(seeds)
        b, k, e = padded_block(np, block, feat, n_pad, e_pad)
        b["edge_feat"] = np.zeros((e_pad, 4), np.float32)
        b["edge_feat"][:e] = rng.normal(size=(e, 4))
        b["labels"] = rng.normal(size=(n_pad, 3)).astype(np.float32)
        b["train_mask"] = (np.arange(n_pad) < k).astype(np.float32)
        return b, k, e

    mgn, k, e = mgn_batch(meta["seeds"], meta["n"], meta["e"])
    part = meta["seeds"] // MGN_SLICE_SEEDS
    mslice, ks, es = mgn_batch(MGN_SLICE_SEEDS, meta["n"] // part,
                               meta["e"] // part)
    log(f"[training] meshgraphnet batch: a sampled block of {k:,} nodes and "
        f"{e:,} edges padded to {meta['n']:,} / {meta['e']:,} (the "
        f"minibatch_lg cell); its CPU slice {ks:,} / {es:,} padded to "
        f"{meta['n'] // part:,} / {meta['e'] // part:,}")
    del feat, nbr
    gnn_case(
        torch, np, dev, "meshgraphnet", "minibatch_lg",
        lambda: [mgn] * GNN_STEPS, trace=True,
        opinion=(f"a block of {MGN_SLICE_SEEDS} seeds (1/{part} of the "
                 "cell)", mslice))


def bst_slice(np, batch, n, nnz):
    """The first ``n`` examples of a ``ClickStream`` batch."""
    out = {k: v[:n] for k, v in batch.items() if k not in ("bag_ids",
                                                           "bag_seg")}
    out["bag_ids"] = batch["bag_ids"][:n * nnz]
    out["bag_seg"] = batch["bag_seg"][:n * nnz]
    return out


def check_sparse_rows(torch, np, old, new, ids, dev, key):
    """After the sparse steps: every row that no batch touched is
    bit-identical, and every row that the first batch touched moved (the
    first step moves each touched row by about 500x its gradient).  A row
    first touched by a later batch may keep its bytes: where every example
    that reads it has a saturated logit, its gradient rounds away."""
    def mask(arrays):
        m = torch.zeros(old.shape[0], dtype=torch.bool, device=dev)
        m[torch.from_numpy(np.concatenate(arrays)).to(dev).long()] = True
        return m

    touched, first = mask(ids), mask(ids[:1])
    check(torch.equal(old[~touched], new[~touched]),
          (key, "an untouched row changed"))
    moved = (old != new).any(dim=1)
    check(bool(moved[first].all()), (key, "rows of the first batch that "
                                     "did not move",
                                     int((first & ~moved).sum())))
    later = touched & ~first
    log(f"[training] bst sparse {key}: {int((~touched).sum()):,} rows "
        f"untouched and bit-identical; {int(first.sum()):,} touched by the "
        f"first batch, all moved; {int(later.sum()):,} first touched later, "
        f"{int((later & moved).sum()):,} of them moved")


def phase_bst_training(torch, np, dev):
    """BST at ``bst_arch.CFG`` (10M x 32 item table, 1M x 32 profile
    table): dense AdamW steps over every parameter and sparse steps at
    train_batch (65,536 examples), then serve_p99 and retrieval_cand."""
    import functools

    from repro_torch.configs.bst_arch import (BST_SHAPES, CFG,
                                              retrieval_batch)
    from repro_torch.data.pipeline import ClickStream
    from repro_torch.models import bst as B
    from repro_torch.models.common import count_params, tree_bytes
    from repro_torch.train.optim import OptConfig, init_opt
    from repro_torch.train.steps import make_train_step

    def stream(batch):
        return ClickStream(n_items=CFG.n_items, n_profile=CFG.n_profile,
                           seq_len=CFG.seq_len, batch=batch,
                           bag_nnz=CFG.bag_nnz_per_row, n_dense=CFG.n_dense,
                           seed=SEED)

    nnz = CFG.bag_nnz_per_row
    train = stream(BST_SHAPES["train_batch"]["batch"])
    batches = [train.batch_at(i) for i in range(BST_STEPS)]
    sl = bst_slice(np, batches[0], BST_SLICE, nnz)

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = B.init_bst(gen, CFG, device=dev)
    torch.cuda.synchronize()
    check(count_params(params) == CFG.param_count(), "bst params")
    log(f"[training] bst: {CFG.param_count():,} params ("
        f"{tree_bytes(params) / 1e9:.2f} GB float32) made from seed {SEED} "
        f"in {time.perf_counter() - t0:.2f} s; train_batch "
        f"{BST_SHAPES['train_batch']['batch']:,} examples from ClickStream")

    opt_cfg = OptConfig(peak_lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP)
    dense = make_train_step(functools.partial(B.bst_loss, cfg=CFG), opt_cfg)
    opt = init_opt(params, opt_cfg)
    (p1, o1), metrics, ms = timed_steps(
        torch, dense, (params, opt),
        (to_dev(torch, np, b, dev) for b in batches))
    del p1, o1
    peak = torch.cuda.max_memory_allocated()
    card = {k: float(v) for k, v in
            dense(params, opt, to_dev(torch, np, sl, dev))[-1].items()}
    secs, errs = cpu_opinion(torch, np, dense, (params, opt), sl, card,
                             "bst dense")
    train_line("bst dense (AdamW over every parameter) train_batch", ms,
               metrics, peak, secs, errs,
               f"the batch's first {BST_SLICE:,} examples")
    trace_steps(torch, "bst dense", dense, (params, opt),
                to_dev(torch, np, batches[0], dev))
    del opt
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    net = B.dense_params(params)
    state = (params, B.init_bst_sparse_opt(params), init_opt(net, opt_cfg))
    sparse = functools.partial(B.bst_sparse_train_step, cfg=CFG,
                               opt_cfg=opt_cfg)
    (p1, _, _), metrics, ms = timed_steps(
        torch, sparse, state, (to_dev(torch, np, b, dev) for b in batches))
    peak = torch.cuda.max_memory_allocated()
    for key, ids in (("item_table", [np.concatenate(
            [b["hist"].ravel(), b["target"]]) for b in batches]),
            ("profile_table", [b["bag_ids"] for b in batches])):
        check_sparse_rows(torch, np, params[key], p1[key], ids, dev, key)
    del p1
    card = {k: float(v) for k, v in
            sparse(*state, to_dev(torch, np, sl, dev))[-1].items()}
    secs, errs = cpu_opinion(torch, np, sparse, state, sl, card,
                             "bst sparse")
    train_line("bst sparse (rowwise Adagrad on touched rows) train_batch",
               ms, metrics, peak, secs, errs,
               f"the batch's first {BST_SLICE:,} examples")
    trace_steps(torch, "bst sparse", sparse, state,
                to_dev(torch, np, batches[0], dev))
    del state
    torch.cuda.empty_cache()

    serve_np = stream(BST_SHAPES["serve_p99"]["batch"]).batch_at(100)
    serve_np.pop("labels")
    ret_np = retrieval_batch(train.batch_at(101), nnz,
                             BST_SHAPES["retrieval_cand"]["candidates"])
    ret_np.pop("labels")
    cpu_params = on_cpu(torch, params)
    with torch.no_grad():
        for name, fn, b in (("serve_p99", B.bst_serve, serve_np),
                            ("retrieval_cand", B.bst_retrieval, ret_np)):
            bd = to_dev(torch, np, b, dev)
            got = fn(params, bd, CFG)
            ms = cuda_ms(torch, lambda: fn(params, bd, CFG), SERVE_REPEATS)
            want = fn(cpu_params, to_dev(torch, np, b, "cpu"), CFG)
            err = max_abs_err(torch, got.cpu(), want)
            bound = (SERVE_ATOL if name == "serve_p99" else
                     RETRIEVAL_RTOL * float(want.abs().max()))
            check(bool(torch.isfinite(got).all()) and err <= bound,
                  (name, "card vs CPU", err, bound))
            log(f"[training] bst {name}: {tuple(got.shape)} "
                f"{ms:.3f} ms median (CUDA events); max |card - CPU| "
                f"{err:.2e} (bound {bound:.2e})")
    del params, cpu_params
    torch.cuda.empty_cache()


def phase_train_driver(tmp):
    """``python -m repro_torch.launch.train --arch gin-tu`` as a user runs
    it: 10 steps checkpointed every 5, then ``--resume`` to 15; and the
    fault-tolerant LM example on the card."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    base = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
            "gin-tu", "--ckpt-every", "5", "--ckpt-dir", str(tmp)]
    runs = []
    for extra in (["--steps", "10"], ["--steps", "15", "--resume"]):
        t0 = time.perf_counter()
        run = subprocess.run(base + extra, cwd=ROOT, capture_output=True,
                             text=True, timeout=600, env=env)
        check(run.returncode == 0, ("the train driver failed", extra,
                                    run.stderr[-2000:]))
        runs.append((run.stdout.strip().splitlines(),
                     time.perf_counter() - t0))
    (first, t1), (second, t2) = runs
    check(first[-1].startswith("done: 10 steps"), ("train driver", first))
    check(second[0] == "resumed from step 10"
          and second[-1].startswith("done: 15 steps"),
          ("train driver resume", second))
    log(f"[training] train driver gin-tu: 10 steps ({t1:.1f} s), then "
        f"'{second[0]}' and '{second[-1].split(',')[0]}' ({t2:.1f} s); "
        f"last: {second[-2]}")
    t0 = time.perf_counter()
    run = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "torch_train_lm_resume.py")],
        cwd=ROOT, capture_output=True, text=True, timeout=600, env=env)
    lines = run.stdout.strip().splitlines()
    check(run.returncode == 0 and lines
          and lines[-1] == "fault-tolerant training example on cuda OK",
          ("the resume example failed", lines[-4:], run.stderr[-2000:]))
    log(f"[training] examples/torch_train_lm_resume.py on the card: "
        f"{lines[0]}; {lines[3]} (rtol 1e-5; "
        f"{time.perf_counter() - t0:.1f} s)")


def phase_training(torch, np, dev, smi):
    """Phase 10: the training path of every family on the card."""
    import tempfile

    t_phase = time.perf_counter()
    phase_gnn_training(torch, np, dev)
    phase_bst_training(torch, np, dev)
    with tempfile.TemporaryDirectory() as tmp:
        phase_train_driver(Path(tmp))
    log(f"[training] {smi}; phase passed in "
        f"{time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# Dry-run (phase 11): every cell traced on the meta device, the cells that
# run at full shape here held against what the card measures
# ---------------------------------------------------------------------------
# 44 cells on three meshes (one card, 16x16, 2x16x16); refine_cusa and the
# long_500k cells of deepseek-coder-33b and moonshot carry their skips
DRYRUN_DONE = "done: 123 ok, 9 skipped (documented), 0 errors"
# traced argument + temporary bytes against the measured peak; the caching
# allocator rounds each block to 512 B and kernels take workspaces the
# trace cannot see (cuBLAS, sort)
PEAK_RTOL = 0.15
DRYRUN_REPEATS = 3
HELD_CELLS = (("kspdg", "refine_dense"), ("kspdg", "levels"),
              ("kspdg", "maintain"), ("gin-tu", "full_graph_sm"),
              ("dimenet", "molecule"), ("graphsage-reddit", "minibatch_lg"),
              ("meshgraphnet", "minibatch_lg"), ("bst", "train_batch"),
              ("bst", "serve_p99"), ("bst", "retrieval_cand"),
              ("starcoder2-3b", "decode_32k"))
DECODE_POS = 4095  # the last slot of starcoder2-3b's 4,096-slot ring
SPECIES = 8  # dimenet atom types drawn (the model embeds 32)


def random_tree(torch, tree, dev, gen):
    """Normal x 0.02 for every float leaf of a tree of TensorSpecs (the
    parameters), in its own dtype."""
    from repro_torch.models.common import tree_map

    return tree_map(lambda s: torch.randn(
        s.shape, generator=gen, device=dev, dtype=s.dtype).mul_(0.02), tree)


def zeros_tree(torch, tree, dev):
    from repro_torch.models.common import tree_map

    return tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype,
                                          device=dev), tree)


def gnn_cell_batch(torch, cell, dev, gen):
    """A batch of the cell's exact specs: edges between distinct nodes,
    triplets over the edges, molecules of consecutive atoms, labels below
    the shape's class count, every node in the loss."""
    from repro_torch.configs.gnn_family import GNN_SHAPES

    meta = GNN_SHAPES[cell.shape]
    n, e = meta["n"], meta["e"]
    specs = cell.arg_specs[-1]

    def ints(hi, shape):
        return torch.randint(0, hi, shape, generator=gen, device=dev,
                             dtype=torch.int32)

    src = ints(n, (e,))
    batch = {"edge_src": src,
             "edge_dst": (src + 1 + ints(n - 1, (e,))) % n}
    for key, spec in specs.items():
        if key in batch:
            continue
        if key in ("t_kj", "t_ji"):
            batch[key] = ints(e, spec.shape)
        elif key == "species":
            batch[key] = ints(SPECIES, spec.shape)
        elif key == "graph_idx":
            g = specs["labels"].shape[0]
            batch[key] = (torch.arange(n, device=dev) * g // n).int()
        elif key == "labels" and not spec.dtype.is_floating_point:
            batch[key] = ints(meta["classes"], spec.shape)
        elif key == "train_mask":
            batch[key] = torch.ones(spec.shape, device=dev)
        else:
            batch[key] = torch.randn(spec.shape, generator=gen, device=dev)
        check(tuple(batch[key].shape) == tuple(spec.shape)
              and batch[key].dtype == spec.dtype, (cell.name, key))
    return batch


def bst_cell_batch(torch, np, cell, dev):
    """``ClickStream`` examples (phase 10's generator) at the cell's
    batch; retrieval: one user and 10^6 candidates."""
    from repro_torch.configs.bst_arch import BST_SHAPES, CFG, retrieval_batch
    from repro_torch.data.pipeline import ClickStream

    meta = BST_SHAPES[cell.shape]
    stream = ClickStream(n_items=CFG.n_items, n_profile=CFG.n_profile,
                         seq_len=CFG.seq_len, batch=meta["batch"],
                         bag_nnz=CFG.bag_nnz_per_row, n_dense=CFG.n_dense,
                         seed=SEED)
    batch = stream.batch_at(0)
    if cell.kind == "retrieval":
        batch = retrieval_batch(batch, CFG.bag_nnz_per_row,
                                meta["candidates"])
    want = cell.arg_specs[-1]
    batch = {k: v for k, v in batch.items() if k in want}
    check(set(batch) == set(want) and all(
        tuple(batch[k].shape) == tuple(want[k].shape) for k in want),
        (cell.name, "batch shapes"))
    return to_dev(torch, np, batch, dev)


def cell_inputs(torch, np, cell, dev):
    """The arguments of ``cell.step_fn`` at the cell's full shape, made
    on the card from the seed: the kspdg phases' road-like slabs and
    profiles, seeded parameters with zero AdamW state, and batches of the
    cell's specs."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    if cell.shape == "refine_dense":
        S, _, z = cell.arg_specs[1].shape
        return road_inputs(torch, S, cell.arg_specs[1].shape[1], z, dev)
    if cell.shape == "levels":
        S, z, _ = cell.arg_specs[0].shape
        adj = road_inputs(torch, S, 1, z, dev)[0]
        return adj, torch.randint(0, z, (S,), generator=gen, device=dev,
                                  dtype=torch.int32)
    if cell.shape == "maintain":
        (S, E), _, (B,), _ = (spec.shape for spec in cell.arg_specs)
        return maintain_inputs(torch, S, E, B, dev)
    params = random_tree(torch, cell.arg_specs[0], dev, gen)
    if cell.kind == "decode":
        specs = cell.arg_specs
        vocab = specs[0]["embed"].shape[0]
        tokens = torch.randint(0, vocab, specs[2].shape, generator=gen,
                               device=dev, dtype=torch.int32)
        return (params, zeros_tree(torch, specs[1], dev), tokens,
                torch.tensor(DECODE_POS, dtype=torch.int32, device=dev))
    batch = (bst_cell_batch(torch, np, cell, dev) if cell.arch == "bst"
             else gnn_cell_batch(torch, cell, dev, gen))
    if cell.kind == "train":
        return params, zeros_tree(torch, cell.arg_specs[1], dev), batch
    return params, batch


def measure_cell(torch, np, cell, dev):
    """The cell's step at its full shape: the peak memory of its first
    call above what was allocated before its inputs were made, then the
    median of DRYRUN_REPEATS CUDA-event timings; every float output
    finite."""
    from repro_torch.models.common import tree_leaves

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    args = cell_inputs(torch, np, cell, dev)
    torch.cuda.synchronize()
    make_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    out = cell.step_fn(*args)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    leaves = out if isinstance(out, (tuple, list)) else (out,)
    floats = [t for t in tree_leaves(list(leaves))
              if isinstance(t, torch.Tensor) and t.is_floating_point()]
    check(all(bool(torch.isfinite(t).all()) for t in floats),
          (cell.name, "a non-finite output"))
    del out, leaves, floats
    ms = cuda_ms(torch, lambda: cell.step_fn(*args), DRYRUN_REPEATS)
    del args
    torch.cuda.empty_cache()
    return {"ms": ms, "peak": peak, "make_s": make_s}


def run_module(module, out, timeout):
    """``python -m repro_torch.launch.<module> --out <out>`` on the card;
    its stdout lines."""
    run = subprocess.run(
        [sys.executable, "-m", f"repro_torch.launch.{module}", "--out",
         str(out)], cwd=ROOT, capture_output=True, text=True,
        timeout=timeout, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    check(run.returncode == 0, (module, run.returncode, run.stderr[-2000:]))
    return run.stdout.strip().splitlines()


def phase_dryrun(torch, np, dev, smi, tmp):
    """``python -m repro_torch.launch.dryrun --all --mesh all`` runs in
    the background (it traces on the meta device: host work only) while
    the held cells run at full shape on the card, one after another, and
    then both hill-climbs; each held cell's traced peak (argument +
    temporary bytes) must lie within PEAK_RTOL of its measured peak, and
    its median step must not fall under the traced memory time of its
    ops that overflow the L2 nor, where no kernel of ours runs, under the
    traced compute time."""
    from repro_torch.configs.base import all_archs

    t_phase = time.perf_counter()
    # the libraries' persistent workspaces (cuBLAS, cuBLASLt) are taken at
    # their first product, not by any cell's step: take them before the
    # first baseline
    before = torch.cuda.memory_allocated()
    for dtype in (torch.float32, torch.bfloat16):
        a = torch.ones((64, 64), dtype=dtype, device=dev)
        torch.matmul(a, a)
        torch.bmm(a[None], a[None])
    del a
    torch.cuda.synchronize()
    log(f"[dryrun] library workspaces held before the cells: "
        f"{(torch.cuda.memory_allocated() - before) / 2**20:.1f} MiB taken "
        "now (earlier phases may have taken them already)")
    out = tmp / "dryrun.jsonl"
    log_path = tmp / "dryrun.log"
    with open(log_path, "w") as sweep_log:
        sweep = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
             "--mesh", "all", "--out", str(out)], cwd=ROOT,
            stdout=sweep_log, stderr=subprocess.STDOUT, text=True,
            env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
        try:
            archs = all_archs()
            measured = {}
            for arch, shape in HELD_CELLS:
                cell = next(c for c in archs[arch].cells()
                            if c.shape == shape)
                measured[cell.name] = (cell, measure_cell(torch, np, cell,
                                                          dev))
            t_held = time.perf_counter() - t_phase
            hill = {m: run_module(m, tmp / f"{m}.jsonl", 900)
                    for m in ("hillclimb_gemma", "hillclimb_bst")}
            rc = sweep.wait(timeout=900)
        finally:
            if sweep.poll() is None:
                sweep.kill()
                sweep.wait()
    t_sweep = time.perf_counter() - t_phase
    lines = log_path.read_text().strip().splitlines()
    check(rc == 0 and bool(lines) and lines[-1] == DRYRUN_DONE,
          ("the dry-run sweep", rc, lines[-5:]))
    recs = {(r["cell"], r["mesh"]): r for r in
            (json.loads(line) for line in out.read_text().splitlines())}
    check(len(recs) == 132, ("dry-run records", len(recs)))
    card = [r for r in recs.values() if r["mesh"] == "1"
            and r["status"] == "ok"]
    name = torch.cuda.get_device_name(0)
    check(all(r["card"] == name and r["power_limit"]
              and isinstance(r["fits_card"], bool) for r in card),
          "dry-run records without the card's name and power limit")
    slow = sorted(card, key=lambda r: -r["t_lower_s"])[:3]
    log(f"[dryrun] sweep: {lines[-1]} in {t_sweep:.1f} s of wall time "
        f"(in the background while the held cells ran, {t_held:.1f} s, and "
        f"the hill-climbs); traces {sum(r['t_lower_s'] for r in card):.1f} "
        f"s in all, longest "
        + ", ".join(f"{r['cell']} {r['t_lower_s']:.1f} s" for r in slow)
        + f"; {sum(r['fits_card'] for r in card)} of {len(card)} traced "
        f"cells fit the card")
    for cell_name, (cell, m) in measured.items():
        rec = recs[(cell_name, "1")]
        roof, mem = rec["roofline"], rec["memory"]
        traced = mem["argument_bytes"] + mem["temp_bytes"]
        rel = (traced - m["peak"]) / m["peak"]
        tc, tm = roof["t_compute_s"] * 1e3, roof["t_memory_s"] * 1e3
        tm_l2 = roof["t_memory_over_l2_s"] * 1e3
        classes = ", ".join(f"{c} {n / 1e9:.1f}" for c, n in
                            sorted(roof["flops_by_class"].items()))
        log(f"[dryrun] {cell_name}: GFLOP {classes or 'none'}; "
            f"{roof['hbm_bytes'] / 1e9:.3f} GB moved "
            f"({roof['hbm_bytes_over_l2'] / 1e9:.3f} GB by ops over the L2); "
            f"Tc {tc:.3f} ms, Tm {tm:.3f} ms (over the L2 {tm_l2:.3f}), "
            f"{roof['dominant']}-bound; measured {m['ms']:.3f} ms (median of "
            f"{DRYRUN_REPEATS}, CUDA events), {m['ms'] / max(tc, tm):.3f}x "
            f"max(Tc, Tm); peak traced {traced / 1e9:.3f} GB (argument "
            f"{mem['argument_bytes'] / 1e9:.3f} + temporary "
            f"{mem['temp_bytes'] / 1e9:.3f}) vs measured "
            f"{m['peak'] / 1e9:.3f} GB ({rel:+.1%}); inputs made in "
            f"{m['make_s']:.1f} s")
        check(abs(rel) <= PEAK_RTOL,
              (cell_name, "traced peak off the measured", traced, m["peak"]))
        check(m["ms"] >= tm_l2,
              (cell_name, "faster than its traced memory time", m["ms"],
               tm_l2))
        if cell.arch != "kspdg":
            check(m["ms"] >= tc, (cell_name, "faster than its traced "
                                  "compute time", m["ms"], tc))
    for module, out_lines in hill.items():
        for line in out_lines:
            log(f"[dryrun] {module}: {line}")
    log(f"[dryrun] {smi}; phase passed in "
        f"{time.perf_counter() - t_phase:.1f} s")


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
    index_launches, index_timings = phase_index_build(torch, np)
    timings.update(index_timings)
    launches, answers = phase_serving(torch, np)
    launches = {name: n + index_launches[name]
                for name, n in launches.items()}
    torch.cuda.empty_cache()
    mesh_refine = phase_mesh_refine(torch, dev,
                                    timings["bf_solve_grouped"]["ms"])
    torch.cuda.empty_cache()
    mesh_serving = phase_mesh_serving(torch, np, answers)
    launches = {name: n + mesh_serving["barrier"]["launches"][name]
                for name, n in launches.items()}
    phase_driver()
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
    timings["bf_solve_grouped"]["mesh_refine"] = mesh_refine
    timings["bf_solve_grouped"]["mesh_serving"] = mesh_serving
    phase_kspdg_smoke()
    torch.cuda.empty_cache()
    phase_lm_serving(torch, np, dev, smi)
    torch.cuda.empty_cache()
    phase_training(torch, np, dev, smi)
    torch.cuda.empty_cache()
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        phase_dryrun(torch, np, dev, smi, Path(tmp))

    sources = {  # kernel -> (CUDA source, the TPU kernel it replaces)
        "bf_relax_step": ("bf_relax.cu", "src/repro/kernels/bf_relax.py:69"),
        "bf_solve_grouped": ("bf_relax.cu",
                             "src/repro/kernels/bf_relax.py:69"),
        "ktrop_relax_step": ("ktrop.cu", "src/repro/kernels/ktrop.py:56"),
        "ktrop_solve": ("ktrop.cu", "src/repro/kernels/ktrop.py:56"),
        "bound_dist": ("bound_dist.cu",
                       "src/repro/kernels/bound_dist.py:36"),
        "level_walks": ("level_walk.cu", "none (the host walk, "
                        "src/repro/core/bounding.py::extract_level_path)"),
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
