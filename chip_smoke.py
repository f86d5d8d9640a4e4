#!/usr/bin/env python3
"""On-card smoke test of the repro_torch port (NVIDIA H100).

    python3 chip_smoke.py

Drives the port on one CUDA card and fails (non-zero exit) on the first
phase that does not hold:

1. environment: torch/CUDA versions and the card's name and power limit;
2. build: compiles every CUDA source of ``src/repro_torch/csrc`` with
   nvcc (one process per source, all at once) and prints ptxas' report;
3. kernels at ragged shapes: ``bf_relax_step`` and ``bf_solve_grouped``
   against their plain PyTorch versions on the same inputs, bitwise;
4. the fused solve at the refine_dense shape (S=8192 slab rows, z=256,
   J=32) on road-like adjacency with Yen-style masks and finite caps:
   both kernels against their plain versions on every row, bitwise, and
   timed with CUDA events beside their bounds;
5. serving: ``KSPService(engine="cuda_bf", device="cuda")`` answers 32
   queries (trips of 8-16 hops), one UpdateBatch, and 32 more on a
   64x64 road grid; the same trace on the port's plain ``dense_bf``
   engine must give the same (paths, epoch), a few answers must match
   host Yen on the full graph, and the serving run must have launched
   ``bf_solve_grouped``.

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
def ragged_inputs(np, rng, S, J, z, one_hot):
    """Slab, mid-relaxation distances and masks (general or Yen-style),
    finite caps, and an all-INF padding problem."""
    from repro_torch.kernels.ref import INF

    adj = rng.uniform(1.0, 50.0, (S, z, z)).astype(np.float32)
    adj[rng.random((S, z, z)) > 0.3] = INF
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
    init[:, J - 1, :] = INF  # a padding problem must no-op
    so[:, J - 1, :] = False
    return adj, init, bv, so, bn, cap


def road_inputs(torch, S, J, z, device):
    """refine_dense-sized solve inputs made on the card from a seed: each
    slab row a 16x16 road grid (2-4 neighbours per vertex, integer weights
    1-100, 0 diagonal); each problem a Yen spur search with a one-hot spur
    (its source), banned root-path vertices, banned next hops and a
    finite cap."""
    from repro_torch.kernels.ref import INF

    gen = torch.Generator(device=device).manual_seed(SEED)
    side = int(round(z ** 0.5))
    v = torch.arange(z, device=device)
    r, c = v // side, v % side
    right, down = v[c < side - 1], v[r < side - 1]
    eu = torch.cat([right, down])
    ev = torch.cat([right + 1, down + side])
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


def phase_ragged(torch, np, dev):
    from repro_torch.engine import dense
    from repro_torch.kernels import ops, ref

    rng = np.random.default_rng(SEED)
    shapes = [(3, 1, 96), (2, 3, 200), (4, 8, 128), (2, 40, 33),
              (1, 5, 1000), (5, 32, 256)]
    for S, J, z in shapes:
        for one_hot in (False, True):
            args = [torch.from_numpy(a).to(dev) for a in
                    ragged_inputs(np, rng, S, J, z, one_hot)]
            adj, init, bv, so, bn, cap = args
            got = ops.bf_relax_step(init, adj, so, bn, cap)
            want = ref.bf_relax_ref(init, adj, so, bn, cap)
            check(torch.equal(got, want), ("bf_relax_step", S, J, z))
            d, p = ops.bf_solve_grouped(*args)
            wd, wp = ref.bf_solve_grouped_ref(*args)
            check(torch.equal(d, wd) and torch.equal(p, wp),
                  ("bf_solve_grouped", S, J, z, one_hot))
            if one_hot:  # the dense engine's formulation agrees too
                dd, _ = dense.bf_solve_grouped(adj, init, bv, so, bn, cap=cap)
                check(torch.equal(d, dd), ("dense dist", S, J, z))
                dp = dense.bf_parents_grouped(adj, dd, so, bn)
                check(torch.equal(p, dp), ("dense parents", S, J, z))
    torch.cuda.synchronize()
    log(f"[ragged] bf_relax_step and bf_solve_grouped bitwise equal to plain "
        f"at (S,J,z) in {shapes}, general and one-hot masks")


def phase_refine_dense(torch, dev):
    from repro_torch.engine import dense
    from repro_torch.kernels import bf_relax, ops, ref

    S, J, z = DENSE_S, DENSE_J, DENSE_Z
    adj, init, bv, so, bn, cap = road_inputs(torch, S, J, z, dev)
    torch.cuda.synchronize()
    adj_bytes = adj.numel() * 4
    log(f"[refine_dense] S={S} J={J} z={z}: adjacency "
        f"{adj_bytes / 2**30:.2f} GiB on the card")
    rows = torch.arange(S, device=dev)

    # --- one relaxation (bf_relax_step)
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
    step_bound, step_by = bound_ms(adj_bytes + n * 4 * 2 + n * 2 + S * J * 4,
                                   2.0 * S * J * z * z)
    log(f"[refine_dense] bf_relax_step: {step_ms:.3f} ms (median of 7), "
        f"plain {step_plain_ms:.1f} ms, bound {step_bound:.3f} ms "
        f"({step_by}), bitwise equal on all {S} rows")

    # --- the fused fixed point with parents (bf_solve_grouped)
    dist, parent, iters = bf_relax.solve_grouped(adj, init, bv, so, bn, cap)
    solve_ms = cuda_ms(
        torch, lambda: ops.bf_solve_grouped(adj, init, bv, so, bn, cap),
        repeats=5)
    start.record()
    want_d, want_p = chunked(torch, ref.bf_solve_grouped_ref, S,
                             adj, init, bv, so, bn, cap)
    end.record()
    torch.cuda.synchronize()
    solve_plain_ms = start.elapsed_time(end)
    check(torch.equal(dist, want_d), "bf_solve_grouped dist differs")
    check(torch.equal(parent, want_p), "bf_solve_grouped parents differ")
    # the dense engine's formulation on a subset of rows (one-hot spurs)
    sub = rows[:: S // 64]
    dd, _ = dense.bf_solve_grouped(adj[sub], init[sub], bv[sub], so[sub],
                                   bn[sub], cap=cap[sub])
    dp = dense.bf_parents_grouped(adj[sub], dd, so[sub], bn[sub])
    check(torch.equal(dd, dist[sub]) and torch.equal(dp, parent[sub]),
          "the dense engine's solve differs on the checked rows")
    it = iters.double()
    relax_pairs = float(iters.long().sum()) * J * z * z  # this run's work
    solve_bound, solve_by = bound_ms(
        adj_bytes + n * 4 * 3 + n * 3 + S * J * 4,
        2.0 * relax_pairs + 2.0 * S * J * z * z)
    reached = (dist < ref.INF / 2).double().mean()
    log(f"[refine_dense] bf_solve_grouped: {solve_ms:.3f} ms (median of 5), "
        f"plain {solve_plain_ms:.1f} ms, bound {solve_bound:.3f} ms "
        f"({solve_by}); iterations per block max {int(it.max())} mean "
        f"{float(it.mean()):.2f}; reached share {float(reached):.3f}; "
        f"dist and parents bitwise equal on all {S} rows")
    return {
        "bf_relax_step": dict(ms=step_ms, plain_ms=step_plain_ms,
                              bound_ms=step_bound, bound_by=step_by,
                              max_abs_err=step_err),
        "bf_solve_grouped": dict(ms=solve_ms, plain_ms=solve_plain_ms,
                                 bound_ms=solve_bound, bound_by=solve_by,
                                 max_abs_err=max_abs_err(torch, dist, want_d)),
    }


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
    phase_ragged(torch, np, dev)
    timings = phase_refine_dense(torch, dev)
    launches = phase_serving(torch, np)

    replaces = "src/repro/kernels/bf_relax.py:69"
    kernels = [
        dict(name=name, route="cuda", source="src/repro_torch/csrc/bf_relax.cu",
             replaces=replaces, launches=launches[name], library_ms=None,
             **timings[name])
        for name in ("bf_relax_step", "bf_solve_grouped")
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
