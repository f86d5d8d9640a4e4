"""KSP serving driver — the paper's deployment (Fig. 12) end to end:
a dynamic road network, streaming weight updates, concurrent KSP queries
batched across a worker cluster, with failure/straggler injection.

Everything goes through the typed ``repro_torch.service.KSPService``
facade:
argv builds ONE ``ServiceConfig``, queries are ``QueryRequest``s (with
an optional ``--deadline-ms`` SLO that rejects by predicted queue
delay), update batches are ``UpdateBatch``es applied behind the epoch
barrier, and every answer reports the graph epoch that served it.

Slab engines run on the card unless ``--device cpu`` asks for the CPU;
with no card and no ``--device cpu`` the driver fails (nothing falls
back).

    PYTHONPATH=src python -m repro_torch.launch.serve --engine cuda_bf \
        --rows 16 --cols 16 --workers 8 --queries 50 --epochs 3 \
        --concurrency 8 --kill 3
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.data.roadnet import WeightUpdateStream, grid_road_network
from repro_torch.dist.cluster import resolve_device
from repro_torch.service import (
    VARIANTS,
    BoundedKSPRequest,
    DiverseKSPRequest,
    KSPService,
    OneToManyRequest,
    QueryRequest,
    ServiceConfig,
    UpdateBatch,
    available_engines,
    available_ref_streams,
)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=14)
    ap.add_argument("--cols", type=int, default=14)
    ap.add_argument("--z", type=int, default=24)
    ap.add_argument("--xi", type=int, default=6)
    ap.add_argument("--k", type=int, default=3)
    ap.add_argument("--workers", type=int, default=8)
    ap.add_argument("--queries", type=int, default=40, help="per epoch")
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--alpha", type=float, default=0.5)
    ap.add_argument("--tau", type=float, default=0.5)
    ap.add_argument("--kill", type=int, default=None, help="kill this worker after epoch 1")
    ap.add_argument("--revive", action="store_true",
                    help="revive the killed worker one epoch later "
                    "(its replica re-syncs the missed batch before serving)")
    ap.add_argument(
        "--engine", choices=available_engines(), default="pyen",
        help="refine engine spec: pyen (host Yen), dense_bf (plain "
        "PyTorch grouped BF), cuda_bf (the fused Hopper kernel; its plain "
        "version on the CPU — identical answers to dense_bf)",
    )
    ap.add_argument(
        "--ref-stream", choices=available_ref_streams(), default=None,
        help="reference-path stream for KSP-DG's filter phase: lazy "
        "(Eppstein-style deviation walks, the engine default — immune to "
        "the corridor-ties truncation mode) or yen (simple-path "
        "fallback); default inherits the engine spec",
    )
    ap.add_argument(
        "--device", choices=("cuda", "cpu"), default="cuda",
        help="where slab engines keep their slabs and run their solves "
        "(the card unless the CPU is asked for; no fallback)",
    )
    ap.add_argument(
        "--mesh", action="store_true",
        help="route the grouped refine through the multi-device refine "
        "over a mesh of the visible cards (one logical shard on the CPU) "
        "with device-resident split slabs (works with any mesh-capable "
        "engine: dense_bf, cuda_bf)",
    )
    ap.add_argument(
        "--distributed", action="store_true",
        help="initialize torch.distributed before building the mesh "
        "(multi-process serving: coordinator from REPRO_COORDINATOR + "
        "REPRO_NUM_PROCESSES/REPRO_PROCESS_ID, or a launcher's env:// "
        "environment with REPRO_DISTRIBUTED_AUTO=1)",
    )
    ap.add_argument(
        "--variant", choices=VARIANTS, default="ksp",
        help="query workload: ksp (plain top-k), diverse (k mutually "
        "dissimilar paths; --min-dist/--cost-add), bounded (every path "
        "within --stretch of the shortest, at most k), one_to_many (one "
        "source to --targets targets; all variants share the same "
        "scheduler and grouped solves — see docs/workloads.md)",
    )
    ap.add_argument(
        "--stretch", type=float, default=1.2,
        help="bounded: answer = all paths with d ≤ stretch × d₀ (≥ 1)",
    )
    ap.add_argument(
        "--min-dist", type=float, default=0.3,
        help="diverse: required pairwise dissimilarity in (0, 1] — any "
        "two answers share at most 1−min_dist of their edges",
    )
    ap.add_argument(
        "--cost-add", type=float, default=None,
        help="diverse: optional detour cap — no answer costs more than "
        "(1+cost_add) × d₀",
    )
    ap.add_argument(
        "--targets", type=int, default=3,
        help="one_to_many: number of random targets per query",
    )
    ap.add_argument(
        "--concurrency", type=int, default=8,
        help="max in-flight queries per scheduler tick (1 = sequential)",
    )
    ap.add_argument(
        "--batch-window", type=float, default=2.0,
        help="ms to wait for more arrivals before starting an "
        "under-occupied tick (latency-for-throughput knob)",
    )
    ap.add_argument(
        "--arrival-rate", type=float, default=200.0,
        help="Poisson arrival rate, queries/sec on the simulated clock",
    )
    ap.add_argument(
        "--max-queue", type=int, default=0,
        help="bounded admission queue capacity; 0 = unbounded "
        "(overflowing queries are rejected and counted)",
    )
    ap.add_argument(
        "--deadline-ms", type=float, default=0.0,
        help="per-query latency SLO: reject when the predicted queue "
        "delay (tick-latency EWMA × queue depth) exceeds this; 0 disables",
    )
    ap.add_argument(
        "--straggler-factor", type=float, default=8.0,
        help="auto-bench a worker whose task-latency EWMA exceeds this "
        "multiple of the fleet median; 0 disables",
    )
    ap.add_argument(
        "--update-mode", choices=("barrier", "streaming"), default="barrier",
        help="how UpdateBatches land: barrier (freeze admission, drain "
        "in-flight, apply — the reference) or streaming (prepare the next "
        "epoch in shadow buffers, pointer-swap handoff, no drain)",
    )
    ap.add_argument(
        "--rebaseline-drift", type=float, default=0.05,
        help="re-anchor DTLP bounds when mean weight drift exceeds this "
        "(loose bounds blow up KSP-DG iteration counts); 0 disables. "
        "This driver streams heavy updates every epoch, so its default "
        "(0.05) is deliberately more aggressive than ServiceConfig's "
        "general-purpose 0.3",
    )
    ap.add_argument(
        "--trace", metavar="PATH", default=None,
        help="capture a Chrome-trace/Perfetto JSON of the whole run "
        "(admission, queue wait, dispatch, device solve, host splice, "
        "epoch prepare/commit as per-worker timelines) to this path; "
        "open at https://ui.perfetto.dev",
    )
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    resolve_device(args.device)  # no card: fail here, never fall back

    if args.trace:
        from repro_torch import obs

        obs.enable(trace=True)

    mesh = None
    engine = args.engine
    if args.distributed:
        from repro_torch.launch.mesh import init_distributed

        if init_distributed(device=args.device):
            import torch.distributed as dist

            print(f"torch.distributed initialized: process "
                  f"{dist.get_rank()}/{dist.get_world_size()} "
                  f"({dist.get_backend()})")
        else:
            print("--distributed: no coordinator configured; "
                  "continuing single-process with local devices")
    if args.mesh:
        from repro_torch.service import get_engine

        spec = get_engine(engine)
        if not spec.supports_mesh:
            meshable = [e for e in available_engines()
                        if get_engine(e).supports_mesh]
            ap.error(
                f"--mesh: engine {engine!r} has no device-mesh path; "
                f"mesh-capable engines: {', '.join(meshable)}"
            )
        from repro_torch.launch.mesh import make_host_mesh

        mesh = make_host_mesh(device=args.device)
        print(f"mesh refine over a {mesh.size}x1 device mesh "
              f"({engine}, {[str(d) for d in mesh.devices]} in process "
              f"{mesh.rank}/{mesh.n_processes}, device-resident split "
              f"slabs)")

    cfg = ServiceConfig(
        engine=engine,
        n_workers=args.workers,
        max_in_flight=args.concurrency,
        max_queue=args.max_queue if args.max_queue > 0 else None,
        batch_window_ms=args.batch_window,
        z=args.z,
        xi=args.xi,
        mesh=mesh,
        device=args.device,
        straggler_factor=(args.straggler_factor
                          if args.straggler_factor > 0 else None),
        rebaseline_drift=args.rebaseline_drift,
        ref_stream=args.ref_stream,
        update_mode=args.update_mode,
    )
    g = grid_road_network(args.rows, args.cols, seed=args.seed)
    print(f"road network: {g.n} vertices, {g.m} edges")
    t0 = time.time()
    svc = KSPService.build(g, cfg)
    d = svc.dtlp
    print(
        f"DTLP built in {time.time() - t0:.2f}s: "
        f"{d.partition.n_subgraphs} subgraphs, |G_λ|={d.skeleton.n}, "
        f"{d.stats.n_paths} bounding paths "
        f"(EBP-II {d.stats.ebp_slots} → G-MPTree {d.stats.mptree_slots} slots)"
    )
    stream = WeightUpdateStream(g, alpha=args.alpha, tau=args.tau, seed=1)
    rng = np.random.default_rng(2)
    deadline = args.deadline_ms if args.deadline_ms > 0 else None

    def make_request(rng):
        if args.variant == "one_to_many":
            picks = rng.choice(g.n, size=args.targets + 1, replace=False)
            return OneToManyRequest(
                int(picks[0]), targets=tuple(map(int, picks[1:])),
                k=args.k, deadline_ms=deadline)
        s, t = map(int, rng.choice(g.n, size=2, replace=False))
        if args.variant == "diverse":
            return DiverseKSPRequest(s, t, k=args.k, min_dist=args.min_dist,
                                     cost_add=args.cost_add,
                                     deadline_ms=deadline)
        if args.variant == "bounded":
            return BoundedKSPRequest(s, t, k=args.k, stretch=args.stretch,
                                     deadline_ms=deadline)
        return QueryRequest(s, t, k=args.k, deadline_ms=deadline)

    total_empty = 0
    for epoch_i in range(args.epochs):
        if args.kill is not None and epoch_i == 1:
            svc.kill(args.kill)
            print(f"-- killed worker {args.kill}; replicas take over --")
        if args.kill is not None and args.revive and epoch_i == 2:
            svc.revive(args.kill)
            print(f"-- revived worker {args.kill}; it re-syncs missed "
                  f"update batches before serving --")
        reqs = [make_request(rng) for _ in range(args.queries)]
        gaps = rng.exponential(1.0 / args.arrival_rate, size=args.queries)
        arrivals = svc.scheduler.clock + np.cumsum(gaps)
        # per-epoch reporting: delta the counters, reset the gauges
        st = svc.scheduler.stats
        before = (st.ticks, st.tasks_requested, st.tasks_dispatched)
        rej_before = svc.stats.rejected
        slo_before = svc.stats.rejected_deadline
        st.max_queue_depth = 0
        st.max_in_flight = 0
        tickets = svc.replay(reqs, arrival_times=arrivals)
        served = [tk.result for tk in tickets if tk.result is not None]
        lat = np.array([r.latency_ms for r in served])
        truncated = sum(r.truncated for r in served)
        # empty results are real serving failures (disconnected endpoints
        # or truncation to nothing) — count them explicitly; an `assert`
        # here would be compiled away under `python -O`
        empty = sum(1 for r in served if not r.paths)
        total_empty += empty
        ticks, requested, dispatched = (
            st.ticks - before[0], st.tasks_requested - before[1],
            st.tasks_dispatched - before[2],
        )
        rejected = svc.stats.rejected - rej_before
        print(
            f"epoch {svc.epoch}: {len(served)}/{len(tickets)} queries | "
            f"p50 {np.percentile(lat, 50):6.1f}ms  "
            f"p99 {np.percentile(lat, 99):6.1f}ms | "
            f"ticks {ticks}  "
            f"peak queue {st.max_queue_depth}  "
            f"deduped {requested - dispatched}/{requested} tasks | "
            f"reissued so far: {svc.reissues}"
            + (f" | {truncated} truncated (best-effort)" if truncated else "")
            + (f" | {empty} EMPTY results" if empty else "")
            + (f" | {rejected} rejected "
               f"({svc.stats.rejected_deadline - slo_before} by SLO)"
               if rejected else "")
        )
        t0 = time.perf_counter()
        svc.update(UpdateBatch(*stream.next_batch()))
        dt = time.perf_counter() - t0
        print(
            f"  applied 1 update batch → epoch {svc.epoch} "
            f"({args.update_mode} + index maintenance {dt * 1e3:.1f}ms)"
        )
        if svc.stats.rebaselines:
            drift = d.drift()
            print(f"  drift-triggered rebaselines so far: "
                  f"{svc.stats.rebaselines} (current drift {drift:.3f})")
    if svc.resyncs:
        print(f"stale-replica re-syncs: {svc.resyncs} "
              f"(revived workers replayed missed batches before serving)")
    if total_empty:
        print(f"WARNING: {total_empty} queries returned no paths")
    if args.trace:
        from repro_torch import obs

        n_events = obs.export(args.trace)
        print(f"trace: {n_events} events → {args.trace} "
              f"(open at https://ui.perfetto.dev)")
    print("serving run complete — non-truncated queries exact against their epoch")


if __name__ == "__main__":
    main()
