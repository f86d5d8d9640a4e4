"""One run of one cell: set-up, the measured window, the drain, the check.

Set-up (all of it inside ``setup_s``): the configuration's road network
from its fixed graph seed, the run's traffic drawn from ``--seed``, the
program's DTLP index and ``KSPService`` built through the program's own
path, and a warm-up that serves a fixed set of trips (and, where the
traffic carries a weight feed, applies its fixed warm batches) so that
every kernel is built and loaded before the window opens.

The window drives ``KSPService.submit``, ``KSPService.update(...,
wait=False)`` and ``KSPService.tick`` from this file's own host clock.
A query's latency runs from the instant it was due to the return of the
tick that answered it.  After ``seconds``, nothing new is sent and the
queries already due are drained; one still unanswered ``DRAIN_S``
seconds after the window is failed, and its latency is +inf.  An update
batch is visible from the first tick after which the service's epoch
includes it.

After the drain, the peak device memory is read, the service is freed,
and every answer is held to the plain reference (``reference.judge``).
"""

from __future__ import annotations

import dataclasses
import gc
import heapq
import importlib.util
import json
import math
import time
from pathlib import Path

import numpy as np

from kspbench import reference, roadgen, roofline

ROOT = Path(__file__).resolve().parent

#: trips served in the warm-up, drawn from a fixed stream (not the seed)
WARM_QUERIES = 16
WARM_SEED = 11
#: seconds after the window's close that the drain waits for answers
DRAIN_S = 60.0

clock = time.perf_counter


def load_json(kind: str, name: str) -> dict:
    """``kspbench/<kind>/<name>.json``."""
    return json.loads((ROOT / kind / f"{name}.json").read_text())


def load_module(path: Path):
    """Import a file of the harness found by name (metric readers and
    traffic kinds, whose names may hold dots)."""
    spec = importlib.util.spec_from_file_location(
        "kspbench_" + path.stem.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def build_net(cfg: dict) -> roadgen.RoadNet:
    gen = getattr(roadgen, cfg["generator"])
    return gen(cfg["rows"], cfg["cols"], knockout=cfg["knockout"],
               shortcut_frac=cfg["shortcut_frac"], w_low=cfg["w_low"],
               w_high=cfg["w_high"], directed=cfg["directed"],
               seed=cfg["graph_seed"])


def make_sources(traffic: dict, net, seed: int, seconds: float) -> list:
    """One source per stream of the mix, each on its own generator drawn
    from (seed, stream index)."""
    out = []
    for i, stream in enumerate(traffic["streams"]):
        mod = load_module(ROOT / "traffic" / "kinds" / f"{stream['kind']}.py")
        rng = np.random.default_rng(np.random.SeedSequence([seed % 2**64, i]))
        out.append(mod.Source(stream, net, rng, seconds))
    return out


@dataclasses.dataclass
class Served:
    """A built and warmed service, and what the reference needs to know
    of its starting state."""

    svc: object
    w_base: np.ndarray  # weights at epoch_base (the warm batches applied)
    epoch_base: int
    build: dict  # the DTLP build's own timings and sizes


def set_up(cfg: dict, net, qstream: dict, warm_batches, device: str,
           log) -> Served:
    """Build the index and the service on ``net``; warm them up with the
    warm batches and ``WARM_QUERIES`` trips shaped like ``qstream``'s."""
    from repro_torch import obs
    from repro_torch.core.graph import Graph
    from repro_torch.service import (KSPService, QueryRequest, ServiceConfig,
                                     UpdateBatch)

    obs.disable()
    graph = Graph(net.n, net.edge_u, net.edge_v, net.w0,
                  directed=net.directed)
    engine = cfg["engine"] if device == "cuda" else "dense_bf"
    svc = KSPService.build(graph, ServiceConfig(
        engine=engine, device=device, n_workers=cfg["n_workers"],
        max_in_flight=cfg["max_in_flight"], z=cfg["z"], xi=cfg["xi"],
        update_mode=cfg["update_mode"]))
    st = svc.dtlp.stats
    log(f"[setup] {net.n} vertices {net.m} edges; DTLP z={cfg['z']} "
        f"xi={cfg['xi']} built in {st.total_s:.2f} s (bounding "
        f"{st.bounding_s:.2f} s)")
    for eids, new_w in warm_batches:
        svc.update(UpdateBatch(eids, new_w))
    for s, t in roadgen.local_trips(net, WARM_QUERIES,
                                    np.random.default_rng(WARM_SEED),
                                    int(qstream["lo"]), int(qstream["hi"])):
        svc.submit(QueryRequest(s, t, int(qstream["k"])))
    svc.drain()
    if device == "cuda":
        import torch

        torch.cuda.synchronize()
    return Served(svc, reference.weights_at(net.w0, warm_batches,
                                            len(warm_batches)),
                  svc.epoch, dataclasses.asdict(st))


@dataclasses.dataclass
class Query:
    s: int
    t: int
    k: int
    due: float
    epoch_lo: int
    source: tuple  # (source index, event): a source may send on an answer
    ticket: object = None
    done: float | None = None
    epoch_hi: int | None = None
    failed: str | None = None


class KernelRecorder:
    """Wraps ``repro_torch.kernels.ops.bf_solve_grouped`` during a traced
    run and records each call's host time and (S, J, z); records only."""

    def __init__(self, ops):
        self.ops = ops
        self.orig = ops.bf_solve_grouped
        self.calls: list = []

        def recording(adj, init, *args, **kw):
            S, J, z = init.shape
            self.calls.append((clock(), int(S), int(J), int(z)))
            return self.orig(adj, init, *args, **kw)

        ops.bf_solve_grouped = recording

    def restore(self):
        self.ops.bf_solve_grouped = self.orig


def _worker_counts(svc) -> dict:
    """Refine tasks the workers were handed, and those their partial-KSP
    caches answered, summed over the cluster."""
    ws = [w.stats for w in svc.cluster.workers]
    return {"tasks": sum(s.tasks for s in ws),
            "cache_hits": sum(s.cache_hits for s in ws),
            "reissues": svc.cluster.reissues,
            "auto_slowed": svc.cluster.auto_slowed}


def serve(srv: Served, sources, *, seconds: float, trace: bool,
          device: str, drain_s: float = DRAIN_S) -> dict:
    """The measured window and the drain; returns the run's record (the
    answers themselves under ``answers``)."""
    from repro_torch import obs
    from repro_torch.engine import layout
    from repro_torch.kernels import ops
    from repro_torch.service import AdmissionError, QueryRequest, UpdateBatch

    svc = srv.svc
    heap: list = []
    for src_i, src in enumerate(sources):
        for ev in src.initial():
            heapq.heappush(heap, (ev["due"], len(heap), src_i, ev))
    seq = len(heap)
    queries: list[Query] = []
    by_ticket: dict = {}
    updates: list = []  # [due, sent, visible, eids, new_w]
    harness_spans: list = []  # (name, t0, t1) of this file's own work
    lateness: list = []
    outstanding = 0

    recorder = prof = None
    if trace:
        obs.enable(trace=True)
        recorder = KernelRecorder(ops)
    transfer0 = dict(layout.TRANSFER_STATS)
    stats0 = dataclasses.asdict(svc.scheduler.stats)
    workers0 = _worker_counts(svc)
    if trace and device == "cuda":
        import torch

        from kspbench import devtrace

        prof = devtrace.start(torch)
        t0 = devtrace.mark(torch, device)
    else:
        t0 = clock()
    close = t0 + seconds

    def pending_work():
        return bool(svc.scheduler.queue or svc.scheduler.active
                    or svc.epoch < srv.epoch_base + len(updates))

    while True:
        now = clock()
        while heap and heap[0][0] < seconds and t0 + heap[0][0] <= now:
            due, _, src_i, ev = heapq.heappop(heap)
            ts = clock()
            lateness.append(ts - (t0 + due))
            if ev["kind"] == "update":
                svc.update(UpdateBatch(ev["eids"], ev["new_w"]), wait=False)
                updates.append([due, ts - t0, None, ev["eids"], ev["new_w"]])
            else:
                q = Query(ev["s"], ev["t"], ev["k"], due, svc.epoch,
                          (src_i, ev))
                try:
                    q.ticket = svc.submit(QueryRequest(q.s, q.t, q.k))
                    by_ticket[id(q.ticket)] = q
                    outstanding += 1
                except AdmissionError as e:
                    q.failed = e.reason
                queries.append(q)
            harness_spans.append(("harness.submit", ts, clock()))
        if now >= close and not outstanding and not pending_work():
            break
        if now >= close + drain_s:
            break
        if pending_work():
            ts = clock()
            done = svc.tick()
            te = clock()
            harness_spans.append(("harness.tick", ts, te))
            for tk in done:
                q = by_ticket.pop(id(tk), None)
                if q is None:
                    continue
                outstanding -= 1
                q.done = te - t0
                q.epoch_hi = svc.epoch
                if tk.rejected is not None:
                    q.failed = tk.rejected
                src_i, ev = q.source
                if te < close:
                    for nxt in sources[src_i].answered(ev, te - t0):
                        heapq.heappush(heap, (nxt["due"], seq, src_i, nxt))
                        seq += 1
            for i, u in enumerate(updates):
                if u[2] is None and svc.epoch >= srv.epoch_base + i + 1:
                    u[2] = te - t0
        else:
            nxt = heap[0][0] if heap and heap[0][0] < seconds else seconds
            wait = t0 + nxt - clock()
            if wait > 0:
                ts = clock()
                time.sleep(min(wait, 0.002))
                harness_spans.append(("harness.idle", ts, clock()))
    t_end = clock()

    rec = {"seconds": seconds, "drain_s": t_end - close, "t0": t0,
           "lateness": lateness, "harness_spans": harness_spans,
           "device_trace": None, "spans": {}, "calls": []}
    if trace:
        if prof is not None:
            from kspbench import devtrace

            rec["device_trace"] = devtrace.read(prof, t0, seconds)
        for r in obs.get_collector().spans():
            rec["spans"].setdefault(r.name, []).append((r.ts, r.ts + r.dur))
        obs.disable()
        recorder.restore()
        rec["calls"] = [c for c in recorder.calls if t0 <= c[0] < close]
    rec["transfer"] = {k: v - transfer0.get(k, 0)
                       for k, v in layout.TRANSFER_STATS.items()}
    stats1 = dataclasses.asdict(svc.scheduler.stats)
    rec["sched"] = {k: stats1[k] - stats0[k] for k in
                    ("tasks_requested", "tasks_dispatched",
                     "batches_dispatched", "admitted", "completed")}
    rec["workers"] = {k: v - workers0[k]
                      for k, v in _worker_counts(svc).items()}

    answers, qrec = [], []
    for q in queries:
        res = q.ticket.result if q.ticket is not None else None
        if q.failed is None and q.done is None:
            q.failed = "unanswered"
        if res is not None and q.failed is None:
            if not res.paths:
                q.failed = "empty"
            elif res.truncated:
                q.failed = "truncated"
        qrec.append({
            "s": q.s, "t": q.t, "due": q.due, "done": q.done,
            "failed": q.failed,
            "latency": q.done - q.due if q.failed is None else math.inf,
            "iterations": res.stats.iterations if res else 0,
        })
        if res is not None and q.failed in (None, "empty"):
            answers.append({"s": q.s, "t": q.t, "k": q.k,
                            "paths": [(float(d), tuple(p))
                                      for d, p in res.paths],
                            "epoch": res.epoch, "epoch_lo": q.epoch_lo,
                            "epoch_hi": q.epoch_hi})
    rec["queries"] = qrec
    rec["answers"] = answers
    rec["updates"] = [(u[0], u[1], u[2]) for u in updates]
    rec["batches"] = [(u[3], u[4]) for u in updates]
    return rec


def run_cell(cfg: dict, traffic: dict, *, seed: int, seconds: float,
             trace: bool, device: str, t_start: float, log,
             drain_s: float = DRAIN_S) -> dict:
    """Run one cell once; returns the record the metric readers read."""
    net = build_net(cfg)
    sources = make_sources(traffic, net, seed, seconds)
    qstream = next(s for s in traffic["streams"] if "k" in s)
    srv = set_up(cfg, net, qstream,
                 [b for s in sources for b in s.warm_batches], device, log)
    gc.collect()
    gc.freeze()  # the index's objects: out of the collector's way
    rec = serve(srv, sources, seconds=seconds, drain_s=drain_s, trace=trace,
                device=device)
    rec["setup_s"] = rec["t0"] - t_start
    rec["build"] = srv.build
    if device == "cuda":
        import torch

        torch.cuda.synchronize()
        rec["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated())
        rec["kind"] = torch.cuda.get_device_name(0)
    else:
        rec["memory_peak_bytes"], rec["kind"] = 0, "cpu"
    rec["roofline_bound_s"] = [
        roofline.bound_s(rec["kind"], roofline.bf_solve_grouped_bytes(S, J, z))
        for _, S, J, z in rec["calls"]]

    w_base, epoch_base = srv.w_base, srv.epoch_base
    del srv
    gc.unfreeze()
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    t_ref = clock()
    adj = reference.Adjacency(net.n, net.edge_u, net.edge_v, net.directed)
    rec["verdict"] = reference.judge(adj, w_base, rec["batches"],
                                     rec["answers"], epoch_base=epoch_base)
    log(f"[check] {rec['verdict']['checked']} answers held to the reference "
        f"in {clock() - t_ref:.2f} s")
    return rec
