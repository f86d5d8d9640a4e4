"""Lockstep Yen over the owner-aligned [S, J, z] grouped BF batch.

A dense worker receives one iteration's refine tasks — (subgraph row,
src, dst) partial-KSP problems on its packed slab — and runs ALL of them
through Yen's deviation paradigm in lockstep: every round, every active
task contributes its spur problems, and the whole round becomes ONE
grouped solve with problems co-located next to their subgraph's
adjacency row (zero gather — the layout ``engine.dense`` was designed
for, Section 6.1's SubgraphBolt batching).

Execution is pluggable: a :class:`repro_torch.engine.backend.SolverBackend`
supplies both the solve (the plain PyTorch ``bf_solve_grouped`` or the
fused Hopper kernel) and the bucket geometry (its ``SlabLayout`` owns
the hot-row packing rule); a mesh ``solver`` override (a
``shard_refine.make_refine_fn`` product) replaces the execution while
the backend keeps supplying geometry.  Round buffers go to the solve's ``device``
when dispatched; the host copies results back only in
``_collect_round``.

Exactness: per task this is exactly ``engine.yen_engine.engine_ksp`` —
the grouping changes the schedule, not the math.
"""

from __future__ import annotations

import numpy as np

from repro_torch import obs
from repro_torch.engine.backend import TorchBackend
from repro_torch.engine.dense import INF, to_device
from repro_torch.engine.yen_engine import _extract

_INF = float(INF)

_DEFAULT_BACKEND = TorchBackend()


def _dispatch_round(adj, jobs, solver, s_multiple, backend, gather=None,
                    device="cuda"):
    """Pack one round's jobs and ISSUE the grouped solve — non-blocking.

    ``jobs``: (row, spur, banned_v, banned_next, cap).  Packing goes
    through the backend layout's ``pack_round`` (fresh donation-safe
    scratch buffers, hot rows split across duplicates, bucket a multiple
    of ``s_multiple`` — the mesh's shard count when the solver is a mesh
    refine).  ``gather`` sources the round's adjacency from a
    device-resident slab copy instead of a host copy (see
    ``SlabLayout.pack_round``).  The buffers move to ``device`` and the
    solve is queued there; the backend's solve returns tensors the
    device is still computing while the host moves on (the host waits
    only in ``_collect_round``; a mesh refine reads its change flag once
    per iteration).

    Returns an opaque pending handle for ``_collect_round``, or None on
    zero jobs.
    """
    if not jobs:
        return None
    t0 = obs.clock()
    buffers, slots = backend.layout.pack_round(adj, jobs, s_multiple,
                                               gather=gather)
    solve = solver if solver is not None else backend.solve_grouped
    dist, parent = solve(*(to_device(b, device) for b in buffers))
    obs.span_at("dispatch_round", t0, obs.clock() - t0, jobs=len(jobs),
                adj_src="device" if gather is not None else "host")
    return dist, parent, slots


def _collect_round(pending):
    """Copy a dispatched round to numpy: per-job (dist[z], parent[z])
    rows in job order.  This is where the host actually waits on the
    device — everything between dispatch and collect overlapped."""
    if pending is None:
        return []
    dist, parent, slots = pending
    # the ``collect_round`` span: the host blocked on the round and its
    # copy back; its own clock pair, read only when tracing is on
    tracing = obs.enabled()
    if tracing:
        t0 = obs.clock()
    dist = dist.cpu().numpy()
    parent = parent.cpu().numpy()
    if tracing:
        obs.span_at("collect_round", t0, obs.clock() - t0, jobs=len(slots))
    return [(dist[sr, j], parent[sr, j]) for sr, j in slots]


def _solve_round(adj, jobs, solver, s_multiple, backend, gather=None,
                 device="cuda"):
    """One grouped solve, dispatch + collect back to back (the lockstep
    path and tests use this; the pipeline steps the two halves apart)."""
    return _collect_round(_dispatch_round(adj, jobs, solver, s_multiple,
                                          backend, gather, device))


class _TaskState:
    __slots__ = ("row", "src", "dst", "found", "found_set", "cand",
                 "cand_set", "done")

    def __init__(self, row: int, src: int, dst: int):
        self.row = row
        self.src = src
        self.dst = dst
        self.found: list = []
        self.found_set: set = set()
        self.cand: list = []
        self.cand_set: set = set()
        self.done = False

    def spur_jobs(self, adj_row, k, use_cap):
        """Next round's spur problems, exactly engine_ksp's inner loop."""
        z = adj_row.shape[0]
        _, prev = self.found[-1]
        pre = [0.0]
        for a, b in zip(prev, prev[1:]):
            pre.append(pre[-1] + float(adj_row[a, b]))
        jobs, meta = [], []
        for l in range(len(prev) - 1):
            spur = prev[l]
            root = prev[: l + 1]
            banned_next = np.zeros(z, bool)
            for _, fp in self.found:
                if len(fp) > l and fp[: l + 1] == root:
                    banned_next[fp[l + 1]] = True
            banned_v = np.zeros(z, bool)
            for v in root[:-1]:
                banned_v[v] = True
            cap = _INF
            if use_cap:
                need = k - len(self.found)
                if len(self.cand) >= need:
                    cap = self.cand[need - 1][0] - pre[l] + 1e-9
            jobs.append((self.row, spur, banned_v, banned_next, cap))
            meta.append((l, spur, pre[l], prev))
        return jobs, meta

    def absorb(self, meta, results):
        """Fold one round's spur results into the candidate list."""
        for (l, spur, pre_l, prev), (dist, parent) in zip(meta, results):
            if dist[self.dst] >= _INF / 2:
                continue
            tail = _extract(parent, spur, self.dst)
            if tail is None:
                continue
            full = tuple(prev[:l]) + tuple(tail)
            if full in self.found_set or full in self.cand_set:
                continue
            if len(set(full)) != len(full):
                continue
            self.cand_set.add(full)
            self.cand.append((pre_l + float(dist[self.dst]), full))

    def promote(self, k):
        """Pop the best candidate into found; mark done when finished."""
        if not self.cand:
            self.done = True
            return
        self.cand.sort(key=lambda x: (x[0], x[1]))
        best = self.cand.pop(0)
        self.cand_set.discard(best[1])
        self.found.append(best)
        self.found_set.add(best[1])
        if len(self.found) >= k:
            self.done = True


def grouped_ksp_async(adj, tasks, k: int, *, solver=None,
                      use_cap: bool = True, s_multiple: int = 1,
                      backend=None, gather=None, device="cuda"):
    """Generator form of :func:`grouped_ksp`: one ``yield`` per device
    round, placed AFTER the round's solve has been dispatched and BEFORE
    it is forced to numpy.

    While this generator sits suspended, the device is still chewing on
    the round — a pipelined scheduler resumes
    OTHER workers' generators in the gap, so host-side splice/absorb work
    and device solves overlap even though everything is single-threaded.
    Resuming runs collect → absorb/promote → next dispatch → yield.
    The return value (``StopIteration.value``) is the per-task result
    list; drive it synchronously via :func:`grouped_ksp`.
    """
    if not tasks:
        return []
    if backend is None:
        backend = _DEFAULT_BACKEND
    states = [_TaskState(row, src, dst) for row, src, dst in tasks]

    # round 0: every task's P1 is a single unmasked single-source solve,
    # so tasks sharing (row, src) — common in tie-cohort reference
    # batches, where one boundary vertex fans out to many partners on the
    # same subgraph — share ONE solve and differ only in dst extraction
    z = adj.shape[-1]
    first_of: dict = {}
    jobs = []
    for st in states:
        key = (st.row, st.src)
        if key not in first_of:
            first_of[key] = len(jobs)
            jobs.append((st.row, st.src, np.zeros(z, bool),
                         np.zeros(z, bool), _INF))
    pending = _dispatch_round(adj, jobs, solver, s_multiple, backend, gather,
                              device)
    yield
    round0 = _collect_round(pending)
    for st in states:
        dist, parent = round0[first_of[(st.row, st.src)]]
        if dist[st.dst] >= _INF / 2:
            st.done = True
            continue
        p1 = _extract(parent, st.src, st.dst)
        if p1 is None:
            st.done = True
            continue
        st.found.append((float(dist[st.dst]), tuple(p1)))
        st.found_set.add(tuple(p1))
        if k <= 1:
            st.done = True

    while True:
        active = [st for st in states if not st.done]
        if not active:
            break
        jobs, metas, owners = [], [], []
        for st in active:
            j, m = st.spur_jobs(adj[st.row], k, use_cap)
            jobs.extend(j)
            metas.append(m)
            owners.append(st)
        pending = _dispatch_round(adj, jobs, solver, s_multiple, backend,
                                  gather, device)
        yield
        results = _collect_round(pending)
        off = 0
        for st, meta in zip(owners, metas):
            st.absorb(meta, results[off : off + len(meta)])
            off += len(meta)
            st.promote(k)
    return [st.found for st in states]


def grouped_ksp(adj, tasks, k: int, *, solver=None, use_cap: bool = True,
                s_multiple: int = 1, backend=None, gather=None,
                device="cuda"):
    """K shortest simple paths for a batch of same-slab tasks.

    adj     : float32[S, z, z] packed slab (INF off-edges, 0 diagonal)
    tasks   : [(slab_row, src, dst)] with local vertex ids
    backend : a :class:`repro_torch.engine.backend.SolverBackend`
              supplying the grouped solve and its bucket geometry;
              default the plain PyTorch one.
    solver  : (adj, init, bv, so, bn, cap) → (dist, parent) execution
              override — e.g. a ``repro_torch.dist.shard_refine.
              make_refine_fn`` product; the backend still supplies
              geometry.
    s_multiple : each round's bucket S is a multiple of it (the mesh's
              shard count when the solver is a mesh refine).
    gather  : optional device-resident adjacency gather (see
              ``SlabLayout.pack_round``).
    device  : where the round buffers go and the solve runs (the card
              unless the caller asks for the CPU).
    Returns one [(dist, path-tuple)] list per task, ascending.

    A zero-task batch returns [] — the batched dispatch path produces one
    whenever a tick's tasks were all cache hits.  This is the synchronous
    driver over :func:`grouped_ksp_async` (one implementation, two
    schedules).
    """
    gen = grouped_ksp_async(adj, tasks, k, solver=solver, use_cap=use_cap,
                            s_multiple=s_multiple, backend=backend,
                            gather=gather, device=device)
    while True:
        try:
            next(gen)
        except StopIteration as fin:
            return fin.value
