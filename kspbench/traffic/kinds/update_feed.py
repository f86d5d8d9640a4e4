"""A live weight feed: one update batch every ``period_s`` seconds.

Parameters: ``period_s``, ``alpha`` (the share of the edges each batch
moves), ``tau`` (each moved edge goes to its *initial* weight times a
factor drawn from [1 - tau, 1 + tau], clamped at 0.25: the paper's
section 6.4.1 dynamics), ``stream_seed``, ``warm_batches`` and
``jitter_s``.  The batches come from one frozen
``roadgen.WeightUpdateStream`` seeded by ``stream_seed``: its first
``warm_batches`` batches are applied in set-up (the patch and scatter
paths built before the window opens), the next ones are sent in the
window, at ``period_s``, 2 ``period_s``, ... for as many as end inside
it.  Every run sends the same batches in the same order; the run's seed
moves each due time by up to ``jitter_s`` either way, far less than the
period, so the order never changes.
"""

from __future__ import annotations

import numpy as np

from kspbench import roadgen


class Source:
    def __init__(self, params, net, rng, seconds):
        period = float(params["period_s"])
        jitter = float(params["jitter_s"])
        stream = roadgen.WeightUpdateStream(
            net, alpha=float(params["alpha"]), tau=float(params["tau"]),
            seed=int(params["stream_seed"]))
        self.warm_batches = [stream.next_batch()
                             for _ in range(int(params["warm_batches"]))]
        n = int((seconds - jitter) // period)
        dues = period * np.arange(1, n + 1) + rng.uniform(-jitter, jitter, n)
        self.events = []
        for due in dues:
            eids, new_w = stream.next_batch()
            self.events.append({"kind": "update", "due": float(due),
                                "eids": eids, "new_w": new_w})

    def initial(self):
        return list(self.events)

    def answered(self, event, now):
        return []
