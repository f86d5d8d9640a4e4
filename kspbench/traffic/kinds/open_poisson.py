"""Open-loop trips, sent on a schedule whether or not earlier ones have
answered: the replay of one fixed trace.

Parameters: ``rate_qps``, ``k``, ``lo`` / ``hi`` (trip hops),
``trace_seed`` and ``jitter_s``.  The trace is ``rate_qps`` x the
window's seconds trips and the gaps between their arrivals (exponential
at the rate, scaled to fill the window), drawn once from ``trace_seed``:
every run sends the same trips in the same order.  The run's seed moves
each due time by up to ``jitter_s`` either way.

Why a fixed trace: a few trips of any large draw make the host KSP-DG
loop work for seconds (the join; ROADMAP item 11), and the service is
single-threaded, so which of those trips a run sends, and where they
fall in the order, decides the tail.  With trips drawn per seed, or one
pool shuffled per seed, runs of different seeds differed several times
more than two runs of one seed.  The trace is not cut to leave them out:
it holds every trip it draws, slow ones included.
"""

from __future__ import annotations

import numpy as np

from kspbench import roadgen


class Source:
    def __init__(self, params, net, rng, seconds):
        n = int(round(float(params["rate_qps"]) * seconds))
        trace = np.random.default_rng(int(params["trace_seed"]))
        drawn = roadgen.local_trips(net, n, trace, int(params["lo"]),
                                    int(params["hi"]))
        gaps = trace.exponential(1.0, n + 1)
        dues = np.cumsum(gaps)[:n] * seconds / gaps.sum()
        jitter = float(params["jitter_s"])
        dues = np.clip(dues + rng.uniform(-jitter, jitter, n), 0.0,
                       np.nextafter(seconds, 0.0))
        order = np.argsort(dues, kind="stable")
        k = int(params["k"])
        self.events = [{"kind": "query", "due": float(dues[i]),
                        "s": drawn[i][0], "t": drawn[i][1], "k": k}
                       for i in order]
        self.warm_batches = []

    def initial(self):
        return list(self.events)

    def answered(self, event, now):
        return []
