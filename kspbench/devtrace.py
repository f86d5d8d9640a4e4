"""What the device did during the measured window, from ``torch.profiler``.

The harness starts the profiler (CUDA activity only, so host operations
are not recorded and cost nothing), synchronises, and launches one
marker kernel at the window's open; that marker is the first device
activity in the trace and ties the device's clock to the host's.  After
the run, :func:`read` turns the raw activity records into what the
per-layer metrics and the result's ``device`` and ``breakdown`` read:

* ``busy_s``: the union of every kernel, copy and memset interval inside
  the window; ``window_s`` the window's length;
* ``kernels``: seconds and calls by kernel name inside the window;
* ``gaps``: the idle intervals between device activities, each mapped to
  host-clock seconds so the harness can say what the host was doing.
"""

from __future__ import annotations


def start(torch):
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CUDA])
    prof.__enter__()
    return prof


def mark(torch, dev):
    """Launch the window's marker kernel; returns the host time (seconds,
    ``time.perf_counter``) at its launch."""
    import time

    torch.cuda.synchronize()
    t = time.perf_counter()
    torch.ones(1, device=dev).add_(1.0)
    return t


def _events(prof):
    """(name, start_us, end_us) of every device activity, by start."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        s = e.start_ns() / 1e3
        out.append((e.name(), s, s + e.duration_ns() / 1e3))
    out.sort(key=lambda x: x[1])
    return out


def read(prof, t_mark: float, window_s: float) -> dict | None:
    """Stop the profiler and reduce its trace to the window
    [marker launch, marker launch + window_s]; None when the trace holds
    no device activity."""
    prof.__exit__(None, None, None)
    events = _events(prof)
    if not events:
        return None
    origin = events[0][1]  # the marker: the first activity after the sync
    end = origin + window_s * 1e6
    busy, cover_end = 0.0, origin
    kernels: dict = {}
    gaps = []
    for name, s, e in events[1:]:
        if s >= end:
            break
        e = min(e, end)
        slot = kernels.setdefault(name, [0.0, 0])
        slot[0] += (e - s) / 1e6
        slot[1] += 1
        if s > cover_end:
            gaps.append((t_mark + (cover_end - origin) / 1e6,
                         t_mark + (s - origin) / 1e6))
        if e > cover_end:
            busy += e - max(s, cover_end)
            cover_end = e
    if cover_end < end:
        gaps.append((t_mark + (cover_end - origin) / 1e6,
                     t_mark + window_s))
    return {"busy_s": busy / 1e6, "window_s": window_s,
            "kernels": kernels, "gaps": gaps}


#: program spans that cover waiting, not work, and so say nothing about
#: what the host was doing during a device gap
_NOT_WORK = {"queue_wait"}


def attribute_gaps(gaps, spans: dict, harness_spans: list) -> list:
    """Seconds of device idle by what the host was doing: each gap goes to
    the latest-starting program span that covers its midpoint, else to
    the harness's own span there (``harness.tick``, ``harness.idle``,
    ``harness.submit``), else to ``other``.  Returns [[name, seconds]],
    longest first, at most 10."""
    import heapq

    def cover(intervals, xs):
        """For each sorted x, the name of the latest-starting interval
        (name, start, end) with start <= x < end, or None."""
        ivs = sorted(intervals, key=lambda r: r[1])
        out, heap, i = [], [], 0
        for x in xs:
            while i < len(ivs) and ivs[i][1] <= x:
                heapq.heappush(heap, (-ivs[i][1], ivs[i][2], ivs[i][0]))
                i += 1
            while heap and heap[0][1] <= x:
                heapq.heappop(heap)
            out.append(heap[0][2] if heap else None)
        return out

    order = sorted(range(len(gaps)), key=lambda j: gaps[j][0] + gaps[j][1])
    mids = [(gaps[j][0] + gaps[j][1]) / 2 for j in order]
    prog = [(name, s, e) for name, ivs in spans.items()
            if name not in _NOT_WORK for s, e in ivs]
    by_prog = cover(prog, mids)
    by_harness = cover(harness_spans, mids)
    total: dict = {}
    for j, p, h in zip(order, by_prog, by_harness):
        name = p or h or "other"
        total[name] = total.get(name, 0.0) + gaps[j][1] - gaps[j][0]
    return [[n, s] for n, s in sorted(total.items(), key=lambda x: -x[1])][:10]
