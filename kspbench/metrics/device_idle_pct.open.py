"""Device layer: the share of the window in which no kernel, copy or
memset ran on the card (%), from the profiler's CUDA activity: 100 x
(1 - busy / window)."""

UNIT = "%"
DEVICE = True


def read(rec):
    dev = rec.get("device_trace")
    if dev is None:
        return None
    return 100.0 * (1.0 - dev["busy_s"] / dev["window_s"])
