"""95th-percentile query latency (ms, host clock): every query due in
the window, from the instant it was due to the return of the tick that
answered it; a failed query counts as +inf.  Nearest rank, so at 245
queries the 13 slowest lie at or above it."""

from kspbench import record

UNIT = "ms"


def read(rec):
    return record.percentile(record.latencies_ms(rec), 95)
