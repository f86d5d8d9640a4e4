"""Scheduler layer: the share of query latency spent waiting for
admission (%): the program's ``queue_wait`` spans over the summed
latency of the answered queries (traced run)."""

from kspbench import record

UNIT = "%"


def read(rec):
    wait = record.span_s(rec, "queue_wait")
    total = sum(q["latency"] for q in record.answered(rec))
    if wait is None or total <= 0:
        return None
    return 100.0 * wait / total
