"""KSP-DG host loop: host milliseconds per answered query in the
program's ``ref_next`` spans (each pull of a reference path from the
query's stream, in admission, the cohort loop and the stop-rule
scan)."""

from kspbench import record

UNIT = "ms"


def read(rec):
    total = record.span_s(rec, "ref_next")
    return record.per_answered(rec, None if total is None else total * 1e3)
