"""KSP-DG host loop: host milliseconds per answered query in the
program's ``splice`` spans (segment merge, joins and the next reference
search)."""

from kspbench import record

UNIT = "ms"


def read(rec):
    total = record.span_s(rec, "splice")
    return record.per_answered(rec, None if total is None else total * 1e3)
