"""KSP-DG host loop: host milliseconds per answered query in the
program's ``join`` spans (each iteration's k-best joins of the partial
paths along every reference, and their fold into the top-k list)."""

from kspbench import record

UNIT = "ms"


def read(rec):
    total = record.span_s(rec, "join")
    return record.per_answered(rec, None if total is None else total * 1e3)
