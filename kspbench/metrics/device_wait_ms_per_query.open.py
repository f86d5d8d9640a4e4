"""Worker and refine: host milliseconds per answered query in the
program's ``collect_round`` spans (the host blocked on a refine round's
grouped solve and its copy back from the card)."""

from kspbench import record

UNIT = "ms"


def read(rec):
    total = record.span_s(rec, "collect_round")
    return record.per_answered(rec, None if total is None else total * 1e3)
