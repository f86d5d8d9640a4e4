"""KSP-DG host loop: mean KSP-DG iterations (reference cohorts refined)
per answered query, from each answer's ``QueryStats.iterations``."""

from kspbench import record

UNIT = "iterations"


def read(rec):
    qs = record.answered(rec)
    return record.per_answered(rec, sum(q["iterations"] for q in qs))
