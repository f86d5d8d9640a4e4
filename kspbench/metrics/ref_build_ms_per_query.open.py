"""KSP-DG host loop: host milliseconds per answered query in the
program's ``ref_build`` spans (the construction of each query's
reference stream: for the ``lazy`` stream, its reverse shortest-path
tree or the cached tree's lookup)."""

from kspbench import record

UNIT = "ms"


def read(rec):
    total = record.span_s(rec, "ref_build")
    return record.per_answered(rec, None if total is None else total * 1e3)
