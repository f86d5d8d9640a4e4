"""Index maintenance: host milliseconds in the program's
``epoch_prepare`` spans (the streaming handoff's staging of the next
epoch: the index's update plan and the workers' shadow slabs) per update
batch the window's ticks made visible.  None where no such span was
recorded or no batch applied."""

from kspbench import record

UNIT = "ms"


def read(rec):
    total = record.span_s(rec, "epoch_prepare")
    applied = sum(1 for *_, visible in rec["updates"] if visible is not None)
    if total is None or not applied:
        return None
    return total * 1e3 / applied
