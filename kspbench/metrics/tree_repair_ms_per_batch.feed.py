"""Index maintenance: host milliseconds in the program's ``tree_repair``
spans (the commit carrying cached reference-stream trees across the
skeleton's changed edges) per update batch the window's ticks made
visible.  None where no such span was recorded or no batch applied."""

from kspbench import record

UNIT = "ms"


def read(rec):
    total = record.span_s(rec, "tree_repair")
    applied = sum(1 for *_, visible in rec["updates"] if visible is not None)
    if total is None or not applied:
        return None
    return total * 1e3 / applied
