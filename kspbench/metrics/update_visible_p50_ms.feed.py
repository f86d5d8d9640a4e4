"""Scheduler / epoch handoff: median (nearest rank) over the window's
update batches of the milliseconds from a batch's due instant to the
return of the first tick after which the service's epoch includes it;
a batch never visible counts as +inf.  None in a cell without a feed."""

from kspbench import record

UNIT = "ms"


def read(rec):
    if not rec["updates"]:
        return None
    return record.percentile(
        [float("inf") if vis is None else (vis - due) * 1e3
         for due, _sent, vis in rec["updates"]], 50)
