"""Answers per second (host clock): the queries due in the window that
were answered, over the window and the drain after it.  The drain ends
when the last query due has been answered (or at the drain limit), and
the clock is read after it, so all of that work counts over all of that
time; a failed query counts as no answer."""

from kspbench import record

UNIT = "queries/s"


def read(rec):
    return len(record.answered(rec)) / (rec["seconds"] + rec["drain_s"])
