"""Index build layer: seconds of the run's own DTLP build spent on the
bounding paths (``DTLP.stats.bounding_s``), the bulk of ``setup_s``."""

UNIT = "s"


def read(rec):
    return rec["build"]["bounding_s"]
