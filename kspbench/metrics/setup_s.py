"""Set-up time (s, host clock): from the harness's start to the window's
open: imports, the road network, the DTLP build, the service, the
traffic and the warm-up (kernel build and load included)."""

UNIT = "s"


def read(rec):
    return rec["setup_s"]
