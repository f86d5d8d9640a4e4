"""Worker / refine layer: grouped-Yen rounds packed from device-resident
slabs per answered query (the slab layout's ``device_rounds`` counter)."""

from kspbench import record

UNIT = "rounds"


def read(rec):
    rounds = rec["transfer"].get("device_rounds", 0)
    return record.per_answered(rec, rounds) if rounds else None
