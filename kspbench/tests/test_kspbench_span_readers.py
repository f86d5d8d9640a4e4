"""The readers of the KSP-DG stepper's spans (``ref_build``, ``ref_next``,
``join``) and of the worker's wait on the card (``collect_round``), on a
record that holds those spans and on one that holds none.

``test_kspbench_metrics.py`` checks every reader under ``metrics/``
against its table ``WANT`` on its own record, which holds none of these
spans; this file enters the four readers there with that reading (None),
and checks their numbers here."""

import pytest

from kspbench import cell
from kspbench.tests import test_kspbench_metrics as base

SPANS = {"skeleton": [(0.0, 0.01)], "ref_build": [(0.01, 0.31)],
         "ref_next": [(0.31, 0.34), (1.0, 1.03)],
         "join": [(1.05, 1.2)], "collect_round": [(0.9, 0.93)]}

#: three answered queries in the base record
WANT = {
    "ref_build_ms_per_query.open": 300.0 / 3,
    "ref_next_ms_per_query.open": 60.0 / 3,
    "join_ms_per_query.open": 150.0 / 3,
    "device_wait_ms_per_query.open": 30.0 / 3,
}

base.WANT.update(dict.fromkeys(WANT))


def _read(name, rec):
    return cell.load_module(cell.ROOT / "metrics" / f"{name}.py").read(rec)


def _rec():
    rec = base._rec()
    rec["spans"] = {**rec["spans"], **SPANS}
    return rec


@pytest.mark.parametrize("name", sorted(WANT))
def test_span_reader(name):
    assert base.LISTED[name]["source"] == "program_span"
    assert base.LISTED[name]["workloads"] == ["city-open"]
    assert _read(name, _rec()) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", sorted(WANT))
def test_span_reader_with_nothing_to_read(name):
    """A run that recorded no span of the name, as a program without
    these spans gives: the metric is left out, never read as 0."""
    assert _read(name, base._rec()) is None
    rec = _rec()
    rec["queries"] = [q for q in rec["queries"] if q["failed"]]
    assert _read(name, rec) is None
