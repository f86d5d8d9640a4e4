"""The port's report generators and depth fit against the reference.

``model_flops`` equals ``repro.launch.report.model_flops`` on every
registered (arch, shape); ``markdown_table``, ``dryrun_summary`` and
``rooffit_table`` print the reference's text for the same records on the
TPU mesh names; the rooffit extrapolation of starcoder2-3b×decode_32k
from two shallow traces equals a trace at its full 30 layers in FLOPs and
bytes; hill-climb D's traced mixed cache moves fewer bytes than the
uniform one."""

import json

import pytest

from repro.launch import experiments_md as ref_md
from repro.launch import report as ref_report
from repro_torch.configs.base import all_archs
from repro_torch.configs.starcoder2_3b import CFG as STARCODER
from repro_torch.launch import experiments_md, hillclimb_gemma, report, rooffit
from repro_torch.models.common import DTypePolicy

CELLS = sorted((c.arch, c.shape) for a in all_archs().values()
               for c in a.cells())


def test_registry_has_44_cells():
    assert len(CELLS) == 44


@pytest.mark.parametrize("arch,shape", CELLS, ids=lambda x: str(x))
def test_model_flops_equal_the_reference(arch, shape):
    assert report.model_flops(arch, shape) == \
        ref_report.model_flops(arch, shape)


def _roof(tc, tm, tcoll, dom, flops, n):
    return {"flops": flops, "hbm_bytes": 1e9, "coll_bytes": 2e6,
            "coll_detail": {"all-reduce": 2e6, "_ops": 3},
            "coll_counts": {"all-reduce": 2, "all-gather": 1},
            "t_compute_s": tc, "t_memory_s": tm, "t_collective_s": tcoll,
            "dominant": dom, "n_devices": n}


def _records(mesh, n):
    base = {"mesh": mesh, "note": ""}
    return [
        dict(base, cell="starcoder2-3b×decode_32k", arch="starcoder2-3b",
             shape="decode_32k", kind="decode", status="ok",
             t_compile_s=3.5,
             memory={"argument_bytes": 3e9, "temp_bytes": 1.5e8},
             roofline=_roof(1e-3, 2e-2, 1e-5, "memory", 4.5e12, n)),
        dict(base, cell="gin-tu×molecule", arch="gin-tu", shape="molecule",
             kind="train", status="ok",
             memory={"argument_bytes": 5e5, "temp_bytes": 2e6},
             roofline=_roof(2e-5, 1e-6, 3e-7, "compute", 9e9, n)),
        dict(base, cell="kspdg×maintain", arch="kspdg", shape="maintain",
             kind="serve", status="ok",
             memory={"argument_bytes": 2e9, "temp_bytes": 5e9},
             roofline=_roof(1e-4, 5e-3, 0.0, "collective", 1.6e10, n)),
        dict(base, cell="kspdg×refine_cusa", arch="kspdg",
             shape="refine_cusa", kind="serve", status="skipped",
             skip_reason="515 GB of adjacency: a cluster's worth, not one "
                         "card's"),
        dict(base, cell="bst×serve_p99", arch="bst", shape="serve_p99",
             kind="serve", status="error",
             error="RuntimeError: a synthetic failure for the table"),
    ]


@pytest.mark.parametrize("mesh,n", [("16x16", 256), ("2x16x16", 512)])
def test_tables_print_the_reference_text(mesh, n):
    recs = _records(mesh, n) + _records("1", 1)
    assert report.markdown_table(recs, mesh) == \
        ref_report.markdown_table(recs, mesh)
    same = [r for r in recs if r["mesh"] == mesh]
    assert experiments_md.dryrun_summary(same) == \
        ref_md.dryrun_summary(same)


def test_rooffit_table_prints_the_reference_text(tmp_path):
    path = tmp_path / "fit.jsonl"
    recs = [
        {"arch": "starcoder2-3b", "shape": "decode_32k", "mesh": "16x16",
         "flops": 4e12, "n_devices": 256, "t_compute_s": 1e-3,
         "t_memory_s": 2e-2, "t_collective_s": 3e-4, "dominant": "memory"},
        {"arch": "gemma3-27b", "shape": "train_4k", "mesh": "16x16",
         "error": "RuntimeError: synthetic"},
    ]
    path.write_text("".join(json.dumps(r) + "\n" for r in recs))
    assert experiments_md.rooffit_table(str(path)) == \
        ref_md.rooffit_table(str(path))


def test_unpartitioned_rows():
    rec = {"cell": "bst×serve_p99", "arch": "bst", "shape": "serve_p99",
           "kind": "serve", "mesh": "16x16", "note": "", "status": "ok",
           "memory": {"argument_bytes": 93_600_000, "output_bytes": None,
                      "temp_bytes": None, "generated_code_bytes": None},
           "roofline": None, "partitioned": False}
    row = report.markdown_table([rec], "16x16").splitlines()[-1]
    assert row == ("| bst×serve_p99 | serve | — | — | — | not partitioned | "
                   "— | — | — | argument 0.094 GB/dev |")
    row = experiments_md.dryrun_summary([rec]).splitlines()[-1]
    assert row == "| bst×serve_p99 | 16x16 | ok (not partitioned) |  | " \
                  "0.09 | — | — |"


def test_rooffit_equals_a_full_depth_trace():
    rec = rooffit.fit_arch_shape("starcoder2-3b", "decode_32k")
    assert (rec["l1"], rec["l2"], rec["L_full"]) == (1, 3, 30)
    full = rooffit.trace_cell(STARCODER, DTypePolicy(),
                              "decode_32k").roofline()
    assert rec["flops"] == pytest.approx(full.flops, rel=1e-12)
    assert rec["hbm_bytes"] == pytest.approx(full.hbm_bytes, rel=1e-12)
    assert rec["t_compute_s"] == pytest.approx(full.t_compute, rel=1e-12)
    assert rec["dominant"] == full.dominant == "memory"


def test_gemma_mixed_cache_moves_fewer_bytes():
    import dataclasses

    cfg = dataclasses.replace(hillclimb_gemma.CFG, n_layers=6)
    batch, seq = hillclimb_gemma.SHAPES["decode_32k"]
    uniform = hillclimb_gemma.trace_decode(cfg, False, batch, seq)
    mixed = hillclimb_gemma.trace_decode(cfg, True, batch, seq)
    assert mixed.hbm_bytes < uniform.hbm_bytes
    assert mixed.flops < uniform.flops
