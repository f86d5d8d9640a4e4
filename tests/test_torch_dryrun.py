"""The port's dry-run driver (``launch.dryrun``) and its sharding helpers
(``models.common``) against the reference.

- The reference's ``specs_shardings`` on ``make_production_mesh`` (16x16
  and 2x16x16, 512 placeholder CPU devices in a subprocess of its own)
  for every leaf of every cell's ``arg_specs``, and again under hill-climb
  B's ``rows@(data,model)`` rules for the BST cells: the port's resolved
  specs equal those PartitionSpecs leaf by leaf; the port's per-device
  argument bytes of gin-tu×molecule equal the reference's compiled
  ``memory_analysis().argument_size_in_bytes`` on 16x16.
- ``run_cell`` on every kspdg, GNN and BST cell and on
  starcoder2-3b×decode_32k at full shape on meta: "ok" (or the
  documented skip) with the reference's record keys; the kspdg cells
  trace through ``kernels/ops.py``'s shapes-only path.
- The CLI on ``--arch kspdg --mesh all --device cpu``, and its refusal
  to run without a card and without ``--device cpu``."""

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs.base import all_archs
from repro_torch.kernels import ops
from repro_torch.launch import dryrun
from repro_torch.launch.hillclimb_bst import ROWS_ALL_AXES
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.common import (axis_rules, logical_pspec,
                                       replicated, shard_shape,
                                       specs_shardings, tree_leaves,
                                       tree_shardings)

ROOT = Path(__file__).resolve().parent.parent

_REFERENCE = r"""
import json, sys
import jax
from repro.configs.base import all_archs
from repro.launch.mesh import make_production_mesh
from repro.models.common import specs_shardings

def spec(ns):
    return [list(x) if isinstance(x, tuple) else x for x in ns.spec]

out = {"leaves": {}}
for multi in (False, True):
    mesh = make_production_mesh(multi_pod=multi)
    mname = "x".join(map(str, mesh.devices.shape))
    for rname, rules in (("default", None), ("rows", json.loads(sys.argv[1]))):
        for name, arch in sorted(all_archs().items()):
            if rname == "rows" and name != "bst":
                continue
            for cell in arch.cells():
                leaves = []
                for s, a in zip(cell.arg_specs, cell.arg_axes):
                    sh = specs_shardings(s, a, mesh, rules)
                    for x, ns in zip(jax.tree.leaves(s), jax.tree.leaves(sh)):
                        leaves.append([list(x.shape), spec(ns)])
                out["leaves"][f"{mname}|{rname}|{cell.name}"] = leaves
mesh = make_production_mesh(multi_pod=False)
cell = [c for c in all_archs()["gin-tu"].cells() if c.shape == "molecule"][0]
in_sh = tuple(specs_shardings(s, a, mesh)
              for s, a in zip(cell.arg_specs, cell.arg_axes))
fn = cell.step_fn
compiled = jax.jit(lambda *a: fn(*a), in_shardings=in_sh).lower(
    *cell.arg_specs).compile()
out["gin_molecule_arg_bytes"] = compiled.memory_analysis(
    ).argument_size_in_bytes
json.dump(out, sys.stdout)
"""


@pytest.fixture(scope="module")
def reference():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=512")
    out = subprocess.run(
        [sys.executable, "-c", _REFERENCE, json.dumps(ROWS_ALL_AXES)],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout)


def _spec(ns):
    return [list(x) if isinstance(x, tuple) else x for x in ns.spec]


@pytest.mark.parametrize("multi", [False, True], ids=["16x16", "2x16x16"])
def test_specs_equal_the_reference_leaf_by_leaf(reference, multi):
    mesh = make_production_mesh(multi_pod=multi, device="cpu")
    mname = dryrun.mesh_name(mesh)
    n = 0
    for name, arch in sorted(all_archs().items()):
        for rname, rules in (("default", None), ("rows", ROWS_ALL_AXES)):
            if rname == "rows" and name != "bst":
                continue
            for cell in arch.cells():
                got = []
                for s, a in zip(cell.arg_specs, cell.arg_axes):
                    sh = specs_shardings(s, a, mesh, rules)
                    got += [[list(x.shape), _spec(ns)] for x, ns in
                            zip(tree_leaves(s), tree_leaves(sh))]
                want = reference["leaves"][f"{mname}|{rname}|{cell.name}"]
                assert got == want, (mname, rname, cell.name)
                n += len(got)
    assert n > 4000


def test_per_device_argument_bytes_equal_the_compiled_reference(reference):
    mesh = make_production_mesh(device="cpu")
    cell = next(c for c in all_archs()["gin-tu"].cells()
                if c.shape == "molecule")
    assert dryrun.per_device_argument_bytes(cell.arg_specs, cell.arg_axes,
                                            mesh) == \
        reference["gin_molecule_arg_bytes"]


def test_resolution_rules():
    """The reference's rules: absent mesh axes drop out, a mesh axis is
    used once per spec, indivisible dimensions shed trailing axes."""
    single = make_production_mesh(device="cpu")
    multi = make_production_mesh(multi_pod=True, device="cpu")
    assert single.shape == {"data": 16, "model": 16}
    assert multi.shape == {"pod": 2, "data": 16, "model": 16}
    assert logical_pspec(("batch", "embed"), single) == (("data",), None)
    assert logical_pspec(("batch", "embed"), multi) == (("pod", "data"),
                                                        None)
    with axis_rules(single, {"embed": "model"}):
        assert logical_pspec(("embed", "mlp")) == ("model", None)
    from repro_torch.configs.base import TensorSpec
    spec = TensorSpec((24, 4096), torch.float32)
    sh = specs_shardings(spec, ("subgraphs", None), multi)
    assert sh.spec == ("pod", None)  # 24 rows divide over pod only
    assert shard_shape((24, 4096), sh.spec, multi) == (12, 4096)
    assert shard_shape((10, 7), ("model", None), single) == (1, 7)
    assert replicated(single).spec == ()
    tree = tree_shardings({"a": ("batch", "feat"), "b": [(), ("rows",)]},
                          single)
    assert tree["a"].spec == (("data",), None)
    assert tree["b"][0].spec == () and tree["b"][1].spec == ("model",)


_KEYS = {"cell", "arch", "shape", "kind", "mesh", "note", "status"}
_OK_KEYS = _KEYS | {"t_lower_s", "memory", "roofline"}
_MEMORY_KEYS = {"argument_bytes", "output_bytes", "temp_bytes",
                "generated_code_bytes"}


def _cells():
    archs = all_archs()
    out = [c for name in ("kspdg", "gin-tu", "dimenet", "graphsage-reddit",
                          "meshgraphnet", "bst") for c in archs[name].cells()]
    out += [c for c in archs["starcoder2-3b"].cells()
            if c.shape == "decode_32k"]
    return out


@pytest.mark.parametrize("cell", _cells(), ids=lambda c: c.name)
def test_run_cell_on_the_card_mesh(cell):
    ops.reset_launches()
    rec = dryrun.run_cell(cell, None, verbose=False)
    assert all(v == 0 for v in ops.LAUNCHES.values())
    if cell.skip:
        assert rec["status"] == "skipped" and rec["skip_reason"] == cell.skip
        assert _KEYS | {"skip_reason"} == set(rec)
        return
    assert rec["status"] == "ok", rec.get("traceback")
    assert _OK_KEYS <= set(rec) and rec["mesh"] == "1"
    assert set(rec["memory"]) == _MEMORY_KEYS
    args = sum(math.prod(s.shape)
               * torch.empty((), dtype=s.dtype).element_size()
               for a in cell.arg_specs for s in tree_leaves(a))
    assert rec["memory"]["argument_bytes"] == args
    roof = rec["roofline"]
    assert roof["n_devices"] == 1 and roof["hbm_bytes"] > 0
    assert roof["coll_bytes"] == 0 and roof["coll_counts"] == {}
    assert rec["card"] is None and rec["fits_card"] is None
    if cell.arch == "kspdg":
        kernel = {"refine_dense": "bf_solve_grouped",
                  "levels": "ktrop_solve", "maintain": "bound_dist"}
        assert list(rec["kernels"]) == [kernel[cell.shape]]
        assert set(roof["flops_by_class"]) == {"minplus"}
    else:
        assert rec["kernels"] == {} and roof["flops"] > 0


def test_run_cell_on_a_tpu_mesh():
    cell = next(c for c in all_archs()["kspdg"].cells()
                if c.shape == "levels")
    mesh = make_production_mesh(device="cpu")
    rec = dryrun.run_cell(cell, mesh, verbose=False)
    assert rec["status"] == "ok" and rec["mesh"] == "16x16"
    assert rec["roofline"] is None and rec["partitioned"] is False
    assert rec["reason"] == dryrun.NOT_PARTITIONED
    # subgraphs over data×model: 8192 / 256 rows of each argument
    assert rec["memory"] == {"argument_bytes": 32 * 256 * 256 * 4 + 32 * 4,
                             "output_bytes": None, "temp_bytes": None,
                             "generated_code_bytes": None}


def _cli(*args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                           *args], env=env, cwd=ROOT, capture_output=True,
                          text=True, timeout=600)


def test_cli_kspdg_all_meshes_on_cpu(tmp_path):
    out = tmp_path / "d.jsonl"
    res = _cli("--arch", "kspdg", "--mesh", "all", "--device", "cpu",
               "--out", str(out))
    assert res.returncode == 0, res.stderr
    lines = res.stdout.strip().splitlines()
    assert lines[-1] == "done: 9 ok, 3 skipped (documented), 0 errors"
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    assert [(r["shape"], r["mesh"]) for r in recs] == [
        (s, m) for s in ("refine_cusa", "refine_dense", "maintain", "levels")
        for m in ("1", "16x16", "2x16x16")]
    assert sum(line.startswith("OK  ") for line in lines) == 9


def test_cli_without_a_card_fails(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the no-card refusal is not "
                    "reachable")
    res = _cli("--arch", "kspdg", "--out", str(tmp_path / "d.jsonl"))
    assert res.returncode != 0
    assert "torch.cuda.is_available() is False" in res.stderr
    assert not (tmp_path / "d.jsonl").exists()
