"""The port's arch registry: the reference's ten assigned architectures
(five LM, four GNN, BST) beside kspdg, their cells (20 LM with the
reference's two long_500k skips, 16 GNN, 4 recsys) shape for shape
against the reference's, their parameter counts (analytic, the
reference's, and a meta init's), and a real tiny train run of each on
the CPU."""

import dataclasses
import importlib

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import all_archs as ref_archs
from repro_torch.configs.base import TensorSpec, all_archs
from repro_torch.models.common import DEFAULT_POLICY, count_params, tree_leaves
from repro_torch.models.transformer import init_lm
from tests._torch_threads import one_torch_thread  # noqa: F401

LM_ARCHS = [
    "starcoder2-3b",
    "deepseek-coder-33b",
    "gemma3-27b",
    "deepseek-v3-671b",
    "moonshot-v1-16b-a3b",
]
GNN_ARCHS = ["dimenet", "meshgraphnet", "graphsage-reddit", "gin-tu"]


def test_registry_holds_the_lm_archs_and_kspdg():
    """... and, since the GNN family and BST were ported, every arch of
    the reference's registry: its ten assigned archs and kspdg."""
    archs = all_archs()
    assert set(archs) == set(ref_archs())
    assert set(archs) == set(LM_ARCHS + GNN_ARCHS) | {"bst", "kspdg"}
    assert {archs[n].family for n in LM_ARCHS} == {"lm"}
    assert {archs[n].family for n in GNN_ARCHS} == {"gnn"}
    assert archs["bst"].family == "recsys"
    assert archs["kspdg"].family == "ksp"
    for n in GNN_ARCHS:  # the published configs, unchanged
        assert dataclasses.asdict(archs[n].smoke_fn.args[0]) == \
            dataclasses.asdict(ref_archs()[n].smoke_fn.args[0])


def test_cell_inventory():
    """The reference's 40 assigned cells: 5 LM × 4 + 4 GNN × 4 + 1 recsys
    × 4 with exactly the two documented long_500k skips, and the KSP data
    plane's (at least 3; on one card its cluster-sized refine_cusa cell
    carries a skip of its own)."""
    per_family = {"lm": 0, "gnn": 0, "recsys": 0, "ksp": 0}
    skips = []
    for arch in all_archs().values():
        cells = arch.cells()
        per_family[arch.family] += len(cells)
        skips += [(arch.family, c) for c in cells if c.skip]
    assert (per_family["lm"], per_family["gnn"], per_family["recsys"]) == (
        20, 16, 4)
    assert per_family["ksp"] >= 3
    assert sorted(c.arch for f, c in skips if f != "ksp") == [
        "deepseek-coder-33b",
        "moonshot-v1-16b-a3b",
    ]
    assert [c.shape for f, c in skips if f == "ksp"] == ["refine_cusa"]


def _dtype_name(spec) -> str:
    return str(spec.dtype).replace("torch.", "")


@pytest.mark.parametrize("name", GNN_ARCHS + ["bst"])
def test_gnn_and_bst_cells_match_the_reference(name):
    """Each cell's shape name, kind, note, skip and axes equal the
    reference's; every argument spec has the reference's shape and
    dtype, leaf for leaf."""
    mine = {c.shape: c for c in all_archs()[name].cells()}
    theirs = {c.shape: c for c in ref_archs()[name].cells()}
    assert list(mine) == list(theirs) and len(mine) == 4
    for shape, c in mine.items():
        r = theirs[shape]
        assert (c.kind, c.note, c.skip, c.arg_axes) == (
            r.kind, r.note, r.skip, r.arg_axes), (name, shape)
        a_leaves = tree_leaves(c.arg_specs)
        b_leaves = jax.tree_util.tree_leaves(r.arg_specs)
        assert len(a_leaves) == len(b_leaves)
        for a, b in zip(a_leaves, b_leaves):
            assert isinstance(a, TensorSpec)
            assert tuple(a.shape) == tuple(b.shape), (name, shape)
            assert _dtype_name(a) == str(b.dtype), (name, shape)


def test_bst_param_count():
    """The analytic count equals the reference's and a meta init's numel
    (the 10M × 32 and 1M × 32 tables are not allocated)."""
    from repro.configs.bst_arch import CFG as RCFG
    from repro_torch.configs.bst_arch import CFG
    from repro_torch.models.bst import init_bst

    assert CFG.param_count() == RCFG.param_count()
    meta = init_bst(0, CFG, device="meta")
    assert all(t.device.type == "meta" for t in tree_leaves(meta))
    assert count_params(meta) == CFG.param_count()


@pytest.mark.parametrize("name", GNN_ARCHS + ["bst"])
def test_gnn_and_bst_smoke_on_the_cpu(name):
    metrics = all_archs()[name].smoke_fn(device="cpu")
    assert len(metrics["losses"]) == 4
    assert all(np.isfinite(v) for v in metrics["losses"])


def test_lm_cell_inventory():
    """20 LM cells (4 per arch) with exactly the documented skips, the
    reference's shapes and skip reasons."""
    archs, ref = all_archs(), ref_archs()
    cells = [c for n in LM_ARCHS for c in archs[n].cells()]
    assert len(cells) == 20
    assert sorted(c.arch for c in cells if c.skip) == [
        "deepseek-coder-33b",
        "moonshot-v1-16b-a3b",
    ]
    for n in LM_ARCHS:
        mine = {c.shape: c for c in archs[n].cells()}
        theirs = {c.shape: c for c in ref[n].cells()}
        assert set(mine) == set(theirs)
        for shape, c in mine.items():
            r = theirs[shape]
            assert (c.kind, c.skip, c.arg_axes) == (r.kind, r.skip,
                                                    r.arg_axes)
            for a, b in zip(tree_leaves(c.arg_specs),
                            jax.tree_util.tree_leaves(r.arg_specs)):
                assert isinstance(a, TensorSpec)
                assert tuple(a.shape) == tuple(b.shape), (n, shape)


@pytest.mark.parametrize("name", LM_ARCHS)
def test_param_counts(name):
    """The analytic count equals the reference's and the numel of an init
    on the meta device (which allocates nothing)."""
    mod = name.replace("-", "_")
    cfg = importlib.import_module(f"repro_torch.configs.{mod}").CFG
    rcfg = importlib.import_module(f"repro.configs.{mod}").CFG
    assert cfg.param_count() == rcfg.param_count()
    assert cfg.active_param_count() == rcfg.active_param_count()
    meta = init_lm(0, cfg, DEFAULT_POLICY, device="meta")
    assert all(t.device.type == "meta" for t in tree_leaves(meta))
    assert count_params(meta) == cfg.param_count()


@pytest.mark.parametrize("name", LM_ARCHS)
def test_smoke_on_the_cpu(name):
    metrics = all_archs()[name].smoke_fn(device="cpu")
    assert len(metrics["losses"]) == 3
    assert all(np.isfinite(v) for v in metrics["losses"])


def test_smoke_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card: nothing to refuse")
    with pytest.raises(RuntimeError, match="cuda"):
        all_archs()["starcoder2-3b"].smoke_fn()


@pytest.mark.parametrize("name", GNN_ARCHS + ["bst"])
def test_gnn_and_bst_smoke_default_to_the_card(name):
    if torch.cuda.is_available():
        pytest.skip("this host has a card: nothing to refuse")
    with pytest.raises(RuntimeError, match="cuda"):
        all_archs()[name].smoke_fn()
