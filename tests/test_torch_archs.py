"""The port's arch registry: the five LM architectures beside kspdg,
their cells (four per arch, the reference's two long_500k skips), their
parameter counts (analytic, the reference's, and a meta init's), and a
real tiny train + decode run of each on the CPU."""

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


def test_registry_holds_the_lm_archs_and_kspdg():
    archs = all_archs()
    assert set(archs) == set(LM_ARCHS) | {"kspdg"}
    assert {archs[n].family for n in LM_ARCHS} == {"lm"}


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
