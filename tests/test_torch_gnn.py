"""The port's GNN family (``repro_torch.models.gnn``) against the reference
(``repro.models.gnn``) on the same inputs: the reference's ``jax.random``
init carried across by ``convert.gnn_params_from_numpy`` and the same
numpy batches, for each of the four kinds at small widths and depths.

Tolerances, stated once (float32 throughout; the two packages sum the
segment scatters, the matrix products and DimeNet's bilinear contraction
``td,dbe,tb->te`` in other orders):

- forward outputs and losses: rtol 1e-5 plus 1e-5 of the output's
  largest magnitude;
- gradients: each leaf within 1e-4 of that leaf's largest magnitude;
- two AdamW steps through each package's ``make_train_step``: the
  losses and gradient norms of both steps within rtol 1e-4, the
  parameters after them within 1e-5 of each leaf's largest magnitude
  plus 1e-6 (two bias-corrected Adam steps move a parameter by at most
  about 2·lr = 2e-3, so a difference in the gradient's last bits moves
  it by far less than that).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import gnn as RG
from repro.train import optim as RO
from repro.train.steps import make_train_step as ref_train_step
from repro_torch.convert import gnn_params_from_numpy, tree_to_numpy
from repro_torch.data import pipeline as dp
from repro_torch.models import gnn as G
from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.train.optim import OptConfig, init_opt
from repro_torch.train.steps import make_train_step
from tests._torch_threads import one_torch_thread  # noqa: F401

OUT_RTOL = 1e-5
GRAD_TOL = 1e-4
STEP_RTOL = 1e-4
PARAM_TOL = 1e-5


def _graph(kind, seed):
    """A numpy batch for ``kind`` (the smoke runs' generators)."""
    rng = np.random.default_rng(seed)
    if kind == "dimenet":
        return dp.molecule_batch(3, 7, 11, seed=seed)
    if kind == "gin_graph":
        b = dp.molecule_batch(3, 7, 11, seed=seed)
        b["node_feat"] = rng.normal(size=(21, 6)).astype(np.float32)
        b["labels"] = rng.normal(size=(3, 1)).astype(np.float32)
        return b
    b = dp.random_gnn_graph(40, 90, 6, 4, seed=seed,
                            edge_feat_dim=4 if kind == "mgn" else 0)
    if kind == "mgn":
        b["labels"] = rng.normal(size=(40, 3)).astype(np.float32)
    return b


CASES = {  # name -> (config, batch kind)
    "sage_mean": (G.GNNConfig("sage", "sage", 2, 16, in_dim=6, out_dim=4,
                              aggregator="mean"), "sage"),
    "sage_sum": (G.GNNConfig("sage", "sage", 2, 16, in_dim=6, out_dim=4),
                 "sage"),
    "gin": (G.GNNConfig("gin", "gin", 3, 16, in_dim=6, out_dim=4), "gin"),
    "gin_graph_reg": (G.GNNConfig("gin", "gin", 2, 16, in_dim=6, out_dim=1,
                                  task="graph_reg"), "gin_graph"),
    "mgn": (G.GNNConfig("mgn", "mgn", 3, 16, in_dim=6, out_dim=3,
                        task="node_reg"), "mgn"),
    "dimenet": (G.GNNConfig("dimenet", "dimenet", 2, 16, n_bilinear=4,
                            n_spherical=3, n_radial=4, task="graph_reg"),
                "dimenet"),
}


def ref_cfg(cfg):
    return RG.GNNConfig(**dataclasses.asdict(cfg))


def setup(name, seed=0):
    """(port cfg, ref cfg, ref params, port params, numpy batch)."""
    cfg, kind = CASES[name]
    rcfg = ref_cfg(cfg)
    rp = RG.init_gnn(jax.random.PRNGKey(seed), rcfg)
    pp = gnn_params_from_numpy(jax.tree.map(np.asarray, rp), cfg, "cpu")
    return cfg, rcfg, rp, pp, _graph(kind, seed + 1)


def to_j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def to_t(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def close(got, want, rtol=OUT_RTOL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-30))


def test_configs_are_copies():
    for cfg, _ in CASES.values():
        assert dataclasses.asdict(ref_cfg(cfg)) == dataclasses.asdict(cfg)
    assert [f.name for f in dataclasses.fields(G.GNNConfig)] == [
        f.name for f in dataclasses.fields(RG.GNNConfig)]
    assert dataclasses.asdict(G.GNNConfig("x", "gin", 1, 2)) == \
        dataclasses.asdict(RG.GNNConfig("x", "gin", 1, 2))


@pytest.mark.parametrize("name", list(CASES))
def test_forward_and_loss(name):
    cfg, rcfg, rp, pp, batch = setup(name)
    with torch.no_grad():
        out = G.gnn_fwd(pp, to_t(batch), cfg)
        loss, _ = G.gnn_loss(pp, to_t(batch), cfg)
    close(out.numpy(), RG.gnn_fwd(rp, to_j(batch), rcfg))
    close(float(loss), float(RG.gnn_loss(rp, to_j(batch), rcfg)[0]))
    assert np.isfinite(float(loss))


@pytest.mark.parametrize("name", list(CASES))
def test_gradients(name):
    cfg, rcfg, rp, pp, batch = setup(name)
    rg = jax.grad(lambda p: RG.gnn_loss(p, to_j(batch), rcfg)[0])(rp)
    pp = tree_map(lambda t: t.requires_grad_(), pp)
    loss, _ = G.gnn_loss(pp, to_t(batch), cfg)
    leaves = tree_leaves(pp)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    want = jax.tree_util.tree_leaves(rg)
    assert len(want) == len(grads)
    for g, w, p in zip(grads, want, leaves):
        g = torch.zeros_like(p) if g is None else g
        w = np.asarray(w)
        np.testing.assert_allclose(
            g.numpy(), w, rtol=0,
            atol=GRAD_TOL * max(np.abs(w).max(), 1e-12))


@pytest.mark.parametrize("name", list(CASES))
def test_two_adamw_steps(name):
    cfg, rcfg, rp, pp, batch = setup(name)
    ocfg = OptConfig(peak_lr=1e-3, warmup_steps=1)
    rocfg = RO.OptConfig(peak_lr=1e-3, warmup_steps=1)
    rstep = jax.jit(ref_train_step(
        functools.partial(RG.gnn_loss, cfg=rcfg), rocfg))
    pstep = make_train_step(functools.partial(G.gnn_loss, cfg=cfg), ocfg)
    ropt, popt = RO.init_opt(rp, rocfg), init_opt(pp, ocfg)
    for _ in range(2):
        rp, ropt, rm = rstep(rp, ropt, to_j(batch))
        pp, popt, pm = pstep(pp, popt, to_t(batch))
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(pm[k]), float(rm[k]),
                                       rtol=STEP_RTOL)
    assert int(popt["step"]) == int(ropt["step"]) == 2
    for got, want in zip(tree_leaves(tree_to_numpy(pp)),
                         jax.tree_util.tree_leaves(rp)):
        want = np.asarray(want)
        np.testing.assert_allclose(
            got, want, rtol=0, atol=PARAM_TOL * np.abs(want).max() + 1e-6)


def test_seg_mean_over_empty_segments():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(7, 5)).astype(np.float32)
    idx = np.array([0, 0, 4, 4, 4, 6, 0], np.int32)  # 1, 2, 3, 5 empty
    got = G.seg_mean(torch.from_numpy(x), torch.from_numpy(idx), 8)
    want = RG.seg_mean(jnp.asarray(x), jnp.asarray(idx), 8)
    close(got.numpy(), want)
    assert (got[[1, 2, 3, 5, 7]] == 0).all()
    close(G.seg_sum(torch.from_numpy(x), torch.from_numpy(idx), 8).numpy(),
          RG.seg_sum(jnp.asarray(x), jnp.asarray(idx), 8))


def test_gin_graph_reg_pools_per_graph():
    """gin with task graph_reg pools node states per graph (graph_idx)
    before the head: one output row per graph."""
    cfg, rcfg, rp, pp, batch = setup("gin_graph_reg")
    with torch.no_grad():
        out = G.gnn_fwd(pp, to_t(batch), cfg)
    assert tuple(out.shape) == (3, 1)
    close(out.numpy(), RG.gnn_fwd(rp, to_j(batch), rcfg))


def test_dimenet_without_graph_idx_sums_all_atoms():
    cfg, rcfg, rp, pp, batch = setup("dimenet")
    batch = {k: v for k, v in batch.items() if k != "graph_idx"}
    with torch.no_grad():
        out = G.gnn_fwd(pp, to_t(batch), cfg)
    assert tuple(out.shape) == (1,)
    close(out.numpy(), RG.gnn_fwd(rp, to_j(batch), rcfg))


def test_sampled_sage_trains():
    """Sampler output feeds GraphSAGE directly (the minibatch_lg path),
    as in ``tests/test_substrate.py``: the same block through both."""
    g = dp.random_gnn_graph(100, 400, 8, 4, seed=3)
    order = np.argsort(g["edge_src"], kind="stable")
    src, dst = g["edge_src"][order], g["edge_dst"][order]
    indptr = np.zeros(101, np.int64)
    np.cumsum(np.bincount(src, minlength=100), out=indptr[1:])
    block = dp.NeighborSampler(indptr, dst, fanouts=(4, 3),
                               seed=1).sample(np.arange(8))
    cfg = G.GNNConfig("sage", "sage", 2, 16, in_dim=8, out_dim=4,
                      aggregator="mean")
    rcfg = ref_cfg(cfg)
    rp = RG.init_gnn(jax.random.PRNGKey(0), rcfg)
    pp = gnn_params_from_numpy(jax.tree.map(np.asarray, rp), cfg, "cpu")
    batch = {
        "node_feat": g["node_feat"][block["nodes"]],
        "edge_src": block["edge_src"],
        "edge_dst": block["edge_dst"],
        "labels": g["labels"][block["nodes"]],
        "train_mask": (np.arange(block["nodes"].shape[0]) < 8).astype(
            np.float32),
    }
    loss, _ = G.gnn_loss(pp, to_t(batch), cfg)
    assert np.isfinite(float(loss))
    close(float(loss), float(RG.gnn_loss(rp, to_j(batch), rcfg)[0]))
    ocfg = OptConfig(peak_lr=1e-2, warmup_steps=1)
    step = make_train_step(functools.partial(G.gnn_loss, cfg=cfg), ocfg)
    opt = init_opt(pp, ocfg)
    losses = []
    for _ in range(5):
        pp, opt, m = step(pp, opt, to_t(batch))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0]


def test_converter_refuses_a_mismatched_tree():
    cfg, _, rp, _, _ = setup("gin")
    tree = jax.tree.map(np.asarray, rp)
    bad = dict(tree, layers=tree["layers"][:-1])
    with pytest.raises(ValueError, match="entries"):
        gnn_params_from_numpy(bad, cfg, "cpu")
    bad = jax.tree.map(lambda a: a.astype(np.float64), tree)
    with pytest.raises(ValueError, match="dtype"):
        gnn_params_from_numpy(bad, cfg, "cpu")
    with pytest.raises(ValueError, match="shape"):
        gnn_params_from_numpy(tree, dataclasses.replace(cfg, d_hidden=8),
                              "cpu")


def test_init_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card: nothing to refuse")
    with pytest.raises(RuntimeError):
        G.init_gnn(0, CASES["gin"][0])
    meta = G.init_gnn(0, CASES["gin"][0], device="meta")
    assert all(t.device.type == "meta" for t in tree_leaves(meta))
