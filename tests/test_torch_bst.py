"""The port's BST (``repro_torch.models.bst``) against the reference
(``repro.models.bst``) on the same inputs: the reference's ``jax.random``
init carried across by ``convert.bst_params_from_numpy`` and the same
``ClickStream`` batches, on a small config.

Tolerances, stated once:

- float32 (``compute_dtype="f32"``): embedding bags, logits, losses,
  serve probabilities and retrieval scores within rtol 1e-5 plus 1e-5
  of the output's largest magnitude; gradients within 1e-4 of each
  leaf's largest magnitude;
- ``compute_dtype="bf16"`` (the sparse step's activations): logits
  within two bf16 ulps (2**-7 relative) of the batch's largest logit —
  XLA and PyTorch round the products' sums, the leaky ReLU and the
  norms' outputs to bf16 in other orders; the sparse step's losses and
  gradient norms within the same 2**-7, relative;
- ``bst_sparse_train_step`` over 3 steps with duplicate ids: losses
  and gradient norms within rtol 1e-4, parameters and both Adagrad
  accumulators within 1e-5 of each leaf's largest magnitude plus 1e-6;
  rows that no batch touched bit for bit.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import bst as RB
from repro.train import optim as RO
from repro_torch.configs.bst_arch import SMOKE, retrieval_batch
from repro_torch.convert import (bst_params_from_numpy,
                                 bst_sparse_opt_from_numpy, tree_to_numpy)
from repro_torch.data.pipeline import ClickStream
from repro_torch.models import bst as B
from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.train.optim import OptConfig, init_opt
from tests._torch_threads import one_torch_thread  # noqa: F401

RTOL = 1e-5
GRAD_TOL = 1e-4
STEP_RTOL = 1e-4
PARAM_TOL = 1e-5
BF16_ULPS = 2 * 2.0 ** -8

CFG = dataclasses.replace(SMOKE, n_items=300, n_profile=120)
BATCH = 12


def stream(cfg=CFG, batch=BATCH, seed=0):
    return ClickStream(n_items=cfg.n_items, n_profile=cfg.n_profile,
                       seq_len=cfg.seq_len, batch=batch,
                       bag_nnz=cfg.bag_nnz_per_row, n_dense=cfg.n_dense,
                       seed=seed)


def ref_cfg(cfg):
    return RB.BSTConfig(**dataclasses.asdict(cfg))


@functools.lru_cache(maxsize=None)
def ref_params(cfg=CFG, seed=0):
    return RB.init_bst(jax.random.PRNGKey(seed), ref_cfg(cfg))


def port_params(cfg=CFG, seed=0):
    return bst_params_from_numpy(jax.tree.map(np.asarray,
                                              ref_params(cfg, seed)),
                                 cfg, "cpu")


def to_j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def to_t(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def close(got, want, rtol=RTOL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


def test_config_is_a_copy():
    assert dataclasses.asdict(ref_cfg(CFG)) == dataclasses.asdict(CFG)
    assert dataclasses.asdict(B.BSTConfig()) == dataclasses.asdict(
        RB.BSTConfig())


class TestEmbeddingBag:
    """The twins of ``tests/test_substrate.py::TestEmbeddingBag``, and the
    reference on the same ids."""

    def test_matches_dense_multihot(self):
        rng = np.random.default_rng(0)
        table = rng.normal(size=(30, 8)).astype(np.float32)
        ids = np.array([3, 5, 0, 7, 7, 2], np.int32)  # 0 = padding
        seg = np.array([0, 0, 0, 1, 1, 1], np.int32)
        out = B.embedding_bag(*map(torch.from_numpy, (table, ids, seg)), 2)
        np.testing.assert_allclose(out[0].numpy(), table[3] + table[5],
                                   rtol=1e-6)
        np.testing.assert_allclose(out[1].numpy(), 2 * table[7] + table[2],
                                   rtol=1e-6)

    def test_mean_combiner(self):
        table = torch.eye(4)
        ids = torch.tensor([1, 2, 0, 3], dtype=torch.int32)
        seg = torch.tensor([0, 0, 0, 1], dtype=torch.int32)
        out = B.embedding_bag(table, ids, seg, 2, combiner="mean")
        np.testing.assert_allclose(out[0].numpy(), [0, 0.5, 0.5, 0],
                                   rtol=1e-6)

    @pytest.mark.parametrize("combiner", ["sum", "mean"])
    def test_equals_reference(self, combiner):
        rng = np.random.default_rng(1)
        table = rng.normal(size=(50, 6)).astype(np.float32)
        ids = rng.integers(0, 50, 40).astype(np.int32)
        ids[::5] = 0  # padding, and a bag (row 3) of padding only
        seg = np.sort(rng.integers(0, 7, 40)).astype(np.int32)
        ids[seg == 3] = 0
        got = B.embedding_bag(*map(torch.from_numpy, (table, ids, seg)), 8,
                              combiner=combiner)
        want = RB.embedding_bag(*map(jnp.asarray, (table, ids, seg)), 8,
                                combiner=combiner)
        close(got.numpy(), want)
        assert (got[3] == 0).all() and (got[7] == 0).all()


def test_logits_loss_and_serve():
    p, rp, rc = port_params(), ref_params(), ref_cfg(CFG)
    for step in range(2):
        batch = stream().batch_at(step)
        with torch.no_grad():
            close(B.bst_logits(p, to_t(batch), CFG).numpy(),
                  RB.bst_logits(rp, to_j(batch), rc))
            close(float(B.bst_loss(p, to_t(batch), CFG)[0]),
                  float(RB.bst_loss(rp, to_j(batch), rc)[0]))
            close(B.bst_serve(p, to_t(batch), CFG).numpy(),
                  RB.bst_serve(rp, to_j(batch), rc))


def test_loss_gradients():
    pp, rp, rc = port_params(), ref_params(), ref_cfg(CFG)
    batch = stream().batch_at(3)
    rg = jax.grad(lambda q: RB.bst_loss(q, to_j(batch), rc)[0])(rp)
    pp = tree_map(lambda t: t.requires_grad_(), pp)
    loss, _ = B.bst_loss(pp, to_t(batch), CFG)
    leaves = tree_leaves(pp)
    grads = torch.autograd.grad(loss, leaves)
    want = jax.tree_util.tree_leaves(rg)
    assert len(want) == len(grads)
    for g, w in zip(grads, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=GRAD_TOL * max(np.abs(w).max(),
                                                       1e-12))


def test_retrieval():
    p, rp, rc = port_params(), ref_params(), ref_cfg(CFG)
    batch = retrieval_batch(stream().batch_at(9), CFG.bag_nnz_per_row,
                            CFG.n_items)
    with torch.no_grad():
        got = B.bst_retrieval(p, to_t(batch), CFG)
    assert tuple(got.shape) == (CFG.n_items,)
    close(got.numpy(), RB.bst_retrieval(rp, to_j(batch), rc))


def test_bf16_logits_from_gathered_rows():
    """The sparse step's ``compute_dtype="bf16"`` forward: bf16 scores
    promoted to float32 before the scale (as JAX does for a numpy float64
    divisor), within two bf16 ulps of the largest logit."""
    cfg = dataclasses.replace(CFG, compute_dtype="bf16")
    rc = ref_cfg(cfg)
    p, rp = port_params(), ref_params()
    batch = stream(batch=64).batch_at(4)
    net = B.dense_params(p)
    rnet = B.dense_params(rp)
    seq_ids = np.concatenate([batch["hist"], batch["target"][:, None]], 1)
    seq = B.take_rows(p["item_table"], torch.from_numpy(seq_ids))
    prof = B.embedding_bag(p["profile_table"], *map(
        torch.from_numpy, (batch["bag_ids"], batch["bag_seg"])), 64)
    with torch.no_grad():
        got = B._bst_logits_from_gathered(net, seq, prof, to_t(batch), cfg)
    want = np.asarray(RB._bst_logits_from_gathered(
        rnet, jnp.asarray(seq.numpy()), jnp.asarray(prof.numpy()),
        to_j(batch), rc))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=BF16_ULPS * np.abs(want).max())


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_sparse_step_matches_reference(dtype):
    """Three sparse steps on batches with duplicate ids (zipf hist and
    bag ids repeat within and across examples): the dense part through
    AdamW, both tables through rowwise Adagrad.

    The bf16 path is held against the reference run op by op, which
    rounds every operation's output to bf16 as PyTorch does; under
    ``jax.jit`` XLA fuses operations and skips those roundings (its
    gradient norm here is 0.7% off the float32 one, the op-by-op
    reference's and the port's 0.2%)."""
    cfg = dataclasses.replace(CFG, compute_dtype=dtype)
    rc = ref_cfg(cfg)
    ocfg = OptConfig(peak_lr=1e-3, warmup_steps=2)
    rocfg = RO.OptConfig(peak_lr=1e-3, warmup_steps=2)
    pp, rp = port_params(), ref_params()
    t_opt, rt_opt = B.init_bst_sparse_opt(pp), RB.init_bst_sparse_opt(rp)
    net = B.dense_params(pp)
    rnet = B.dense_params(rp)
    n_opt, rn_opt = init_opt(net, ocfg), RO.init_opt(rnet, rocfg)
    rstep = functools.partial(RB.bst_sparse_train_step, cfg=rc,
                              opt_cfg=rocfg)
    if dtype == "f32":
        rstep = jax.jit(rstep)
    rtol = STEP_RTOL if dtype == "f32" else BF16_ULPS
    for step in range(3):
        batch = stream().batch_at(step)
        assert len(np.unique(batch["hist"])) < batch["hist"].size
        pp, t_opt, n_opt, m = B.bst_sparse_train_step(
            pp, t_opt, n_opt, to_t(batch), cfg, ocfg)
        rp, rt_opt, rn_opt, rm = rstep(rp, rt_opt, rn_opt, to_j(batch))
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(m[k]), float(rm[k]), rtol=rtol)
    if dtype == "bf16":
        return
    for got, want in zip(
            tree_leaves(tree_to_numpy({"p": pp, "t": t_opt})),
            jax.tree_util.tree_leaves({"p": rp, "t": rt_opt})):
        want = np.asarray(want)
        np.testing.assert_allclose(
            got, want, rtol=0, atol=PARAM_TOL * np.abs(want).max() + 1e-6)


def test_duplicate_ids_add_twice():
    """``acc.at[ids].add`` adds once per occurrence; the step then reads
    the accumulated value for every occurrence."""
    acc = torch.zeros(5)
    ids = torch.tensor([1, 3, 1, 1], dtype=torch.int32)
    out = B._scatter_add(acc, ids, torch.tensor([1.0, 2.0, 3.0, 4.0]))
    want = jnp.zeros(5).at[jnp.array([1, 3, 1, 1])].add(
        jnp.array([1.0, 2.0, 3.0, 4.0]))
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))
    assert (acc == 0).all()  # functional: the input is untouched


def test_sparse_step_touches_only_seen_rows():
    """§Perf H-B1 (the twin of ``tests/test_substrate.py::
    TestSparseBSTStep``): the sparse table update trains (loss drops) and
    leaves the rows that no batch touched bit-identical."""
    cfg = SMOKE
    ocfg = OptConfig(peak_lr=1e-3, warmup_steps=2)
    params = port_params(cfg)
    item0 = params["item_table"].clone()
    prof0 = params["profile_table"].clone()
    t_opt = B.init_bst_sparse_opt(params)
    n_opt = init_opt(B.dense_params(params), ocfg)
    s = stream(cfg, batch=16)
    losses, seen, seen_prof = [], set(), set()
    for i in range(5):
        raw = s.batch_at(i)
        seen.update(raw["hist"].ravel().tolist())
        seen.update(raw["target"].ravel().tolist())
        seen_prof.update(raw["bag_ids"].ravel().tolist())
        params, t_opt, n_opt, m = B.bst_sparse_train_step(
            params, t_opt, n_opt, to_t(raw), cfg, ocfg)
        losses.append(float(m["loss"]))
    assert all(np.isfinite(v) for v in losses)
    assert losses[-1] < losses[0]
    for table0, table1, rows in ((item0, params["item_table"], seen),
                                 (prof0, params["profile_table"],
                                  seen_prof - {0})):
        touched = np.array(sorted(rows))
        untouched = np.setdiff1d(np.arange(table0.shape[0]), touched)
        np.testing.assert_array_equal(table1[untouched].numpy(),
                                      table0[untouched].numpy())
        assert (table1[touched] - table0[touched]).abs().max() > 0
    # the padding id gets a zero gradient: its row is unchanged too
    assert torch.equal(params["profile_table"][0], prof0[0])


class TestOutOfRangeIds:
    """``jnp.take``'s default mode: an id in [-rows, 0) counts from the
    end, any other id outside the table gives a NaN row, so its
    example's logit is NaN and the others are untouched.  The port
    clamps the index and masks the row, so it reads nothing past the
    table."""

    def test_take_rows(self):
        table = np.arange(12, dtype=np.float32).reshape(4, 3)
        ids = np.array([[1, 4], [-1, -5]], np.int32)
        got = B.take_rows(torch.from_numpy(table), torch.from_numpy(ids))
        want = np.asarray(jnp.take(jnp.asarray(table), jnp.asarray(ids),
                                   axis=0))
        np.testing.assert_array_equal(got.numpy(), want)
        assert np.isnan(want[0, 1]).all() and np.isnan(want[1, 1]).all()

    def test_scatter_add_drops(self):
        ids = np.array([1, 5, -1, -6], np.int32)
        got = B._scatter_add(torch.zeros(4), torch.from_numpy(ids),
                             torch.ones(4))
        want = jnp.zeros(4).at[jnp.asarray(ids)].add(1.0)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    def test_logits(self):
        p, rp, rc = port_params(), ref_params(), ref_cfg(CFG)
        batch = stream().batch_at(5)
        batch["hist"][2, 3] = CFG.n_items + 7
        batch["target"][5] = CFG.n_items
        batch["bag_ids"][8 * CFG.bag_nnz_per_row] = CFG.n_profile + 1
        with torch.no_grad():
            got = B.bst_logits(p, to_t(batch), CFG).numpy()
        want = np.asarray(RB.bst_logits(rp, to_j(batch), rc))
        bad = [2, 5, 8]
        assert np.isnan(want[bad]).all() and np.isnan(got[bad]).all()
        ok = np.setdiff1d(np.arange(BATCH), bad)
        close(got[ok], want[ok])

    def test_retrieval_candidate(self):
        p, rp, rc = port_params(), ref_params(), ref_cfg(CFG)
        batch = retrieval_batch(stream().batch_at(9), CFG.bag_nnz_per_row,
                                16)
        batch["candidates"][[3, 9]] = [CFG.n_items, -CFG.n_items - 1]
        with torch.no_grad():
            got = B.bst_retrieval(p, to_t(batch), CFG).numpy()
        want = np.asarray(RB.bst_retrieval(rp, to_j(batch), rc))
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        assert np.isnan(got[[3, 9]]).all()
        close(got[~np.isnan(want)], want[~np.isnan(want)])


def test_sparse_opt_converter():
    rp = ref_params()
    tree = jax.tree.map(np.asarray, RB.init_bst_sparse_opt(rp))
    got = bst_sparse_opt_from_numpy(tree, "cpu")
    assert tuple(got["item_acc"].shape) == (CFG.n_items,)
    with pytest.raises(ValueError, match="keys"):
        bst_sparse_opt_from_numpy({"item_acc": tree["item_acc"]}, "cpu")
    with pytest.raises(ValueError, match="dtype"):
        bst_sparse_opt_from_numpy(
            dict(tree, item_acc=tree["item_acc"].astype(np.float64)), "cpu")
    with pytest.raises(ValueError, match="shape"):
        bst_sparse_opt_from_numpy(
            dict(tree, item_acc=tree["item_acc"][:, None]), "cpu")


def test_init_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card: nothing to refuse")
    with pytest.raises(RuntimeError):
        B.init_bst(0, CFG)
