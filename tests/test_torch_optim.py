"""The port's optimizer and train step (``repro_torch.train``): twins of
the optimizer and compression tests of ``tests/test_substrate.py``, each
also held against ``repro.train`` on the same inputs, and one
``make_train_step`` step on a tiny LM against the reference's."""

import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from tests._hypothesis_compat import given, settings, st

from repro.models import transformer as RT
from repro.train import optim as RO
from repro.train.steps import make_train_step as ref_train_step
from repro_torch.convert import tree_from_numpy, tree_to_numpy
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import transformer as T
from repro_torch.models.common import DEFAULT_POLICY, tree_leaves
from repro_torch.train.optim import (OptConfig, adamw_update,
                                     compress_int8, compressed_psum,
                                     decompress_int8, global_norm, init_opt,
                                     lr_at)
from repro_torch.train.steps import make_eval_step, make_train_step
from tests._torch_threads import one_torch_thread  # noqa: F401


def t(x):
    return torch.tensor(x, dtype=torch.float32)


class TestOptimizer:
    def test_adamw_first_step_is_lr_signish(self):
        cfg = OptConfig(peak_lr=1e-2, warmup_steps=1, weight_decay=0.0)
        params = {"w": t([1.0, -2.0, 3.0])}
        opt = init_opt(params, cfg)
        grads = {"w": t([0.1, -0.2, 0.3])}
        new_p, new_opt, m = adamw_update(grads, opt, params, cfg)
        # bias-corrected first Adam step ≈ lr * sign(g)
        np.testing.assert_allclose(
            new_p["w"].numpy(),
            params["w"].numpy() - 1e-2 * np.sign([0.1, -0.2, 0.3]),
            rtol=1e-3,
        )
        assert int(new_opt["step"]) == 1

    def test_clipping(self):
        cfg = OptConfig(clip_norm=1.0, warmup_steps=1)
        params = {"w": torch.zeros(3)}
        opt = init_opt(params, cfg)
        grads = {"w": t([300.0, 400.0, 0.0])}  # norm 500
        _, _, m = adamw_update(grads, opt, params, cfg)
        assert abs(float(m["grad_norm"]) - 500.0) < 1e-3

    def test_lr_schedule(self):
        cfg = OptConfig(peak_lr=1.0, warmup_steps=10, decay_steps=110,
                        min_lr_ratio=0.1)
        assert float(lr_at(5, cfg)) == pytest.approx(0.5)
        assert float(lr_at(10, cfg)) == pytest.approx(1.0)
        assert float(lr_at(110, cfg)) == pytest.approx(0.1)

    def test_lr_schedule_equals_reference(self):
        cfg = OptConfig(peak_lr=3e-4, warmup_steps=10, decay_steps=200)
        rcfg = RO.OptConfig(peak_lr=3e-4, warmup_steps=10, decay_steps=200)
        steps = np.arange(0, 260, 7, dtype=np.int32)
        np.testing.assert_allclose(
            lr_at(torch.from_numpy(steps), cfg).numpy(),
            np.asarray(RO.lr_at(jnp.asarray(steps), rcfg)), rtol=1e-5)

    def test_convergence_on_quadratic(self):
        cfg = OptConfig(peak_lr=0.1, warmup_steps=5, decay_steps=200,
                        weight_decay=0.0)
        params = {"w": t([5.0, -3.0])}
        opt = init_opt(params, cfg)
        for _ in range(150):
            grads = {"w": 2 * params["w"]}
            params, opt, _ = adamw_update(grads, opt, params, cfg)
        assert float(params["w"].abs().max()) < 0.1

    def test_update_equals_reference(self):
        """Ten AdamW steps on a two-leaf tree (one clipped): params,
        moments and step within float32 rounding (rtol 1e-5)."""
        rng = np.random.default_rng(0)
        p = {"a": rng.normal(size=(4, 3)).astype(np.float32),
             "b": rng.normal(size=5).astype(np.float32)}
        cfg = OptConfig(peak_lr=1e-2, warmup_steps=3, decay_steps=20)
        rcfg = RO.OptConfig(peak_lr=1e-2, warmup_steps=3, decay_steps=20)
        pp, po = tree_from_numpy(p, "cpu"), None
        rp, ro = jax.tree.map(jnp.asarray, p), None
        po, ro = init_opt(pp, cfg), RO.init_opt(rp, rcfg)
        for i in range(10):
            g = {k: (rng.normal(size=v.shape) * (3.0 if i % 2 else 0.1))
                 .astype(np.float32) for k, v in p.items()}
            pp, po, pm = adamw_update(tree_from_numpy(g, "cpu"), po, pp, cfg)
            rp, ro, rm = RO.adamw_update(jax.tree.map(jnp.asarray, g), ro,
                                         rp, rcfg)
        for k in p:
            np.testing.assert_allclose(pp[k].numpy(), np.asarray(rp[k]),
                                       rtol=1e-5, atol=1e-7)
            for s in ("m", "v"):
                np.testing.assert_allclose(po[s][k].numpy(),
                                           np.asarray(ro[s][k]),
                                           rtol=1e-5, atol=1e-9)
        assert int(po["step"]) == int(ro["step"]) == 10
        np.testing.assert_allclose(float(pm["grad_norm"]),
                                   float(rm["grad_norm"]), rtol=1e-5)
        np.testing.assert_allclose(float(global_norm(pp)),
                                   float(RO.global_norm(rp)), rtol=1e-5)


class TestCompression:
    @settings(max_examples=20, deadline=None)
    @given(st.integers(0, 10_000))
    def test_int8_roundtrip_error_bounded(self, seed):
        rng = np.random.default_rng(seed)
        g = torch.from_numpy(rng.normal(size=64).astype(np.float32))
        q, scale = compress_int8(g)
        back = decompress_int8(q, scale)
        assert q.dtype == torch.int8
        assert float((back - g).abs().max()) <= float(scale) / 2 + 1e-7

    def test_error_feedback_accumulates(self):
        g = t([1e-4, 0.5, -0.25])
        q, scale = compress_int8(g)
        resid = g - decompress_int8(q, scale)
        # tiny component is preserved in the residual for the next round
        assert abs(float(resid[0])) > 0

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_int8_equals_reference(self, seed):
        g = np.random.default_rng(seed).normal(size=257).astype(np.float32)
        q, s = compress_int8(torch.from_numpy(g))
        rq, rs = RO.compress_int8(jnp.asarray(g))
        np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
        assert float(s) == float(rs)

    def test_compressed_psum_on_a_host_mesh(self):
        """On one process's n shards (each holding g) the mean of the
        int8 payloads is g's dequantized value; the residual is the
        quantization error, as the reference returns it."""
        g = torch.from_numpy(
            np.random.default_rng(3).normal(size=50).astype(np.float32))
        resid = torch.full((50,), 1e-3)
        for n in (1, 2):
            avg, new_resid = compressed_psum(
                g, make_host_mesh(n, device="cpu"), resid)
            q, scale = compress_int8(g + resid)
            torch.testing.assert_close(avg, decompress_int8(q, scale))
            torch.testing.assert_close(
                new_resid, g + resid - decompress_int8(q, scale))


_PSUM_WORKER = r"""
import os, sys
import numpy as np
import torch
import torch.distributed as dist
from repro_torch.launch.mesh import init_distributed, make_host_mesh
from repro_torch.train.optim import compressed_psum

out = sys.argv[1]
assert init_distributed(device="cpu")
rank = dist.get_rank()
g = torch.from_numpy(np.load(os.path.join(out, "g.npy"))[rank])
avg, resid = compressed_psum(g, make_host_mesh(device="cpu"))
np.savez(os.path.join(out, f"out{rank}.npz"), avg=avg.numpy(),
         resid=resid.numpy())
dist.destroy_process_group()
"""


def test_compressed_psum_across_two_gloo_processes(tmp_path):
    """Two processes, one shard each, joined by gloo: both get
    Σq · (Σscale / 2) / 2 — the reference's psum formula — and keep their
    own quantization error.  Joined with a timeout: a hang fails."""
    g = np.random.default_rng(7).normal(0, 2, (2, 33)).astype(np.float32)
    np.save(tmp_path / "g.npy", g)
    root = Path(__file__).resolve().parent.parent
    env = dict(os.environ, PYTHONPATH=str(root / "src"),
               REPRO_COORDINATOR=f"file://{tmp_path / 'store'}",
               REPRO_NUM_PROCESSES="2", GLOO_SOCKET_IFNAME="lo")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _PSUM_WORKER, str(tmp_path)],
        env=dict(env, REPRO_PROCESS_ID=str(r)), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    logs = []
    try:
        for pr in procs:
            logs.append(pr.communicate(timeout=60)[0])
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
                pr.communicate()
    assert [pr.returncode for pr in procs] == [0, 0], logs
    qs = [RO.compress_int8(jnp.asarray(x)) for x in g]
    q_sum = sum(np.asarray(q, np.int32) for q, _ in qs)
    s_sum = np.float32(sum(float(s) for _, s in qs))
    want = q_sum.astype(np.float32) * (s_sum / 2) / 2
    for r in range(2):
        out = np.load(tmp_path / f"out{r}.npz")
        np.testing.assert_allclose(out["avg"], want, rtol=1e-6)
        q, s = qs[r]
        np.testing.assert_allclose(
            out["resid"], g[r] - np.asarray(RO.decompress_int8(q, s)),
            rtol=1e-6, atol=1e-7)


def test_train_step_equals_reference():
    """One ``make_train_step`` step on a 2-layer LM (the port's weights
    in both packages): the loss within 1e-3 relative (bf16 forward), the
    grad norm within 2**-7 relative (bf16 backward).  A first AdamW step
    moves each parameter by lr = 1e-3 times the sign of its gradient, so
    the updated parameters agree within 1e-6 wherever the reference's
    gradient is over 2**-4 of its leaf's RMS gradient (bf16 backward
    noise is a few percent of it), and elsewhere within 2·lr (the sign
    of a near-zero gradient may differ)."""
    cfg = T.LMConfig(name="tiny", n_layers=2, d_model=32, n_heads=4,
                     n_kv_heads=2, d_ff=64, vocab=64, q_chunk=16,
                     loss_chunk=16)
    rcfg = RT.LMConfig(**{k: getattr(cfg, k) for k in cfg.__dataclass_fields__})
    params = T.init_lm(0, cfg, DEFAULT_POLICY, device="cpu")
    rparams = jax.tree.map(jnp.asarray, tree_to_numpy(params))
    toks = np.random.default_rng(1).integers(0, 64, (2, 32)).astype(np.int32)
    mask = np.ones((2, 32), np.float32)
    ocfg = OptConfig(peak_lr=1e-3, warmup_steps=1)
    rocfg = RO.OptConfig(peak_lr=1e-3, warmup_steps=1)

    step = make_train_step(functools.partial(T.lm_loss, cfg=cfg), ocfg)
    new_p, new_o, m = step(params, init_opt(params, ocfg),
                           {"tokens": torch.from_numpy(toks),
                            "loss_mask": torch.from_numpy(mask)})
    rstep = jax.jit(ref_train_step(
        functools.partial(RT.lm_loss, cfg=rcfg), rocfg))
    rnew_p, rnew_o, rm = rstep(rparams, RO.init_opt(rparams, rocfg),
                               {"tokens": toks, "loss_mask": mask})
    np.testing.assert_allclose(float(m["loss"]), float(rm["loss"]), rtol=1e-3)
    np.testing.assert_allclose(float(m["grad_norm"]), float(rm["grad_norm"]),
                               rtol=2.0 ** -7)
    assert int(new_o["step"]) == 1
    rgrads = jax.grad(lambda p: RT.lm_loss(
        p, {"tokens": toks, "loss_mask": mask}, rcfg)[0])(rparams)
    flat = list(zip(tree_leaves(new_p), jax.tree_util.tree_leaves(rnew_p),
                    jax.tree_util.tree_leaves(rgrads)))
    assert len(flat) == len(tree_leaves(params))
    for a, b, g in flat:
        diff = np.abs(a.numpy() - np.asarray(b))
        g = np.abs(np.asarray(g))
        assert (diff <= 2 * 1e-3 + 1e-6).all()
        near_zero = g < 2.0 ** -4 * np.sqrt(np.mean(g ** 2))
        assert (diff[~near_zero] <= 1e-6).all()
    ev = make_eval_step(functools.partial(T.lm_loss, cfg=cfg))(
        new_p, {"tokens": torch.from_numpy(toks),
                "loss_mask": torch.from_numpy(mask)})
    assert float(ev["loss"]) < float(m["loss"])
