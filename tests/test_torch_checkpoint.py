"""The port's checkpointer (``repro_torch.ckpt``): twins of the
reference's checkpointer tests (``tests/test_dist.py``), checkpoints
crossing between the packages in both directions (float32 and int leaves
bit for bit), and bf16 leaves, which numpy cannot name."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt.checkpoint import Checkpointer as RefCheckpointer
from repro.configs import deepseek_v3_671b
from repro.models import common as RC
from repro.models import transformer as RT
from repro.train import optim as RO
from repro_torch.ckpt.checkpoint import Checkpointer
from repro_torch.configs import deepseek_v3_671b as p_v3
from repro_torch.convert import (lm_params_from_numpy, opt_state_from_numpy,
                                 tree_to_numpy)
from repro_torch.models import common as C
from repro_torch.models import transformer as T
from repro_torch.train.optim import OptConfig, init_opt
from tests._torch_threads import one_torch_thread  # noqa: F401


def _state():
    return {
        "params": {"w": torch.arange(12.0).reshape(3, 4), "b": torch.ones(4)},
        "opt": [{"m": torch.zeros(3)}, {"v": torch.full((2, 2), 7.0)}],
        "step": torch.tensor(5, dtype=torch.int32),
        "ids": torch.arange(6, dtype=torch.int64),
    }


def _equal_trees(a, b):
    fa, fb = C.tree_leaves(a), C.tree_leaves(b)
    assert len(fa) == len(fb)
    for x, y in zip(fa, fb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


def test_pytree_checkpointer_roundtrip(tmp_path):
    """Save/restore/gc, as the reference's twin checks it."""
    ck = Checkpointer(str(tmp_path), keep=2)
    state = _state()
    for step in [1, 2, 3]:
        ck.save(step, state, blocking=True)
    assert ck.list_steps() == [2, 3]  # keep=2 gc'd step 1
    step, got = ck.restore(device="cpu")
    assert step == 3
    _equal_trees(got, state)
    assert not [n for n in os.listdir(tmp_path) if n.startswith(".tmp")]


def test_async_save(tmp_path):
    ck = Checkpointer(str(tmp_path))
    x = torch.ones(8)
    ck.save(5, {"x": x}, blocking=False)
    x.mul_(3)  # the save holds its own copy
    ck.wait()
    step, got = ck.restore(device="cpu")
    assert step == 5 and torch.equal(got["x"], torch.ones(8))


def test_restore_placement_and_missing(tmp_path):
    ck = Checkpointer(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        ck.restore(device="cpu")
    ck.save(1, _state())
    placement = C.tree_map(lambda _: "cpu", _state())
    _, got = ck.restore(placement=placement)
    _equal_trees(got, _state())
    assert ck.latest_step() == 1


def test_port_checkpoint_restores_in_reference(tmp_path):
    Checkpointer(str(tmp_path)).save(7, _state())
    step, got = RefCheckpointer(str(tmp_path)).restore()
    assert step == 7
    want = tree_to_numpy(_state())
    for k in ("w", "b"):
        np.testing.assert_array_equal(got["params"][k], want["params"][k])
        assert got["params"][k].dtype == want["params"][k].dtype
    np.testing.assert_array_equal(got["opt"][1]["v"], want["opt"][1]["v"])
    assert got["step"].dtype == np.int32 and int(got["step"]) == 5
    np.testing.assert_array_equal(got["ids"], np.arange(6))


def test_reference_checkpoint_restores_in_port(tmp_path):
    """The reference's LM parameters and optimizer state (float32 and
    int32) load in the port bit for bit, as the converter gives them."""
    rcfg, pcfg = deepseek_v3_671b.SMOKE, p_v3.SMOKE
    rp = jax.jit(lambda k: RT.init_lm(k, rcfg, RC.DEFAULT_POLICY))(
        jax.random.PRNGKey(0))
    ro = RO.init_opt(rp, RO.OptConfig())
    RefCheckpointer(str(tmp_path)).save(3, {"params": rp, "opt": ro})
    step, got = Checkpointer(str(tmp_path)).restore(device="cpu")
    assert step == 3
    host = jax.tree.map(np.asarray, {"params": rp, "opt": ro})
    _equal_trees(got["params"], lm_params_from_numpy(host["params"], pcfg,
                                                      "cpu"))
    _equal_trees(got["opt"], opt_state_from_numpy(host["opt"], pcfg, "cpu"))


def test_bf16_round_trips(tmp_path):
    """bf16 leaves: saved as their bits (named in the manifest), back in
    the port as bf16; in the reference as uint16 bits; a reference bf16
    checkpoint (raw 2-byte void in the file) loads in the port as bf16."""
    cfg = p_v3.SMOKE
    params = T.init_lm(1, cfg, C.LARGE_POLICY, device="cpu")
    state = {"params": params,
             "opt": init_opt(params, OptConfig(moment_dtype=torch.bfloat16))}
    ck = Checkpointer(str(tmp_path / "port"))
    ck.save(1, state)
    _, got = ck.restore(device="cpu")
    _equal_trees(got, state)
    with open(tmp_path / "port" / "step-0000000001" / "manifest.json") as f:
        manifest = json.load(f)
    assert "params/embed" in manifest["bf16_keys"]
    assert "opt/step" not in manifest["bf16_keys"]

    _, ref_view = RefCheckpointer(str(tmp_path / "port")).restore()
    bits = ref_view["params"]["embed"]
    assert bits.dtype == np.uint16
    np.testing.assert_array_equal(
        bits.view(jnp.bfloat16),
        tree_to_numpy(params["embed"], bf16=jnp.bfloat16))

    ref_state = jax.tree.map(jnp.asarray,
                             tree_to_numpy(state, bf16=jnp.bfloat16))
    RefCheckpointer(str(tmp_path / "ref")).save(2, ref_state)
    _, got = Checkpointer(str(tmp_path / "ref")).restore(device="cpu")
    _equal_trees(got, state)
