"""Cell builders shared by the five LM architectures."""

from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.dist.cluster import resolve_device
from repro_torch.models import transformer as T
from repro_torch.models.common import DTypePolicy
from repro_torch.train.optim import OptConfig, init_opt
from repro_torch.train.steps import make_train_step

from .base import Arch, Cell, TensorSpec, register, spec_tree

# assigned LM shapes (identical across the five archs)
LM_SHAPES = {
    "train_4k": dict(kind="train", seq=4_096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32_768, batch=32),
    "decode_32k": dict(kind="decode", seq=32_768, batch=128),
    "long_500k": dict(kind="decode", seq=524_288, batch=1),
}


def _opt_cfg(policy: DTypePolicy) -> OptConfig:
    return OptConfig(moment_dtype=policy.opt_state)


def lm_param_state(cfg: T.LMConfig, policy: DTypePolicy):
    """(param_specs, param_axes, opt_specs, opt_axes) from an init on the
    meta device (shapes and dtypes only; nothing is allocated)."""
    params = T.init_lm(0, cfg, policy, device="meta")
    p_axes = T.lm_axes(cfg)
    o_specs = spec_tree(init_opt(params, _opt_cfg(policy)))
    o_axes = {"m": p_axes, "v": p_axes, "step": ()}
    return spec_tree(params), p_axes, o_specs, o_axes


def _batch_specs(batch: int, seq: int):
    return {
        "tokens": TensorSpec((batch, seq), torch.int32),
        "loss_mask": TensorSpec((batch, seq), torch.float32),
    }


_BATCH_AXES = {"tokens": ("batch", "seq"), "loss_mask": ("batch", "seq")}


def lm_cells(name: str, cfg: T.LMConfig, policy: DTypePolicy,
             long_500k_skip: str | None):
    cells = []
    p_specs, p_axes, o_specs, o_axes = lm_param_state(cfg, policy)
    train_step = make_train_step(
        functools.partial(T.lm_loss, cfg=cfg), _opt_cfg(policy))

    for shape, meta in LM_SHAPES.items():
        kind = meta["kind"]
        if kind == "train":
            cells.append(
                Cell(
                    arch=name, shape=shape, kind="train",
                    step_fn=train_step,
                    arg_specs=(p_specs, o_specs,
                               _batch_specs(meta["batch"], meta["seq"])),
                    arg_axes=(p_axes, o_axes, _BATCH_AXES),
                )
            )
        elif kind == "prefill":
            cells.append(
                Cell(
                    arch=name, shape=shape, kind="prefill",
                    step_fn=functools.partial(T.lm_prefill, cfg=cfg),
                    arg_specs=(
                        p_specs,
                        TensorSpec((meta["batch"], meta["seq"]), torch.int32),
                    ),
                    arg_axes=(p_axes, ("batch", "seq")),
                )
            )
        else:  # decode
            skip = long_500k_skip if shape == "long_500k" else None
            # pure sliding-window archs keep a ring-buffer cache of window
            # slots (starcoder2's long_500k story); others cache seq_len.
            cache_len = meta["seq"]
            if cfg.window is not None and cfg.global_every is None:
                cache_len = min(cache_len, cfg.window)
            cells.append(
                Cell(
                    arch=name, shape=shape, kind="decode",
                    step_fn=functools.partial(T.lm_decode_step, cfg=cfg),
                    arg_specs=(
                        p_specs,
                        T.cache_spec(cfg, meta["batch"], cache_len),
                        TensorSpec((meta["batch"], 1), torch.int32),
                        TensorSpec((), torch.int32),
                    ),
                    arg_axes=(p_axes, T.cache_axes(cfg), ("batch", None), ()),
                    skip=skip,
                )
            )
    return cells


def lm_smoke(cfg_smoke: T.LMConfig, device="cuda"):
    """Tiny real train+decode run asserting shapes + no NaNs."""
    dev = resolve_device(device)
    policy = DTypePolicy()
    params = T.init_lm(0, cfg_smoke, policy, device=dev)
    opt = init_opt(params, _opt_cfg(policy))
    step = make_train_step(functools.partial(T.lm_loss, cfg=cfg_smoke),
                           _opt_cfg(policy))
    rng = np.random.default_rng(0)
    batch = {
        "tokens": torch.from_numpy(
            rng.integers(0, cfg_smoke.vocab, (2, 64)).astype(np.int32)).to(dev),
        "loss_mask": torch.ones((2, 64), dtype=torch.float32, device=dev),
    }
    losses = []
    for _ in range(3):
        params, opt, metrics = step(params, opt, batch)
        losses.append(float(metrics["loss"]))
        if not np.isfinite(losses[-1]):
            raise RuntimeError(f"{cfg_smoke.name}: NaN loss")
    # decode one token
    cache = T.init_cache(T.cache_spec(cfg_smoke, 2, 64), dev)
    logits, cache = T.lm_decode_step(params, cache, batch["tokens"][:, :1],
                                     0, cfg_smoke)
    if tuple(logits.shape) != (2, cfg_smoke.vocab):
        raise RuntimeError(f"{cfg_smoke.name}: logits {tuple(logits.shape)}")
    if not bool(torch.isfinite(logits).all()):
        raise RuntimeError(f"{cfg_smoke.name}: NaN decode logits")
    return {"losses": losses, "loss_drop": losses[0] - losses[-1]}


def make_lm_arch(name, cfg, smoke_cfg, policy=None, long_500k_skip=None,
                 describe=""):
    policy = policy or DTypePolicy()
    return register(
        Arch(
            name=name,
            family="lm",
            cells_fn=functools.partial(
                lm_cells, name, cfg, policy, long_500k_skip
            ),
            smoke_fn=functools.partial(lm_smoke, smoke_cfg),
            describe=describe,
        )
    )
