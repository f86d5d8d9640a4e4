"""Step factories: a uniform (params, opt_state, batch) -> step interface
on ``torch.autograd``."""

from __future__ import annotations

import torch

from repro_torch.models.common import tree_leaves, tree_map

from .optim import OptConfig, adamw_update


def make_train_step(loss_fn, opt_cfg: OptConfig):
    """loss_fn(params, batch) -> (loss, metrics).  The step differentiates
    the loss with respect to every floating-point leaf of ``params`` and
    returns (new params, new opt state, metrics) as new tensors."""

    def train_step(params, opt_state, batch):
        params = tree_map(
            lambda p: p.detach().requires_grad_(p.is_floating_point()),
            params)
        leaves = [p for p in tree_leaves(params) if p.requires_grad]
        with torch.enable_grad():
            loss, metrics = loss_fn(params, batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        by_leaf = {id(p): g for p, g in zip(leaves, grads) if g is not None}
        grads = tree_map(
            lambda p: by_leaf[id(p)] if id(p) in by_leaf
            else torch.zeros_like(p), params)
        params, opt_state, opt_metrics = adamw_update(
            grads, opt_state, tree_map(torch.Tensor.detach, params), opt_cfg)
        metrics = {k: v.detach() for k, v in dict(metrics,
                                                  **opt_metrics).items()}
        return params, opt_state, metrics

    return train_step


def make_eval_step(loss_fn):
    @torch.no_grad()
    def eval_step(params, batch):
        _, metrics = loss_fn(params, batch)
        return metrics

    return eval_step
