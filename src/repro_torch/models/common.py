"""Shared model substrate: dtypes, init, norms, parameter trees.

Parameters are trees of nested dicts (and lists) of tensors with the
reference's keys, so that a tree crosses between the packages leaf by
leaf (``repro_torch.convert``) and the checkpointer writes the
reference's keys.  ``tree_map`` and ``tree_leaves`` walk such trees; like
JAX's, they visit dict keys in sorted order.

The logical-axis rules stay as data (``DEFAULT_RULES``); on one card
``with_logical`` is an identity.  The reference's ``axis_rules``,
``tree_shardings``, ``specs_shardings`` and ``replicated`` resolve axes
against a JAX mesh for its TPU dry-run; they are ported with that driver.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F

# ---------------------------------------------------------------------------
# logical axis rules (data: nothing resolves them on one card)
# ---------------------------------------------------------------------------
# 'embed' (d_model) is the FSDP axis; 'heads'/'mlp'/'vocab'/'experts' are the
# tensor/expert-parallel axes; 'batch' is pure data parallel.
DEFAULT_RULES: dict[str, Any] = {
    "batch": ("pod", "data"),
    "embed": "data",           # FSDP: params gathered per-layer at use
    "heads": "model",
    "kv_heads": "model",
    "mlp": "model",
    "vocab": "model",
    "vocab_tbl": "model",      # input embedding table rows
    "embed_tbl": "data",       # input embedding table columns (FSDP)
    "experts": "model",
    "expert_mlp": None,
    "seq": None,
    "kv_seq": "model",         # decode KV caches: sequence-sharded
    "head_dim": None,
    "layers": None,
    "q_lora": None,
    "kv_lora": None,
    # GNN / recsys / KSP logical axes
    "nodes": ("pod", "data"),
    "edges": ("pod", "data"),
    "feat": None,
    "hidden": "model",
    "rows": "model",           # embedding-table rows
    "candidates": ("pod", "data"),
    "problems": ("pod", "data"),
    # subgraph slabs have no tensor-parallel dimension: shard them over
    # every mesh axis
    "subgraphs": ("pod", "data", "model"),
}


def with_logical(x: torch.Tensor, axes: tuple) -> torch.Tensor:
    """The reference's sharding constraint by logical axes: an identity
    on one card."""
    return x


# ---------------------------------------------------------------------------
# parameter trees
# ---------------------------------------------------------------------------
def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``); dicts, lists and tuples are nodes, anything else a leaf."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves in JAX's order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


# ---------------------------------------------------------------------------
# dtype policy
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class DTypePolicy:
    param: torch.dtype = torch.float32
    compute: torch.dtype = torch.bfloat16
    opt_state: torch.dtype = torch.float32


# large-model policy for dry-runs at 671B scale: bf16 master + bf16 moments
LARGE_POLICY = DTypePolicy(torch.bfloat16, torch.bfloat16, torch.bfloat16)
DEFAULT_POLICY = DTypePolicy()


# ---------------------------------------------------------------------------
# initializers / layers (plain functions on tensors)
# ---------------------------------------------------------------------------
def make_generator(gen, device) -> torch.Generator | None:
    """``gen`` as a ``torch.Generator`` on ``device``: a generator is
    taken as it is, an int seeds a new one.  None on the meta device,
    which draws nothing."""
    dev = torch.device(device)
    if dev.type == "meta":
        return None
    if isinstance(gen, torch.Generator):
        return gen
    g = torch.Generator(device=dev)
    g.manual_seed(int(gen))
    return g


def normal_init(gen, shape, dtype, scale: float | None = None,
                device="cuda"):
    """Truncated normal on [-2, 2] times ``scale`` (default fan-in:
    1/sqrt(shape[0]) for matrices), drawn in float32 from ``gen`` and cast
    to ``dtype``.  On the meta device it allocates and draws nothing."""
    fan_in = shape[0] if len(shape) > 1 else shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(max(1, fan_in))
    x = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    if x.device.type != "meta":
        torch.nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=gen)
        x.mul_(scale)
    return x.to(dtype)


def rms_norm(x, gamma, eps: float = 1e-6):
    dt = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * (1.0 + gamma.float())).to(dt)


def layer_norm(x, gamma, beta, eps: float = 1e-5):
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, correction=0)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * gamma.float() + beta.float()).to(dt)


def gelu(x):
    return F.gelu(x, approximate="tanh")


def count_params(params) -> int:
    return int(sum(x.numel() for x in tree_leaves(params)
                   if isinstance(x, torch.Tensor)))


def tree_bytes(params) -> int:
    return int(sum(x.numel() * x.element_size() for x in tree_leaves(params)
                   if isinstance(x, torch.Tensor)))
