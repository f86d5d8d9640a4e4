"""Shared model substrate: dtypes, init, norms, parameter trees.

Parameters are trees of nested dicts (and lists) of tensors with the
reference's keys, so that a tree crosses between the packages leaf by
leaf (``repro_torch.convert``) and the checkpointer writes the
reference's keys.  ``tree_map`` and ``tree_leaves`` walk such trees; like
JAX's, they visit dict keys in sorted order.

Sharding follows the MaxText-style *logical axis* pattern: every param
carries a tuple of logical axis names; a rules dict (``DEFAULT_RULES``)
maps logical names to mesh axes.  ``axis_rules``, ``logical_pspec``,
``tree_shardings`` and ``specs_shardings`` resolve them against a
``launch.mesh.DeviceMesh`` (its ``axis_names`` and ``shape``) into
:class:`NamedSharding` objects whose ``spec`` is a plain tuple, one entry per
dimension: None, a mesh-axis name or a tuple of names (the reference's
``PartitionSpec``).  The dry-run uses them for per-device argument bytes
(``shard_shape``); on one card ``with_logical`` is an identity.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Any

import torch
import torch.nn.functional as F

# ---------------------------------------------------------------------------
# logical axis rules
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


class _Ctx(threading.local):
    def __init__(self):
        self.mesh = None
        self.rules = DEFAULT_RULES


_CTX = _Ctx()


@contextlib.contextmanager
def axis_rules(mesh, rules: dict | None = None):
    """Activate (mesh, rules) for logical sharding constraints."""
    old = (_CTX.mesh, _CTX.rules)
    _CTX.mesh = mesh
    _CTX.rules = dict(DEFAULT_RULES, **(rules or {}))
    try:
        yield
    finally:
        _CTX.mesh, _CTX.rules = old


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A resolved spec on a mesh: ``spec`` holds one entry per leading
    dimension (None, a mesh-axis name or a tuple of names); dimensions
    past its end are replicated."""

    mesh: Any
    spec: tuple

    def shard_shape(self, shape) -> tuple:
        return shard_shape(shape, self.spec, self.mesh)


def _resolve(axes: tuple, rules: dict, mesh) -> tuple:
    """Logical axes → spec tuple, dropping mesh axes absent from mesh."""
    names = set(mesh.axis_names) if mesh is not None else set()

    def fix(a):
        r = rules.get(a)
        if r is None:
            return None
        if isinstance(r, (tuple, list)):
            kept = tuple(x for x in r if x in names)
            return kept if kept else None
        return r if r in names else None

    used: set = set()
    out = []
    for a in axes:
        r = fix(a)
        # a mesh axis may appear only once per spec; later dims replicate
        flat = r if isinstance(r, tuple) else (r,)
        if r is not None and any(x in used for x in flat if x):
            r = None
        if r is not None:
            used.update(x for x in flat if x)
        out.append(r)
    return tuple(out)


def logical_pspec(axes: tuple, mesh=None, rules: dict | None = None) -> tuple:
    mesh = mesh if mesh is not None else _CTX.mesh
    rules = dict(DEFAULT_RULES, **(rules or {})) if rules else _CTX.rules
    return _resolve(axes, rules, mesh)


def with_logical(x: torch.Tensor, axes: tuple) -> torch.Tensor:
    """The reference's sharding constraint by logical axes: an identity
    on one card."""
    return x


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(a, (str, type(None)))
                                        for a in x)


def tree_shardings(axes_tree, mesh, rules: dict | None = None):
    """Mirror an axes tree into NamedShardings (a tuple of axis names,
    or (), is a leaf)."""
    rules = dict(DEFAULT_RULES, **(rules or {}))

    def walk(t):
        if _is_axes(t):
            return NamedSharding(mesh, _resolve(t, rules, mesh))
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        return type(t)(walk(v) for v in t)

    return walk(axes_tree)


def _axis_size(mesh, r) -> int:
    sizes = mesh.shape
    if isinstance(r, tuple):
        n = 1
        for x in r:
            n *= sizes[x]
        return n
    return sizes[r]


def specs_shardings(specs_tree, axes_tree, mesh, rules: dict | None = None):
    """NamedShardings for a tree of ``TensorSpec`` leaves, dropping (or
    shrinking) the sharding of any dimension whose size is not divisible
    by the mapped mesh-axis product — e.g. batch=1 decode stays
    replicated over 'data' while its KV cache still shards over
    'model'."""
    rules = dict(DEFAULT_RULES, **(rules or {}))

    def resolve(spec, axes):
        base = _resolve(tuple(axes), rules, mesh)
        fixed = []
        for dim, r in zip(spec.shape, tuple(base) + (None,) * (len(spec.shape) - len(base))):
            if r is None:
                fixed.append(None)
                continue
            cand = r if isinstance(r, tuple) else (r,)
            # greedily drop trailing axes until divisible
            while cand and dim % _axis_size(mesh, tuple(cand)) != 0:
                cand = cand[:-1]
            fixed.append(tuple(cand) if len(cand) > 1 else (cand[0] if cand else None))
        return NamedSharding(mesh, tuple(fixed))

    return tree_map(resolve, specs_tree, axes_tree)


def replicated(mesh):
    return NamedSharding(mesh, ())


def shard_shape(shape, spec: tuple, mesh) -> tuple:
    """The per-device shape of an array of ``shape`` under ``spec`` on
    ``mesh``: each dimension over the product of its mesh axes, rounded
    up (an uneven last shard is padded, as XLA pads it)."""
    out = []
    for i, dim in enumerate(shape):
        r = spec[i] if i < len(spec) else None
        n = 1 if r is None else _axis_size(mesh, r)
        out.append(-(-int(dim) // n))
    return tuple(out)


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
