"""Carry the reference package's state into the port, and back.

Everything crosses as plain numpy arrays, so this module needs nothing
of ``repro`` itself: the road graph and the packed subgraph slabs of the
KSP system, and the parameter and optimizer trees of the LM, GNN and BST
families (nested dicts and lists with the reference's keys, dtypes
kept).  numpy has no bfloat16: a bf16 leaf
arrives as an ``ml_dtypes`` array (the reference's own) or as raw 2-byte
void data, and leaves as its uint16 bit patterns unless the caller names
a numpy bfloat16 dtype to view them as.

    g_port = graph_from_numpy({"n": g.n, "edge_u": g.edge_u,
                               "edge_v": g.edge_v, "w": g.w,
                               "directed": g.directed})
    slab = slab_from_numpy(ref_slab.adj, ref_slab.nv, ref_slab.gids,
                           ref_slab.z, ref_slab.epoch, device="cuda")
    params = lm_params_from_numpy(jax.tree.map(np.asarray, ref_params),
                                  cfg, device="cuda")
    params = gnn_params_from_numpy(jax.tree.map(np.asarray, ref_gnn),
                                   gnn_cfg, device="cuda")
"""

from __future__ import annotations

import numpy as np
import torch

from .core.graph import Graph
from .engine.dense import SubgraphSlab, place_slab
from .models import bst as B
from .models import gnn as G
from .models import transformer as T
from .models.common import DEFAULT_POLICY, tree_map


def graph_from_numpy(arrays: dict) -> Graph:
    """The port's :class:`Graph` from ``{"n", "edge_u", "edge_v", "w",
    "directed"}`` — the arguments of the reference ``Graph`` (``w`` is
    taken as the weights at epoch 0)."""
    return Graph(
        int(arrays["n"]),
        np.asarray(arrays["edge_u"], dtype=np.int64),
        np.asarray(arrays["edge_v"], dtype=np.int64),
        np.asarray(arrays["w"], dtype=np.float64),
        directed=bool(arrays["directed"]),
    )


def slab_from_numpy(adj, nv, gids, z: int, epoch: int = 0,
                    device="cuda") -> SubgraphSlab:
    """A packed slab (``adj`` float32 [S, z, z], ``nv`` int32 [S],
    ``gids`` int64 [S]) placed on ``device``."""
    adj = np.ascontiguousarray(adj, dtype=np.float32)
    if adj.ndim != 3 or adj.shape[1:] != (int(z), int(z)):
        raise ValueError(f"adj must be [S, {z}, {z}], got {adj.shape}")
    slab = SubgraphSlab(
        adj=adj.copy(), nv=np.asarray(nv, dtype=np.int32).copy(),
        gids=np.asarray(gids, dtype=np.int64).copy(), z=int(z),
        epoch=int(epoch),
    )
    return place_slab(slab, device)


def _is_bf16(a: np.ndarray) -> bool:
    return a.dtype.name == "bfloat16" or (a.dtype.kind == "V"
                                         and a.dtype.itemsize == 2)


def tree_from_numpy(tree, device="cuda"):
    """A tree of numpy arrays as tensors on ``device``, dtypes kept."""
    def one(a):
        a = np.asarray(a)
        if _is_bf16(a):
            bits = torch.from_numpy(a.view(np.int16).copy())
            return bits.view(torch.bfloat16).to(device)
        return torch.from_numpy(a.copy()).to(device)

    return tree_map(one, tree)


def tree_to_numpy(tree, bf16=None):
    """A tree of tensors as numpy arrays; bf16 leaves as uint16 bits, or
    viewed as ``bf16`` (a numpy bfloat16 dtype) when one is given.  The
    inverse of :func:`lm_params_from_numpy` and
    :func:`opt_state_from_numpy`."""
    def one(t):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            bits = t.view(torch.int16).numpy().view(np.uint16)
            return bits.view(bf16) if bf16 is not None else bits.copy()
        return t.numpy().copy()

    return tree_map(one, tree)


def _torch_dtype(a) -> torch.dtype:
    a = np.asarray(a)
    if _is_bf16(a):
        return torch.bfloat16
    return torch.from_numpy(np.zeros(0, dtype=a.dtype)).dtype


def _check_like(tree, like, where="params", dtypes=False):
    """``tree`` has the keys, list lengths and shapes of ``like`` (a meta
    init), and with ``dtypes`` its dtypes too."""
    if isinstance(like, dict):
        if not isinstance(tree, dict) or set(tree) != set(like):
            got = sorted(tree) if isinstance(tree, dict) else type(tree)
            raise ValueError(f"{where}: keys {got}, expected {sorted(like)}")
        for k in like:
            _check_like(tree[k], like[k], f"{where}/{k}", dtypes)
    elif isinstance(like, (list, tuple)):
        if not isinstance(tree, (list, tuple)) or len(tree) != len(like):
            got = len(tree) if isinstance(tree, (list, tuple)) else type(tree)
            raise ValueError(f"{where}: {got} entries, expected {len(like)}")
        for i, (t, lk) in enumerate(zip(tree, like)):
            _check_like(t, lk, f"{where}/{i}", dtypes)
    elif tuple(np.shape(tree)) != tuple(like.shape):
        raise ValueError(f"{where}: shape {tuple(np.shape(tree))}, expected "
                         f"{tuple(like.shape)}")
    elif dtypes and _torch_dtype(tree) != like.dtype:
        raise ValueError(f"{where}: dtype {np.asarray(tree).dtype}, expected "
                         f"{like.dtype}")


def lm_params_from_numpy(tree, cfg: T.LMConfig, device="cuda"):
    """The reference's ``init_lm`` tree (numpy leaves) as the port's
    parameters for ``cfg``: the same keys, shapes and dtypes (inverse:
    :func:`tree_to_numpy`)."""
    _check_like(tree, T.init_lm(0, cfg, DEFAULT_POLICY, device="meta"))
    return tree_from_numpy(tree, device)


def opt_state_from_numpy(tree, cfg: T.LMConfig, device="cuda"):
    """The reference's ``init_opt`` state (``{"m", "v", "step"}``, numpy
    leaves) for a model of ``cfg`` as the port's."""
    like = T.init_lm(0, cfg, DEFAULT_POLICY, device="meta")
    _check_like(tree["m"], like, "m")
    _check_like(tree["v"], like, "v")
    return tree_from_numpy(tree, device)


def gnn_params_from_numpy(tree, cfg: G.GNNConfig, device="cuda"):
    """The reference's ``init_gnn`` tree (numpy leaves) as the port's
    parameters for ``cfg``: the same keys, shapes and dtypes."""
    _check_like(tree, G.init_gnn(0, cfg, device="meta"), dtypes=True)
    return tree_from_numpy(tree, device)


def bst_params_from_numpy(tree, cfg: B.BSTConfig, device="cuda"):
    """The reference's ``init_bst`` tree (numpy leaves) as the port's
    parameters for ``cfg``: the same keys, shapes and dtypes."""
    _check_like(tree, B.init_bst(0, cfg, device="meta"), dtypes=True)
    return tree_from_numpy(tree, device)


def bst_sparse_opt_from_numpy(tree, device="cuda"):
    """The reference's ``init_bst_sparse_opt`` state (``{"item_acc",
    "profile_acc"}``, float32 [rows] each) as the port's, checked against
    the meta init for tables of as many rows as its accumulators."""
    def table(key):
        rows = tuple(np.shape(tree.get(key, ())))[:1] or (0,)
        return torch.empty(rows + (1,), device="meta")

    like = B.init_bst_sparse_opt({"item_table": table("item_acc"),
                                  "profile_table": table("profile_acc")})
    _check_like(tree, like, "sparse opt", dtypes=True)
    return tree_from_numpy(tree, device)
