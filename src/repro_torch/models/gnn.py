"""GNN family: GraphSAGE, GIN, MeshGraphNet, DimeNet.

Message passing is a gather (``index_select``) of node or edge rows and
a scatter-add (``index_add_``) of messages into their destinations, the
reference's ``jax.ops.segment_sum``.  Plain functions on parameter trees
with the reference's keys (``repro_torch.convert.gnn_params_from_numpy``
carries a reference tree across).

On CUDA, ``index_add_`` on floats adds in no fixed order, so two runs on
the card may differ in the last bits of each sum, and the card differs
from the CPU by rounding; the checks hold them by tolerance.

Batch layout (uniform across archs; unused fields omitted per arch):
    node_feat  [N, F] f32      (sage/gin/mgn)  — input features
    species    [N]    i32      (dimenet)       — atom types
    positions  [N, 3] f32      (dimenet/mgn)
    edge_src   [E] i32, edge_dst [E] i32       — directed half-edges
    edge_feat  [E, Fe] f32     (mgn)
    graph_idx  [N] i32         (batched molecule graphs)
    t_kj, t_ji [T] i32         (dimenet triplet edge-pair indices)
    labels     [N] i32 / [B or N, out] f32
    train_mask [N] f32
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from .common import (layer_norm, make_generator, normal_init, tree_map,
                     with_logical)

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class GNNConfig:
    name: str
    kind: str  # 'sage' | 'gin' | 'mgn' | 'dimenet'
    n_layers: int
    d_hidden: int
    in_dim: int = 128           # input feature dim (shape-dependent)
    out_dim: int = 16           # classes / regression targets
    aggregator: str = "sum"     # sage: mean; gin/mgn: sum
    # gin
    learnable_eps: bool = True
    # mgn
    edge_in_dim: int = 4
    mlp_layers: int = 2
    # dimenet
    n_bilinear: int = 8
    n_spherical: int = 7
    n_radial: int = 6
    n_species: int = 32
    cutoff: float = 5.0
    # task: 'node_class' | 'graph_reg' | 'node_reg'
    task: str = "node_class"


# ---------------------------------------------------------------------------
# segment helpers
# ---------------------------------------------------------------------------
def seg_sum(x, idx, n):
    return x.new_zeros((n,) + tuple(x.shape[1:])).index_add_(0, idx, x)


def seg_mean(x, idx, n):
    s = seg_sum(x, idx, n)
    c = seg_sum(x.new_ones((x.shape[0], 1)), idx, n)
    return s / torch.clamp_min(c, 1.0)


def _gather(x, idx):
    return x.index_select(0, idx)


def _norm(x):
    return torch.linalg.vector_norm(x, dim=-1, keepdim=True)


def _mlp_init(gen, dims, device, dt=F32):
    return [
        {
            "w": normal_init(gen, (a, b), dt, device=device),
            "b": torch.zeros((b,), dtype=dt, device=device),
        }
        for a, b in zip(dims[:-1], dims[1:])
    ]


def _mlp(x, layers, act=F.relu, final_act=False, ln=None):
    for i, l in enumerate(layers):
        x = x @ l["w"] + l["b"]
        if i < len(layers) - 1 or final_act:
            x = act(x)
    if ln is not None:
        x = layer_norm(x, ln["g"], ln["b"])
    return x


# ---------------------------------------------------------------------------
# GraphSAGE
# ---------------------------------------------------------------------------
def init_sage(gen, cfg: GNNConfig, device):
    layers = []
    d_in = cfg.in_dim
    for _ in range(cfg.n_layers):
        layers.append(
            {
                "w_self": normal_init(gen, (d_in, cfg.d_hidden), F32,
                                      device=device),
                "w_nbr": normal_init(gen, (d_in, cfg.d_hidden), F32,
                                     device=device),
                "b": torch.zeros((cfg.d_hidden,), dtype=F32, device=device),
            }
        )
        d_in = cfg.d_hidden
    return {
        "layers": layers,
        "head": _mlp_init(gen, [cfg.d_hidden, cfg.out_dim], device),
    }


def sage_fwd(params, batch, cfg: GNNConfig):
    x = batch["node_feat"]
    n = x.shape[0]
    src, dst = batch["edge_src"], batch["edge_dst"]
    for l in params["layers"]:
        x = with_logical(x, ("nodes", "feat"))
        msg = _gather(x, src)
        agg = (seg_mean(msg, dst, n) if cfg.aggregator == "mean"
               else seg_sum(msg, dst, n))
        x = F.relu(x @ l["w_self"] + agg @ l["w_nbr"] + l["b"])
        # L2 normalize (GraphSAGE Section 3.1)
        x = x / torch.clamp_min(_norm(x), 1e-6)
    return _mlp(x, params["head"])


# ---------------------------------------------------------------------------
# GIN
# ---------------------------------------------------------------------------
def init_gin(gen, cfg: GNNConfig, device):
    layers = []
    d_in = cfg.in_dim
    for _ in range(cfg.n_layers):
        layers.append(
            {
                "mlp": _mlp_init(gen, [d_in, cfg.d_hidden, cfg.d_hidden],
                                 device),
                "eps": torch.zeros((), dtype=F32, device=device),
            }
        )
        d_in = cfg.d_hidden
    return {
        "layers": layers,
        "head": _mlp_init(gen, [cfg.d_hidden, cfg.d_hidden, cfg.out_dim],
                          device),
    }


def gin_fwd(params, batch, cfg: GNNConfig):
    x = batch["node_feat"]
    n = x.shape[0]
    src, dst = batch["edge_src"], batch["edge_dst"]
    for l in params["layers"]:
        x = with_logical(x, ("nodes", "feat"))
        agg = seg_sum(_gather(x, src), dst, n)
        x = _mlp((1.0 + l["eps"]) * x + agg, l["mlp"], final_act=True)
    if cfg.task == "graph_reg" and "graph_idx" in batch:
        g = seg_sum(x, batch["graph_idx"], batch["labels"].shape[0])
        return _mlp(g, params["head"])
    return _mlp(x, params["head"])


# ---------------------------------------------------------------------------
# MeshGraphNet (encode-process-decode)
# ---------------------------------------------------------------------------
def init_mgn(gen, cfg: GNNConfig, device):
    d = cfg.d_hidden
    mlp_dims = [d] * cfg.mlp_layers + [d]

    def block(in_dim):
        return {
            "mlp": _mlp_init(gen, [in_dim] + mlp_dims, device),
            "ln": {"g": torch.ones((d,), dtype=F32, device=device),
                   "b": torch.zeros((d,), dtype=F32, device=device)},
        }

    params = {"node_enc": block(cfg.in_dim),
              "edge_enc": block(cfg.edge_in_dim),
              "proc_edge": [], "proc_node": []}
    for _ in range(cfg.n_layers):
        params["proc_edge"].append(block(3 * d))
        params["proc_node"].append(block(2 * d))
    params["decoder"] = _mlp_init(gen, [d, d, cfg.out_dim], device)
    return params


def mgn_fwd(params, batch, cfg: GNNConfig):
    n = batch["node_feat"].shape[0]
    src, dst = batch["edge_src"], batch["edge_dst"]
    h = _mlp(batch["node_feat"], params["node_enc"]["mlp"],
             ln=params["node_enc"]["ln"])
    e = _mlp(batch["edge_feat"], params["edge_enc"]["mlp"],
             ln=params["edge_enc"]["ln"])
    for pe, pn in zip(params["proc_edge"], params["proc_node"]):
        h = with_logical(h, ("nodes", "feat"))
        e = with_logical(e, ("edges", "feat"))
        e = e + _mlp(torch.cat([e, _gather(h, src), _gather(h, dst)], -1),
                     pe["mlp"], ln=pe["ln"])
        agg = seg_sum(e, dst, n)
        h = h + _mlp(torch.cat([h, agg], -1), pn["mlp"], ln=pn["ln"])
    return _mlp(h, params["decoder"])


# ---------------------------------------------------------------------------
# DimeNet (directional message passing with triplet gather)
# ---------------------------------------------------------------------------
def _rbf(d, cfg: GNNConfig):
    """Radial basis: sin(nπd/c)/d envelope-free simplification, n=1..n_radial."""
    n = torch.arange(1, cfg.n_radial + 1, dtype=F32, device=d.device)
    d = torch.clamp_min(d[:, None], 1e-6)
    return (math.sqrt(2.0 / cfg.cutoff)
            * torch.sin(n * math.pi * d / cfg.cutoff) / d)


def _sbf(angle, d, cfg: GNNConfig):
    """Spherical basis (l=0..n_spherical-1 × n_radial); cos(l·θ)·rbf — a
    compute-faithful stand-in for the Bessel/It spherical harmonics."""
    ls = torch.arange(cfg.n_spherical, dtype=F32, device=angle.device)
    ang = torch.cos(angle[:, None] * ls)  # [T, n_spherical]
    rad = _rbf(d, cfg)  # [T, n_radial]
    return (ang[:, :, None] * rad[:, None, :]).reshape(
        angle.shape[0], cfg.n_spherical * cfg.n_radial
    )


def init_dimenet(gen, cfg: GNNConfig, device):
    d = cfg.d_hidden
    nsb = cfg.n_spherical * cfg.n_radial
    params = {
        "embed": normal_init(gen, (cfg.n_species, d), F32, scale=1.0,
                             device=device),
        "edge_mlp": _mlp_init(gen, [2 * d + cfg.n_radial, d], device),
        "energy": _mlp_init(gen, [d, d, 1], device),
        "blocks": [],
    }
    for _ in range(cfg.n_layers):
        params["blocks"].append(
            {
                "w_sbf": normal_init(gen, (nsb, cfg.n_bilinear), F32,
                                     device=device),
                "bilinear": normal_init(gen, (d, cfg.n_bilinear, d), F32,
                                        scale=0.1, device=device),
                "w_kj": normal_init(gen, (d, d), F32, device=device),
                "mlp": _mlp_init(gen, [d, d, d], device),
                "out": _mlp_init(gen, [d, d], device),
            }
        )
    return params


def _bilinear(mk, bilinear, sb):
    """``einsum("td,dbe,tb->te")`` as two products: [T, d] @ [d, b·e],
    then the sum over b weighted by ``sb`` (the reference lets XLA pick
    the order; the sums agree to float32 rounding)."""
    d, nb, e = bilinear.shape
    mkb = (mk @ bilinear.reshape(d, nb * e)).reshape(-1, nb, e)
    return torch.bmm(sb[:, None, :], mkb)[:, 0]


def dimenet_fwd(params, batch, cfg: GNNConfig):
    """Returns per-graph energy [B] (graph_idx) or total scalar."""
    src, dst = batch["edge_src"], batch["edge_dst"]
    pos = batch["positions"]
    z = _gather(params["embed"], batch["species"])
    vec = _gather(pos, dst) - _gather(pos, src)
    dist = _norm(vec)[:, 0]
    rbf = _rbf(dist, cfg)
    m = _mlp(
        torch.cat([_gather(z, src), _gather(z, dst), rbf], -1),
        params["edge_mlp"], final_act=True,
    )  # [E, d] directed edge messages
    # triplets: edge kj feeds edge ji; angle between them
    t_kj, t_ji = batch["t_kj"], batch["t_ji"]
    v1 = -_gather(vec, t_kj)
    v2 = _gather(vec, t_ji)
    cosang = torch.sum(v1 * v2, -1) / torch.clamp_min(
        _norm(v1)[:, 0] * _norm(v2)[:, 0], 1e-6
    )
    angle = torch.arccos(torch.clamp(cosang, -1 + 1e-6, 1 - 1e-6))
    sbf = _sbf(angle, _gather(dist, t_kj), cfg)  # [T, nsb]
    E = m.shape[0]
    per_atom = pos.new_zeros((pos.shape[0], cfg.d_hidden))
    for blk in params["blocks"]:
        m = with_logical(m, ("edges", "feat"))
        mk = _gather(m, t_kj) @ blk["w_kj"]  # [T, d]
        sb = sbf @ blk["w_sbf"]  # [T, n_bilinear]
        inter = _bilinear(mk, blk["bilinear"], sb)
        agg = seg_sum(inter, t_ji, E)
        m = m + _mlp(m + agg, blk["mlp"], final_act=True)
        per_atom = per_atom + seg_sum(_mlp(m, blk["out"]), dst, pos.shape[0])
    e_atom = _mlp(per_atom, params["energy"])[:, 0]  # [N]
    if "graph_idx" in batch:
        return seg_sum(e_atom, batch["graph_idx"], batch["labels"].shape[0])
    return torch.sum(e_atom, dim=0, keepdim=True)


# ---------------------------------------------------------------------------
# uniform entry points
# ---------------------------------------------------------------------------
_INIT = {"sage": init_sage, "gin": init_gin, "mgn": init_mgn,
         "dimenet": init_dimenet}
_FWD = {"sage": sage_fwd, "gin": gin_fwd, "mgn": mgn_fwd,
        "dimenet": dimenet_fwd}


def init_gnn(gen, cfg: GNNConfig, device="cuda"):
    """The parameter tree, drawn from ``gen`` (a ``torch.Generator`` on
    ``device`` or an int seed).  ``device="meta"`` gives the shapes and
    dtypes only and allocates nothing."""
    return _INIT[cfg.kind](make_generator(gen, device), cfg, device)


def gnn_fwd(params, batch, cfg: GNNConfig):
    return _FWD[cfg.kind](params, batch, cfg)


def gnn_loss(params, batch, cfg: GNNConfig):
    out = gnn_fwd(params, batch, cfg)
    if cfg.task == "node_class":
        logp = F.log_softmax(out.float(), dim=-1)
        nll = -logp.gather(-1, batch["labels"].long()[:, None])[:, 0]
        mask = batch.get("train_mask")
        mask = torch.ones_like(nll) if mask is None else mask
        loss = torch.sum(nll * mask) / torch.clamp_min(torch.sum(mask), 1.0)
    elif cfg.task == "node_reg":
        err = (out - batch["labels"]) ** 2
        mask = batch.get("train_mask")
        mask = err.new_ones(err.shape[0]) if mask is None else mask
        loss = torch.sum(err * mask[:, None]) / torch.clamp_min(
            torch.sum(mask) * err.shape[-1], 1.0
        )
    else:  # graph_reg
        loss = torch.mean((out - batch["labels"]) ** 2)
    return loss, {"loss": loss}


def gnn_axes(params):
    """All GNN params are small: replicate (FSDP unnecessary)."""
    return tree_map(lambda _: (), params)
