"""BST — Behavior Sequence Transformer (Alibaba, arXiv:1905.06874).

Huge sparse embedding tables → transformer over the user's behavior
sequence (+ target item) → MLP → CTR logit.

The embedding lookup is the hot path: a row gather (:func:`take_rows`)
and a scatter-add of each bag's rows (``index_add_``), the reference's
``jnp.take`` + ``jax.ops.segment_sum``.  Plain functions on a parameter
tree with the reference's keys.

Out-of-range ids follow ``jnp.take``'s default mode: an id in
``[-rows, 0)`` counts from the end, any other id outside the table gives
a row of NaN (its example's logit is NaN) and no gradient.  The gather
clamps the index and masks the row, so no id reads or writes past a
table; ``ClickStream`` clips every id, so no served batch has one.

`retrieval_cand` scores one user against 10^6 candidates as a single
batched dot — user tower runs once, candidates come straight from the
item table.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.train.optim import adamw_update

from .common import (layer_norm, make_generator, normal_init, tree_leaves,
                     tree_map, with_logical)

F32 = torch.float32
_TABLES = ("item_table", "profile_table")


@dataclasses.dataclass(frozen=True)
class BSTConfig:
    name: str = "bst"
    embed_dim: int = 32
    seq_len: int = 20
    n_blocks: int = 1
    n_heads: int = 8
    mlp: tuple = (1024, 512, 256)
    n_items: int = 10_000_000
    n_profile: int = 1_000_000     # user-profile categorical vocab
    bag_nnz_per_row: int = 32      # padded multi-hot ids per example
    n_dense: int = 16              # dense "other features"
    d_ff: int = 128                # transformer ffn
    compute_dtype: str = "f32"     # "bf16": §Perf H-B3 activation dtype

    def param_count(self) -> int:
        d = self.embed_dim
        tr = self.n_blocks * (4 * d * d + 2 * d * self.d_ff + 4 * d)
        mlp_in = (self.seq_len + 1) * d + d + self.n_dense
        dims = (mlp_in,) + self.mlp + (1,)
        mlp = sum(a * b + b for a, b in zip(dims[:-1], dims[1:]))
        return int(
            self.n_items * d
            + self.n_profile * d
            + (self.seq_len + 1) * d
            + tr
            + mlp
        )


def init_bst(gen, cfg: BSTConfig, device="cuda"):
    """The parameter tree, drawn from ``gen`` (a ``torch.Generator`` on
    ``device`` or an int seed).  ``device="meta"`` gives the shapes and
    dtypes only and allocates nothing."""
    gen = make_generator(gen, device)
    d = cfg.embed_dim

    def normal(shape, scale=None):
        return normal_init(gen, shape, F32, scale=scale, device=device)

    def ln():
        return {"g": torch.ones((d,), dtype=F32, device=device),
                "b": torch.zeros((d,), dtype=F32, device=device)}

    params = {
        "item_table": normal((cfg.n_items, d), 0.05),
        "profile_table": normal((cfg.n_profile, d), 0.05),
        "pos_embed": normal((cfg.seq_len + 1, d), 0.05),
        "blocks": [],
    }
    for _ in range(cfg.n_blocks):
        params["blocks"].append(
            {
                "wq": normal((d, d)),
                "wk": normal((d, d)),
                "wv": normal((d, d)),
                "wo": normal((d, d)),
                "ln1": ln(),
                "w1": normal((d, cfg.d_ff)),
                "w2": normal((cfg.d_ff, d)),
                "ln2": ln(),
            }
        )
    mlp_in = (cfg.seq_len + 1) * d + d + cfg.n_dense
    dims = (mlp_in,) + cfg.mlp + (1,)
    params["mlp"] = [
        {"w": normal((a, b)), "b": torch.zeros((b,), dtype=F32, device=device)}
        for a, b in zip(dims[:-1], dims[1:])
    ]
    return params


def bst_axes(params):
    """Embedding tables row-sharded over 'model'; the rest replicated."""
    axes = tree_map(lambda _: (), params)
    axes["item_table"] = ("rows", "feat")
    axes["profile_table"] = ("rows", "feat")
    return axes


# ---------------------------------------------------------------------------
# ids → rows, with jnp.take's and .at[].add's out-of-range behaviour
# ---------------------------------------------------------------------------
def _index(ids, n):
    """(in-range index into n rows, whether the id was in range): an id in
    [-n, 0) counts from the end; the index of any other id is clamped."""
    ok = (ids >= -n) & (ids < n)
    return torch.where(ids < 0, ids + n, ids).clamp(0, n - 1), ok


def take_rows(table, ids):
    """``jnp.take(table, ids, axis=0)`` (mode "fill"): rows of ``table``
    for ``ids`` of any shape, NaN rows for out-of-range ids."""
    idx, ok = _index(ids.reshape(-1), table.shape[0])
    rows = table.index_select(0, idx)
    rows = torch.where(ok[:, None], rows, rows.new_full((), float("nan")))
    return rows.reshape(tuple(ids.shape) + (table.shape[1],))


def _scatter_add(x, ids, vals):
    """``x.at[ids].add(vals)`` as a new tensor: duplicate ids add once per
    occurrence, out-of-range ids are dropped."""
    idx, ok = _index(ids, x.shape[0])
    mask = ok.reshape((-1,) + (1,) * (vals.dim() - 1))
    return x.index_add(0, idx, torch.where(mask, vals, vals.new_zeros(())))


def embedding_bag(table, ids, segments, n_rows, combiner="sum"):
    """EmbeddingBag: a row gather + a segment sum.

    ids [NNZ] int32 (0 = padding), segments [NNZ] int32 row ids.
    """
    emb = take_rows(table, ids)
    emb = emb * (ids > 0)[:, None]  # padding id contributes 0
    out = emb.new_zeros((n_rows, emb.shape[1])).index_add_(0, segments, emb)
    if combiner == "mean":
        cnt = emb.new_zeros((n_rows,)).index_add_(
            0, segments, (ids > 0).to(emb.dtype))
        out = out / torch.clamp_min(cnt, 1.0)[:, None]
    return out


def _cdt(cfg):
    return torch.bfloat16 if cfg.compute_dtype == "bf16" else F32


def _cast_net(p, cfg):
    dt = _cdt(cfg)
    return tree_map(lambda a: a.to(dt) if a.dtype == F32 else a, p)


def _transformer_block(x, p, cfg: BSTConfig):
    B, S, d = x.shape
    h = cfg.n_heads
    hd = d // h
    q = (x @ p["wq"]).reshape(B, S, h, hd)
    k = (x @ p["wk"]).reshape(B, S, h, hd)
    v = (x @ p["wv"]).reshape(B, S, h, hd)
    # the reference divides by np.sqrt(hd), a float64 numpy scalar, which
    # JAX does not take as weakly typed: bf16 scores are promoted to
    # float32 before the division
    s = torch.einsum("bshd,bthd->bhst", q, k).float() / math.sqrt(hd)
    a = torch.softmax(s, dim=-1).to(x.dtype)
    o = torch.einsum("bhst,bthd->bshd", a, v).reshape(B, S, d)
    x = layer_norm(x + o @ p["wo"], p["ln1"]["g"], p["ln1"]["b"])
    f = F.relu(x @ p["w1"]) @ p["w2"]
    return layer_norm(x + f, p["ln2"]["g"], p["ln2"]["b"])


def _mlp_head(h, layers):
    for i, l in enumerate(layers):
        h = h @ l["w"] + l["b"]
        if i < len(layers) - 1:
            h = F.leaky_relu(h)
    return h[:, 0]


def _seq_ids(batch):
    return torch.cat([batch["hist"], batch["target"][:, None]], dim=1)


def bst_logits(params, batch, cfg: BSTConfig):
    """batch: hist [B,seq_len] i32, target [B] i32, bag_ids/bag_seg [B*nnz],
    dense [B,n_dense] → CTR logits [B]."""
    B = batch["hist"].shape[0]
    x = take_rows(params["item_table"], _seq_ids(batch))  # [B, S+1, d]
    x = x + params["pos_embed"][None, :, :]
    x = with_logical(x, ("batch", "seq", "feat"))
    for p in params["blocks"]:
        x = _transformer_block(x, p, cfg)
    seq_flat = x.reshape(B, -1)
    prof = embedding_bag(
        params["profile_table"], batch["bag_ids"], batch["bag_seg"], B
    )
    feat = torch.cat([seq_flat, prof, batch["dense"]], dim=-1)
    feat = with_logical(feat, ("batch", "feat"))
    return _mlp_head(feat, params["mlp"])


def _bce(logits, labels):
    y = labels.float()
    return torch.mean(
        torch.clamp_min(logits, 0) - logits * y
        + torch.log1p(torch.exp(-torch.abs(logits)))
    )


def bst_loss(params, batch, cfg: BSTConfig):
    loss = _bce(bst_logits(params, batch, cfg), batch["labels"])
    return loss, {"loss": loss}


def bst_serve(params, batch, cfg: BSTConfig):
    """Online inference: CTR probabilities [B]."""
    return torch.sigmoid(bst_logits(params, batch, cfg))


# ---------------------------------------------------------------------------
# §Perf H-B1: sparse-table training step
# ---------------------------------------------------------------------------
# The dense AdamW update streams p/m/v over the full 10^7-row tables every
# step, although a batch touches ≤ B·(seq+1+nnz) rows.  The sparse step
# (industry-standard TBE/rowwise-Adagrad) differentiates w.r.t. the
# GATHERED rows and scatter-updates only those, with a rowwise Adagrad
# accumulator ([rows] instead of m/v [rows, dim]).
def dense_params(params):
    """The parameters that AdamW updates in the sparse step: all but the
    two embedding tables."""
    return {k: v for k, v in params.items() if k not in _TABLES}


def init_bst_sparse_opt(params):
    def zeros(t):
        return torch.zeros((t.shape[0],), dtype=F32, device=t.device)

    return {"item_acc": zeros(params["item_table"]),
            "profile_acc": zeros(params["profile_table"])}


def _bst_logits_from_gathered(net, seq_emb, prof_sum, batch, cfg: BSTConfig):
    B = seq_emb.shape[0]
    dt = _cdt(cfg)
    net = _cast_net(net, cfg)
    x = seq_emb.to(dt) + net["pos_embed"][None, :, :]
    x = with_logical(x, ("batch", "seq", "feat"))
    for p in net["blocks"]:
        x = _transformer_block(x, p, cfg)
    feat = torch.cat(
        [x.reshape(B, -1), prof_sum.to(dt), batch["dense"].to(dt)], dim=-1
    )
    return _mlp_head(feat, net["mlp"]).float()


def bst_sparse_train_step(params, table_opt, net_opt, batch, cfg: BSTConfig,
                          opt_cfg, lr_table: float = 0.05):
    """(params, table_opt, net_opt, batch) → updated state + metrics, all
    new tensors; rows of a table that the batch does not touch are copied
    bit for bit."""
    B = batch["hist"].shape[0]
    seq_ids = _seq_ids(batch)  # [B, S+1]
    bag_ids = batch["bag_ids"]
    net = tree_map(torch.Tensor.detach, dense_params(params))
    net_p = tree_map(lambda p: p.detach().requires_grad_(), net)
    seq_emb = take_rows(params["item_table"].detach(), seq_ids)
    prof_emb = take_rows(params["profile_table"].detach(), bag_ids)
    seq_emb.requires_grad_()
    prof_emb.requires_grad_()
    leaves = tree_leaves(net_p)
    with torch.enable_grad():
        masked = prof_emb * (bag_ids > 0)[:, None]
        prof_sum = masked.new_zeros((B, masked.shape[1])).index_add_(
            0, batch["bag_seg"], masked)
        logits = _bst_logits_from_gathered(net_p, seq_emb, prof_sum, batch,
                                           cfg)
        loss = _bce(logits, batch["labels"])
        grads = torch.autograd.grad(loss, leaves + [seq_emb, prof_emb],
                                    allow_unused=True)
    by_leaf = {id(p): g for p, g in zip(leaves, grads)}
    g_net = tree_map(lambda p: by_leaf[id(p)] if by_leaf[id(p)] is not None
                     else torch.zeros_like(p), net_p)
    g_seq, g_prof = grads[-2], grads[-1]

    # dense params: AdamW as usual
    new_net, new_net_opt, opt_metrics = adamw_update(g_net, net_opt, net,
                                                     opt_cfg)

    # tables: rowwise Adagrad on touched rows only
    @torch.no_grad()
    def sparse_update(table, acc, ids_flat, g_flat):
        row_g2 = torch.mean(torch.square(g_flat), dim=-1)  # [nnz]
        acc = _scatter_add(acc, ids_flat, row_g2)
        idx, _ = _index(ids_flat, acc.shape[0])
        scale = lr_table * torch.rsqrt(acc.index_select(0, idx) + 1e-8)
        table = _scatter_add(table, ids_flat, -scale[:, None] * g_flat)
        return table, acc

    item_t, item_a = sparse_update(
        params["item_table"], table_opt["item_acc"],
        seq_ids.reshape(-1), g_seq.reshape(-1, cfg.embed_dim),
    )
    prof_t, prof_a = sparse_update(
        params["profile_table"], table_opt["profile_acc"], bag_ids, g_prof,
    )
    new_params = dict(new_net, item_table=item_t, profile_table=prof_t)
    new_table_opt = {"item_acc": item_a, "profile_acc": prof_a}
    metrics = {"loss": loss.detach(), **opt_metrics}
    return new_params, new_table_opt, new_net_opt, metrics


def bst_retrieval(params, batch, cfg: BSTConfig):
    """Score one user against `n_candidates` items: ONE batched dot.

    batch: hist [1, seq_len], bag_ids/bag_seg, dense [1,n_dense],
    candidates [C] i32 → scores [C]."""
    hist = batch["hist"]
    x = take_rows(params["item_table"], hist)
    x = x + params["pos_embed"][None, : hist.shape[1], :]
    for p in params["blocks"]:
        x = _transformer_block(x, p, cfg)
    user = torch.mean(x, dim=1)  # [1, d] pooled user tower
    prof = embedding_bag(
        params["profile_table"], batch["bag_ids"], batch["bag_seg"], 1
    )
    user = user + prof  # cheap feature fusion for the retrieval tower
    cand = take_rows(params["item_table"], batch["candidates"])  # [C, d]
    cand = with_logical(cand, ("candidates", "feat"))
    return (cand @ user[0]).float()  # [C]
