"""Decoder-only LM family covering the five assigned architectures.

One config-driven implementation provides:
  * GQA attention with RoPE (starcoder2 / deepseek-coder / gemma3 / moonshot)
  * sliding-window and periodic local:global attention (starcoder2, gemma3)
  * MLA — multi-head latent attention with compressed KV cache and
    weight-absorbed decode (deepseek-v3)
  * MoE with shared experts + sort-based capacity-bucketed dispatch
    (deepseek-v3: 256e top-8 + 1 shared; moonshot: 64e top-6 + 2 shared)
  * MTP — one-depth multi-token-prediction head (deepseek-v3)
  * chunked attention over query chunks for long sequences
  * chunked cross entropy (never materializes [B,S,V] logits at once)

Plain functions on a parameter tree with the reference's keys, layers
stacked on a leading [L, ...] axis.  The numerics follow the reference
step by step: bf16 weights and activations (``_cast_layer`` rounds every
float32 layer leaf to bf16, the MoE router included), rope and the norms
in float32, attention scores taken from the bf16 product and scaled,
masked (-1e30) and softmaxed in float32, the probabilities cast back to
bf16.  Attention is written out; no attention library and no compiler.

The reference's ``lax.scan``/``lax.cond`` over layers is a Python loop
here, ``jax.checkpoint`` is ``torch.utils.checkpoint`` (only while
gradients are taken and ``cfg.remat`` is set), and the decode step
writes the new token's keys and values into the cache in place and
returns that cache (the reference returns a new one).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import TensorSpec

from .common import (DTypePolicy, gelu, make_generator, normal_init,
                     rms_norm, tree_map)

BF16 = torch.bfloat16
MASK_VALUE = -1e30  # masked scores (float32); -inf would NaN fully masked rows


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0
    capacity_factor: float = 1.25
    router: str = "softmax"  # "softmax" (switch-style) | "sigmoid" (dsv3)
    aux_loss_coef: float = 0.01


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int | None = None
    rope_theta: float = 10_000.0
    # attention pattern: window size per layer; None = full causal.
    # `global_every` = k means layers (i+1) % k == 0 are full/global
    # (gemma3's 5:1 local:global), others use `window`.
    window: int | None = None
    global_every: int | None = None
    # MoE: first `n_dense_layers` layers stay dense, rest are MoE
    moe: MoEConfig | None = None
    n_dense_layers: int = 0
    mla: MLAConfig | None = None
    mtp_depth: int = 0
    tie_embeddings: bool = False
    gated_mlp: bool = True   # llama-style silu-gated; starcoder2 uses plain GELU
    norm_eps: float = 1e-6
    # execution knobs (not architecture)
    q_chunk: int = 512
    loss_chunk: int = 512
    remat: bool = True
    # the reference's scan-or-unroll switch; the port always loops
    unroll_layers: bool = False
    # grouped-query attention without repeating KV to the query heads
    gqa_grouped: bool = False

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def n_scan_layers(self) -> int:
        return self.n_layers - self.n_dense_layers

    def layer_is_global(self) -> np.ndarray:
        """bool[n_layers]: full-attention layer mask.  Without a
        local:global pattern, all layers are windowed iff `window` is set
        (starcoder2) and full otherwise."""
        if self.global_every is None:
            return np.full(self.n_layers, self.window is None)
        idx = np.arange(self.n_layers)
        return (idx + 1) % self.global_every == 0

    def param_count(self) -> int:
        """Analytic parameter count."""
        D, F, V, H, KH = self.d_model, self.d_ff, self.vocab, self.n_heads, self.n_kv_heads
        hd = self.hd
        if self.mla is not None:
            m = self.mla
            attn = (
                D * m.q_lora_rank
                + m.q_lora_rank * H * (m.qk_nope_head_dim + m.qk_rope_head_dim)
                + D * (m.kv_lora_rank + m.qk_rope_head_dim)
                + m.kv_lora_rank * H * (m.qk_nope_head_dim + m.v_head_dim)
                + H * m.v_head_dim * D
                + m.q_lora_rank + m.kv_lora_rank
            )
        else:
            attn = D * H * hd + 2 * D * KH * hd + H * hd * D
        dense_ffn = (3 if self.gated_mlp else 2) * D * F
        per_dense = attn + dense_ffn + 2 * D
        total = self.n_dense_layers * per_dense if self.n_dense_layers else 0
        if self.moe is not None:
            e = self.moe
            moe_ffn = (
                3 * D * e.d_ff_expert * e.n_experts
                + e.n_shared * 3 * D * e.d_ff_expert
                + D * e.n_experts
            )
            total += self.n_scan_layers * (attn + moe_ffn + 2 * D)
        else:
            total += self.n_scan_layers * per_dense
        total += V * D  # embed
        if not self.tie_embeddings:
            total += V * D
        total += D  # final norm
        if self.mtp_depth:
            total += 2 * D * D + per_dense + D
        return int(total)

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k + shared experts only)."""
        if self.moe is None:
            return self.param_count()
        e = self.moe
        full_moe = 3 * self.d_model * e.d_ff_expert * e.n_experts
        active_moe = 3 * self.d_model * e.d_ff_expert * e.top_k
        return int(
            self.param_count() - self.n_scan_layers * (full_moe - active_moe)
        )


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def _attn_init(gen, cfg: LMConfig, dt, device):
    D, H, KH, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd

    def w(shape):
        return normal_init(gen, shape, dt, device=device)

    if cfg.mla is not None:
        m = cfg.mla
        qk_dim = m.qk_nope_head_dim + m.qk_rope_head_dim
        return {
            "wq_a": w((D, m.q_lora_rank)),
            "q_norm": torch.zeros((m.q_lora_rank,), dtype=dt, device=device),
            "wq_b": w((m.q_lora_rank, H, qk_dim)),
            "wkv_a": w((D, m.kv_lora_rank + m.qk_rope_head_dim)),
            "kv_norm": torch.zeros((m.kv_lora_rank,), dtype=dt, device=device),
            "wkv_b": w((m.kv_lora_rank, H, m.qk_nope_head_dim + m.v_head_dim)),
            "wo": w((H, m.v_head_dim, D)),
        }
    return {
        "wq": w((D, H, hd)),
        "wk": w((D, KH, hd)),
        "wv": w((D, KH, hd)),
        "wo": w((H, hd, D)),
    }


def _attn_axes(cfg: LMConfig):
    if cfg.mla is not None:
        return {
            "wq_a": ("embed", "q_lora"),
            "q_norm": ("q_lora",),
            "wq_b": ("q_lora", "heads", "head_dim"),
            "wkv_a": ("embed", "kv_lora"),
            "kv_norm": ("kv_lora",),
            "wkv_b": ("kv_lora", "heads", "head_dim"),
            "wo": ("heads", "head_dim", "embed"),
        }
    return {
        "wq": ("embed", "heads", "head_dim"),
        "wk": ("embed", "kv_heads", "head_dim"),
        "wv": ("embed", "kv_heads", "head_dim"),
        "wo": ("heads", "head_dim", "embed"),
    }


def _dense_ffn_init(gen, cfg: LMConfig, dt, device):
    D, F_ = cfg.d_model, cfg.d_ff
    p = {
        "w1": normal_init(gen, (D, F_), dt, device=device),
        "w2": normal_init(gen, (F_, D), dt, device=device),
    }
    if cfg.gated_mlp:
        p["w3"] = normal_init(gen, (D, F_), dt, device=device)
    return p


def _dense_ffn_axes(cfg):
    a = {"w1": ("embed", "mlp"), "w2": ("mlp", "embed")}
    if cfg.gated_mlp:
        a["w3"] = ("embed", "mlp")
    return a


def _moe_init(gen, cfg: LMConfig, dt, device):
    D = cfg.d_model
    e = cfg.moe

    def w(shape, dtype=dt):
        return normal_init(gen, shape, dtype, device=device)

    p = {
        "router": w((D, e.n_experts), torch.float32),
        "w1": w((e.n_experts, D, e.d_ff_expert)),
        "w3": w((e.n_experts, D, e.d_ff_expert)),
        "w2": w((e.n_experts, e.d_ff_expert, D)),
    }
    if e.n_shared:
        fs = e.d_ff_expert * e.n_shared
        p["shared_w1"] = w((D, fs))
        p["shared_w3"] = w((D, fs))
        p["shared_w2"] = w((fs, D))
    return p


def _moe_axes(cfg: LMConfig):
    a = {
        "router": ("embed", "experts_router"),
        "w1": ("experts", "embed", "expert_mlp"),
        "w3": ("experts", "embed", "expert_mlp"),
        "w2": ("experts", "expert_mlp", "embed"),
    }
    if cfg.moe.n_shared:
        a["shared_w1"] = ("embed", "mlp")
        a["shared_w3"] = ("embed", "mlp")
        a["shared_w2"] = ("mlp", "embed")
    return a


def _layer_init(gen, cfg: LMConfig, moe: bool, dt, device):
    return {
        "ln1": torch.zeros((cfg.d_model,), dtype=dt, device=device),
        "attn": _attn_init(gen, cfg, dt, device),
        "ln2": torch.zeros((cfg.d_model,), dtype=dt, device=device),
        "ffn": (_moe_init if moe else _dense_ffn_init)(gen, cfg, dt, device),
    }


def _layer_axes(cfg: LMConfig, moe: bool):
    return {
        "ln1": ("embed_norm",),
        "attn": _attn_axes(cfg),
        "ln2": ("embed_norm",),
        "ffn": _moe_axes(cfg) if moe else _dense_ffn_axes(cfg),
    }


def _stacked(make_layer, n: int):
    """``n`` layers from ``make_layer()`` stacked on a leading axis, built
    one layer at a time into the stack (peak: the stack plus one layer)."""
    first = make_layer()
    out = tree_map(lambda a: a.new_empty((n,) + tuple(a.shape)), first)
    for i in range(n):
        layer = first if i == 0 else make_layer()
        tree_map(lambda o, a: o[i].copy_(a), out, layer)
    return out


def init_lm(gen, cfg: LMConfig, policy: DTypePolicy, device="cuda"):
    """The parameter tree, drawn from ``gen`` (a ``torch.Generator`` on
    ``device`` or an int seed).  ``device="meta"`` gives the shapes and
    dtypes only and allocates nothing."""
    gen = make_generator(gen, device)
    dt = policy.param
    has_moe = cfg.moe is not None
    params: dict[str, Any] = {
        "embed": normal_init(gen, (cfg.vocab, cfg.d_model), dt, scale=0.02,
                             device=device),
        "final_norm": torch.zeros((cfg.d_model,), dtype=dt, device=device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = normal_init(gen, (cfg.d_model, cfg.vocab), dt,
                                        device=device)
    if cfg.n_dense_layers:
        params["dense_layers"] = _stacked(
            lambda: _layer_init(gen, cfg, False, dt, device),
            cfg.n_dense_layers)
    params["layers"] = _stacked(
        lambda: _layer_init(gen, cfg, has_moe, dt, device), cfg.n_scan_layers)
    if cfg.mtp_depth:
        params["mtp"] = {
            "proj": normal_init(gen, (2 * cfg.d_model, cfg.d_model), dt,
                                device=device),
            "layer": _layer_init(gen, cfg, False, dt, device),
            "norm": torch.zeros((cfg.d_model,), dtype=dt, device=device),
        }
    return params


def lm_axes(cfg: LMConfig):
    has_moe = cfg.moe is not None

    def stack(t):
        if isinstance(t, dict):
            return {k: stack(v) for k, v in t.items()}
        return ("layers",) + t

    axes: dict[str, Any] = {
        "embed": ("vocab_tbl", "embed_tbl"),
        "final_norm": ("embed_norm",),
        "layers": stack(_layer_axes(cfg, has_moe)),
    }
    if not cfg.tie_embeddings:
        axes["lm_head"] = ("embed", "vocab")
    if cfg.n_dense_layers:
        axes["dense_layers"] = stack(_layer_axes(cfg, False))
    if cfg.mtp_depth:
        axes["mtp"] = {
            "proj": ("embed", "embed_proj"),
            "layer": _layer_axes(cfg, False),
            "norm": ("embed_norm",),
        }
    return axes


# ---------------------------------------------------------------------------
# rope
# ---------------------------------------------------------------------------
def rope(x, positions, theta: float):
    """x: [..., S, H, hd]; positions: [..., S]."""
    hd = x.shape[-1]
    freqs = 1.0 / (theta ** (
        torch.arange(0, hd, 2, dtype=torch.float32, device=x.device) / hd))
    ang = positions[..., :, None].float() * freqs  # [..., S, hd/2]
    cos = torch.cos(ang)[..., :, None, :]
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention (over query chunks: memory flat in the sequence length)
# ---------------------------------------------------------------------------
def chunked_attention(q, k, v, q_pos, kv_pos, *, window, scale, q_chunk):
    """Grouped-query attention, one query chunk at a time.

    q: [B,S,KH,G,dq] — G query heads per KV head; k: [B,T,KH,dq];
    v: [B,T,KH,dv]; `window=None` → causal.  Query rows are independent,
    so the last chunk is simply shorter (the reference pads it with rows
    at position -1 and drops them).
    """
    B, S, KH, G, _ = q.shape
    C = min(q_chunk, S)
    outs = []
    for c0 in range(0, S, C):
        qi, pi = q[:, c0:c0 + C], q_pos[c0:c0 + C]
        s = torch.einsum("bckgd,btkd->bckgt", qi, k).float() * scale
        rel = pi[None, :, None, None, None] - kv_pos[None, None, None, None, :]
        mask = rel >= 0
        if window is not None:
            mask &= rel < window
        s = torch.where(mask, s, MASK_VALUE)
        p = torch.softmax(s, dim=-1).to(v.dtype)
        outs.append(torch.einsum("bckgt,btkd->bckgd", p, v))
    out = torch.cat(outs, dim=1)  # [B,S,KH,G,dv]
    return out.reshape(B, S, KH * G, v.shape[-1])


def gqa_attention(x, p, cfg: LMConfig, *, window, positions):
    """Training/prefill GQA attention; returns [B,S,D]."""
    B, S, _ = x.shape
    H, KH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    G = H // KH
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    if cfg.gqa_grouped:
        q = q.reshape(B, S, KH, G, hd)
    else:  # repeat KV onto the query-head axis
        k = k.repeat_interleave(G, dim=2)
        v = v.repeat_interleave(G, dim=2)
        q = q[:, :, :, None, :]  # G folded into the head axis
    o = chunked_attention(
        q, k, v, positions, positions,
        window=window, scale=1.0 / np.sqrt(hd), q_chunk=cfg.q_chunk,
    )
    return torch.einsum("bshk,hkd->bsd", o, p["wo"])


def mla_attention(x, p, cfg: LMConfig, *, window, positions):
    """Training/prefill MLA attention (expanded form); returns [B,S,D]."""
    m = cfg.mla
    B, S, _ = x.shape
    H = cfg.n_heads
    nope = m.qk_nope_head_dim
    cq = rms_norm(torch.einsum("bsd,dr->bsr", x, p["wq_a"]), p["q_norm"])
    q = torch.einsum("bsr,rhk->bshk", cq, p["wq_b"])
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    q_rope = rope(q_rope, positions, cfg.rope_theta)

    ckv_rope = torch.einsum("bsd,dr->bsr", x, p["wkv_a"])
    ckv, k_rope = ckv_rope[..., :m.kv_lora_rank], ckv_rope[..., m.kv_lora_rank:]
    ckv = rms_norm(ckv, p["kv_norm"])
    k_rope = rope(k_rope[:, :, None, :], positions, cfg.rope_theta)  # 1 head
    kv = torch.einsum("bsr,rhk->bshk", ckv, p["wkv_b"])
    k_nope, v = kv[..., :nope], kv[..., nope:]
    k = torch.cat(
        [k_nope, k_rope.expand(B, S, H, m.qk_rope_head_dim)], dim=-1)
    q_full = torch.cat([q_nope, q_rope], dim=-1)
    scale = 1.0 / np.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim)
    o = chunked_attention(
        q_full[:, :, :, None, :], k, v, positions, positions,
        window=window, scale=scale, q_chunk=cfg.q_chunk,
    )
    return torch.einsum("bshk,hkd->bsd", o, p["wo"])


# ---------------------------------------------------------------------------
# FFN / MoE
# ---------------------------------------------------------------------------
def dense_ffn(x, p):
    if "w3" in p:  # gated (llama-style)
        h = F.silu(x @ p["w1"]) * (x @ p["w3"])
    else:          # plain GELU MLP (starcoder2/gpt-style)
        h = gelu(x @ p["w1"])
    return h @ p["w2"]


def moe_ffn(x, p, cfg: LMConfig):
    """Sort-based capacity-bucketed top-k MoE.  x: [B,S,D] → ([B,S,D], aux).

    The router runs in float32 on the bf16-rounded weights (``_cast_layer``
    rounds them, as the reference's does).  Top-k ties are broken by
    ``torch.topk`` (the reference's ``lax.top_k`` takes the lower expert;
    random float routers make ties rare)."""
    e = cfg.moe
    B, S, D = x.shape
    T = B * S
    E, k_ = e.n_experts, e.top_k
    xt = x.reshape(T, D)
    logits = xt.float() @ p["router"].float()
    if e.router == "sigmoid":  # deepseek-v3: sigmoid scores, normalized top-k
        scores = torch.sigmoid(logits)
        gate_w, gate_i = torch.topk(scores, k_, dim=-1)
        gate_w = gate_w / (gate_w.sum(-1, keepdim=True) + 1e-20)
        probs = scores / (scores.sum(-1, keepdim=True) + 1e-20)
    else:
        probs = torch.softmax(logits, dim=-1)
        gate_w, gate_i = torch.topk(probs, k_, dim=-1)
        gate_w = gate_w / (gate_w.sum(-1, keepdim=True) + 1e-20)
    # aux load-balance loss (Switch): E * Σ_e f_e · P_e
    me = probs.mean(0)
    ce = F.one_hot(gate_i, E).sum(1).float().mean(0)
    aux = E * torch.sum(me * ce) * e.aux_loss_coef

    C = max(int(np.ceil(T * k_ * e.capacity_factor / E)), 1)
    # flatten (token, slot) assignments and sort by expert
    flat_e = gate_i.reshape(-1)  # [T*k]
    flat_t = torch.arange(T, device=x.device).repeat_interleave(k_)
    flat_w = gate_w.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    se, st, sw = flat_e[order], flat_t[order], flat_w[order]
    # position of each assignment within its expert
    seg_start = torch.searchsorted(se, torch.arange(E, device=x.device))
    pos = torch.arange(T * k_, device=x.device) - seg_start[se]
    keep = pos < C
    slot = se * C + torch.where(keep, pos, 0)
    # gather tokens into [E*C, D] buffers (dropped tokens add 0 to the last)
    buf = torch.zeros((E * C, D), dtype=xt.dtype, device=x.device)
    buf.index_add_(0, torch.where(keep, slot, E * C - 1),
                   torch.where(keep[:, None], xt[st], 0))
    buf = buf.reshape(E, C, D)
    h = F.silu(torch.einsum("ecd,edf->ecf", buf, p["w1"])) * torch.einsum(
        "ecd,edf->ecf", buf, p["w3"])
    out_e = torch.einsum("ecf,efd->ecd", h, p["w2"]).reshape(E * C, D)
    # combine: the reference scatter-adds these into zeros in the sorted
    # (expert-major) order; adding each token's k contributions in that
    # order gives its bf16 roundings on any device (CUDA's index_add_
    # fixes no order)
    contrib = torch.where(keep[:, None],
                          out_e[slot] * sw[:, None].to(out_e.dtype), 0)
    per_tok = contrib[torch.argsort(st, stable=True)].reshape(T, k_, D)
    yt = per_tok[:, 0]
    for j in range(1, k_):
        yt = yt + per_tok[:, j]
    y = yt.reshape(B, S, D)
    if e.n_shared:
        sh = F.silu(xt @ p["shared_w1"]) * (xt @ p["shared_w3"])
        y = y + (sh @ p["shared_w2"]).reshape(B, S, D)
    return y, aux


# ---------------------------------------------------------------------------
# transformer stack
# ---------------------------------------------------------------------------
def _cast_layer(lp, dtype=BF16):
    """Cast every float32 leaf to the compute dtype — the MoE router
    included (``moe_ffn`` computes with its bf16-rounded values)."""
    return tree_map(lambda a: a.to(dtype) if a.dtype == torch.float32 else a,
                    lp)


def compute_copy(params):
    """The bf16 compute copy of a parameter tree: what every forward and
    decode step reads.  Each float32 leaf it casts is one the reference
    casts before use (layer stacks and the MTP block through
    ``_cast_layer``, the embedding table and the unembedding by
    ``.astype(bf16)``); ``final_norm`` stays as it is, read in float32.
    The cast is deterministic, so a model run on this copy gives the
    bytes it gives on ``params``."""
    return {k: (v if k == "final_norm" else _cast_layer(v))
            for k, v in params.items()}


def _layer_params(params, cfg: LMConfig, i: int):
    """Layer ``i``'s parameters (views into the stacks)."""
    if i < cfg.n_dense_layers:
        return tree_map(lambda a: a[i], params["dense_layers"])
    return tree_map(lambda a: a[i - cfg.n_dense_layers], params["layers"])


def _layer_fwd(x, lp, cfg: LMConfig, *, is_moe, is_global, positions):
    lp = _cast_layer(lp)
    window = None if is_global else cfg.window
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    attn = mla_attention if cfg.mla is not None else gqa_attention
    x = x + attn(h, lp["attn"], cfg, window=window, positions=positions)
    h = rms_norm(x, lp["ln2"], cfg.norm_eps)
    if is_moe:
        y, aux = moe_ffn(h, lp["ffn"], cfg)
    else:
        y, aux = dense_ffn(h, lp["ffn"]), torch.zeros(
            (), dtype=torch.float32, device=x.device)
    return x + y, aux


def lm_backbone(params, tokens, cfg: LMConfig):
    """tokens [B,S] → hidden states [B,S,D] (+ aux loss scalar)."""
    _, S = tokens.shape
    positions = torch.arange(S, device=tokens.device)
    x = params["embed"].to(BF16)[tokens.long()]
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    is_global = cfg.layer_is_global()
    has_moe = cfg.moe is not None
    remat = cfg.remat and torch.is_grad_enabled()
    for i in range(cfg.n_layers):
        lp = _layer_params(params, cfg, i)

        def fwd(x, lp, _i=i):
            return _layer_fwd(
                x, lp, cfg, is_moe=has_moe and _i >= cfg.n_dense_layers,
                is_global=bool(is_global[_i]), positions=positions)

        if remat:
            x, aux = checkpoint(fwd, x, lp, use_reentrant=False)
        else:
            x, aux = fwd(x, lp)
        aux_total = aux_total + aux
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x, aux_total


def _unembed(params, cfg: LMConfig):
    if cfg.tie_embeddings:
        return params["embed"].T
    return params["lm_head"]


def chunked_ce_loss(h, labels, mask, head, cfg: LMConfig):
    """Chunked CE. h:[B,S,D], labels/mask:[B,S] → scalar."""
    S = h.shape[1]
    C = min(cfg.loss_chunk, S)
    if S % C:
        raise ValueError("loss_chunk must divide seq len")
    nll, cnt = [], []
    for c0 in range(0, S, C):
        hi, li, mi = h[:, c0:c0 + C], labels[:, c0:c0 + C], mask[:, c0:c0 + C]
        logits = torch.einsum("bcd,dv->bcv", hi, head).float()
        lse = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, li[..., None].long())[..., 0]
        nll.append(((lse - gold) * mi).sum())
        cnt.append(mi.sum())
    return torch.stack(nll).sum() / torch.clamp(torch.stack(cnt).sum(), min=1.0)


def lm_loss(params, batch, cfg: LMConfig):
    """batch: tokens [B,S] int, loss_mask [B,S]. Next-token CE (+MTP)."""
    tokens = batch["tokens"].long()
    mask = batch["loss_mask"].float()
    h, aux = lm_backbone(params, tokens, cfg)
    head = _unembed(params, cfg).to(BF16)
    labels = F.pad(tokens[:, 1:], (0, 1))
    m1 = mask * F.pad(torch.ones_like(mask[:, 1:]), (0, 1))
    loss = chunked_ce_loss(h, labels, m1, head, cfg)
    metrics = {"ce": loss, "aux": aux}
    if cfg.mtp_depth:
        # MTP-1 (deepseek-v3): h'_t = Layer(Proj([h_t ; Emb(x_{t+1})]));
        # predict x_{t+2}
        mp = _cast_layer(params["mtp"])
        emb_next = params["embed"].to(BF16)[labels]
        hcat = torch.cat([h, emb_next], dim=-1)
        h2 = torch.einsum("bsd,de->bse", hcat, mp["proj"])
        h2, _ = _layer_fwd(
            h2, mp["layer"], cfg, is_moe=False, is_global=True,
            positions=torch.arange(tokens.shape[1], device=tokens.device),
        )
        h2 = rms_norm(h2, mp["norm"], cfg.norm_eps)
        labels2 = F.pad(tokens[:, 2:], (0, 2))
        m2 = mask * F.pad(torch.ones_like(mask[:, 2:]), (0, 2))
        mtp_loss = chunked_ce_loss(h2, labels2, m2, head, cfg)
        metrics["mtp"] = mtp_loss
        loss = loss + 0.3 * mtp_loss
    loss = loss + aux
    metrics["loss"] = loss
    return loss, metrics


# ---------------------------------------------------------------------------
# serving: prefill + single-token decode with KV cache
# ---------------------------------------------------------------------------
def _cache_leaf_shapes(cfg: LMConfig):
    """Per-position cache leaves: name → trailing shape."""
    if cfg.mla is not None:
        m = cfg.mla
        return {"ckv": (m.kv_lora_rank,), "k_rope": (m.qk_rope_head_dim,)}
    return {"k": (cfg.n_kv_heads, cfg.hd), "v": (cfg.n_kv_heads, cfg.hd)}


def cache_spec(cfg: LMConfig, batch: int, max_len: int):
    """TensorSpecs of the stacked per-layer KV cache."""
    return {name: TensorSpec((cfg.n_layers, batch, max_len) + tail, BF16)
            for name, tail in _cache_leaf_shapes(cfg).items()}


def cache_axes(cfg: LMConfig):
    if cfg.mla is not None:
        return {
            "ckv": ("layers", "batch", "kv_seq", "kv_lora"),
            "k_rope": ("layers", "batch", "kv_seq", "head_dim"),
        }
    return {
        "k": ("layers", "batch", "kv_seq", "kv_heads", "head_dim"),
        "v": ("layers", "batch", "kv_seq", "kv_heads", "head_dim"),
    }


def cache_spec_mixed(cfg: LMConfig, batch: int, max_len: int):
    """Per-layer cache list honouring each layer's attention reach:
    local layers get ring buffers of `window` slots, global layers get
    `max_len` (gemma3's 5:1 pattern keeps only 10/62 big caches)."""
    is_global = cfg.layer_is_global()
    out = []
    for i in range(cfg.n_layers):
        T = max_len if (is_global[i] or cfg.window is None) else min(
            max_len, cfg.window
        )
        out.append({name: TensorSpec((batch, T) + tail, BF16)
                    for name, tail in _cache_leaf_shapes(cfg).items()})
    return out


def cache_axes_mixed(cfg: LMConfig):
    if cfg.mla is not None:
        per = {
            "ckv": ("batch", "kv_seq", "kv_lora"),
            "k_rope": ("batch", "kv_seq", "head_dim"),
        }
    else:
        per = {
            "k": ("batch", "kv_seq", "kv_heads", "head_dim"),
            "v": ("batch", "kv_seq", "kv_heads", "head_dim"),
        }
    return [per for _ in range(cfg.n_layers)]


def init_cache(specs, device="cuda"):
    """Zero tensors for a tree of TensorSpecs (``cache_spec`` or
    ``cache_spec_mixed``) on ``device``."""
    return tree_map(
        lambda s: torch.zeros(s.shape, dtype=s.dtype, device=device), specs)


def _pos_vec(pos, B, device):
    """pos may be a scalar (uniform batch) or an int [B] vector
    (continuous batching, serve.engine)."""
    pos = torch.as_tensor(pos, device=device).long().reshape(-1)
    return pos.expand(B)


def _ring(cache_t, posb):
    """Write slots (pos mod T, floor modulo) and the absolute position
    each of the T slots holds ([B,T]; negative: never written)."""
    T = cache_t.shape[1]
    slot = torch.remainder(posb, T)
    kv_pos = posb[:, None] - torch.remainder(
        posb[:, None] - torch.arange(T, device=posb.device)[None, :], T)
    return slot, kv_pos


def _decode_probs(s, posb, kv_pos, window, dtype):
    """Masked float32 softmax over the cache slots; s: [B,H,T] float32."""
    valid = (kv_pos <= posb[:, None]) & (kv_pos >= 0)  # [B,T]
    if window is not None:
        valid &= (posb[:, None] - kv_pos) < window
    s = torch.where(valid[:, None, :], s, MASK_VALUE)
    return torch.softmax(s, dim=-1).to(dtype)


def _ffn_out(x, lp, cfg):
    h2 = rms_norm(x, lp["ln2"], cfg.norm_eps)
    if cfg.moe is not None and "router" in lp["ffn"]:
        return moe_ffn(h2, lp["ffn"], cfg)[0]
    return dense_ffn(h2, lp["ffn"])


def decode_step_gqa(x, lp, cache_l, cfg: LMConfig, *, pos, window):
    """One GQA decode step for one layer. x [B,1,D] → (x', cache_l').
    `pos`: scalar or [B] per-slot positions.  The cache is a ring of T
    slots (slot = pos mod T); for T = max_len that is a plain append.
    Scores take each KV head against its G query heads (the products of
    the reference's repeat, without repeating the cache)."""
    lp = _cast_layer(lp)
    B = x.shape[0]
    H, KH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    G = H // KH
    ap = lp["attn"]
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    posb = _pos_vec(pos, B, x.device)  # [B]
    posv = posb[:, None]               # [B,1] rope positions
    q = rope(torch.einsum("bsd,dhk->bshk", h, ap["wq"]), posv, cfg.rope_theta)
    k_new = rope(torch.einsum("bsd,dhk->bshk", h, ap["wk"]), posv,
                 cfg.rope_theta)
    v_new = torch.einsum("bsd,dhk->bshk", h, ap["wv"])
    k, v = cache_l["k"], cache_l["v"]
    slot, kv_pos = _ring(k, posb)
    barange = torch.arange(B, device=x.device)
    k[barange, slot] = k_new[:, 0].to(k.dtype)
    v[barange, slot] = v_new[:, 0].to(v.dtype)
    qg = q[:, 0].reshape(B, KH, G, hd)
    s = torch.einsum("bkgd,btkd->bkgt", qg, k).reshape(B, H, -1)
    p = _decode_probs(s.float() / np.sqrt(hd), posb, kv_pos, window, v.dtype)
    o = torch.einsum("bkgt,btkd->bkgd", p.reshape(B, KH, G, -1), v)
    x = x + torch.einsum("bhk,hkd->bd", o.reshape(B, H, hd), ap["wo"])[:, None]
    return x + _ffn_out(x, lp, cfg), {"k": k, "v": v}


def decode_step_mla(x, lp, cache_l, cfg: LMConfig, *, pos, window):
    """MLA decode with weight absorption: scores in latent space; the cache
    holds only (ckv, k_rope) — the compressed-KV form."""
    lp = _cast_layer(lp)
    m = cfg.mla
    nope = m.qk_nope_head_dim
    B = x.shape[0]
    ap = lp["attn"]
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    posb = _pos_vec(pos, B, x.device)
    posv = posb[:, None]
    cq = rms_norm(torch.einsum("bsd,dr->bsr", h, ap["wq_a"]), ap["q_norm"])
    q = torch.einsum("bsr,rhk->bshk", cq, ap["wq_b"])
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    q_rope = rope(q_rope, posv, cfg.rope_theta)
    ckv_rope = torch.einsum("bsd,dr->bsr", h, ap["wkv_a"])
    ckv_new = rms_norm(ckv_rope[..., :m.kv_lora_rank], ap["kv_norm"])
    kr_new = rope(ckv_rope[:, :, None, m.kv_lora_rank:], posv,
                  cfg.rope_theta)[:, :, 0, :]
    ckv, k_rope = cache_l["ckv"], cache_l["k_rope"]
    slot, kv_pos = _ring(ckv, posb)
    barange = torch.arange(B, device=x.device)
    ckv[barange, slot] = ckv_new[:, 0].to(ckv.dtype)
    k_rope[barange, slot] = kr_new[:, 0].to(k_rope.dtype)
    # absorption: q_nope^T W_kv^K → latent queries
    wk = ap["wkv_b"][..., :nope]  # [r, H, nope]
    wv = ap["wkv_b"][..., nope:]  # [r, H, v]
    q_lat = torch.einsum("bshk,rhk->bshr", q_nope, wk)  # [B,1,H,r]
    s = torch.einsum("bshr,btr->bhst", q_lat, ckv)[:, :, 0, :]
    s = s + torch.einsum("bshk,btk->bhst", q_rope, k_rope)[:, :, 0, :]
    s = s.float() / np.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim)
    p = _decode_probs(s, posb, kv_pos, window, ckv.dtype)
    o_lat = torch.einsum("bht,btr->bhr", p, ckv)  # [B,H,r]
    o = torch.einsum("bhr,rhk->bhk", o_lat, wv)   # [B,H,v]
    x = x + torch.einsum("bhk,hkd->bd", o, ap["wo"])[:, None]
    return x + _ffn_out(x, lp, cfg), {"ckv": ckv, "k_rope": k_rope}


@torch.no_grad()
def lm_decode_step(params, cache, tokens, pos, cfg: LMConfig):
    """serve_step: one new token against a KV cache.

    tokens [B,1] int, pos: scalar or [B] int (current length); cache: the
    stacked tree of ``cache_spec`` or the per-layer list of
    ``cache_spec_mixed`` (each layer's ring may be shorter); returns
    (logits [B,vocab] bf16, the cache, updated in place)."""
    x = params["embed"].to(BF16)[tokens.long()]  # [B,1,D]
    is_global = cfg.layer_is_global()
    step = decode_step_mla if cfg.mla is not None else decode_step_gqa
    stacked = not isinstance(cache, list)
    for i in range(cfg.n_layers):
        cl = ({name: c[i] for name, c in cache.items()} if stacked
              else cache[i])
        window = None if is_global[i] else cfg.window
        x, _ = step(x, _layer_params(params, cfg, i), cl, cfg, pos=pos,
                    window=window)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    head = _unembed(params, cfg).to(BF16)
    return x[:, 0] @ head, cache


def lm_prefill(params, tokens, cfg: LMConfig):
    """Prefill forward: last-position logits [B,vocab] (the forward is the
    dominant cost; decode builds its cache token by token)."""
    h, _ = lm_backbone(params, tokens, cfg)
    head = _unembed(params, cfg).to(BF16)
    return h[:, -1] @ head
