"""AdamW + schedules + gradient clipping + int8 gradient compression.

Optimizer state is a tree mirroring params (``{"m", "v", "step"}``), so
the checkpointer and ``repro_torch.convert`` see the reference's layout.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.dist.shard_refine import _comm_device, shard_count
from repro_torch.models.common import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class OptConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: torch.dtype = torch.float32  # bf16 for the largest models


def lr_at(step, cfg: OptConfig):
    """Linear warmup, then cosine decay to ``min_lr_ratio`` (float32)."""
    step = torch.as_tensor(step).float()
    warm = cfg.peak_lr * step / max(1.0, cfg.warmup_steps)
    prog = torch.clamp(
        (step - cfg.warmup_steps)
        / max(1.0, cfg.decay_steps - cfg.warmup_steps),
        0.0,
        1.0,
    )
    cos = cfg.peak_lr * (
        cfg.min_lr_ratio
        + (1 - cfg.min_lr_ratio) * 0.5 * (1 + torch.cos(math.pi * prog))
    )
    return torch.where(step < cfg.warmup_steps, warm, cos)


def init_opt(params, cfg: OptConfig):
    def zeros(p):
        return torch.zeros(p.shape, dtype=cfg.moment_dtype, device=p.device)

    step_device = tree_leaves(params)[0].device
    return {
        "m": tree_map(zeros, params),
        "v": tree_map(zeros, params),
        "step": torch.zeros((), dtype=torch.int32, device=step_device),
    }


def global_norm(tree):
    return torch.sqrt(
        sum(torch.sum(torch.square(x.float())) for x in tree_leaves(tree)))


@torch.no_grad()
def adamw_update(grads, opt_state, params, cfg: OptConfig):
    """Returns (new_params, new_opt_state, metrics)."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    step = opt_state["step"] + 1
    lr = lr_at(step, cfg)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - b1 ** step.float()
    bc2 = 1 - b2 ** step.float()

    def upd(p, g, m, v):
        g = g.float() * scale
        m32 = m.float() * b1 + (1 - b1) * g
        v32 = v.float() * b2 + (1 - b2) * torch.square(g)
        mh = m32 / bc1
        vh = v32 / bc2
        delta = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * p.float()
        newp = (p.float() - lr * delta).to(p.dtype)
        return newp, m32.to(m.dtype), v32.to(v.dtype)

    out = tree_map(upd, params, grads, opt_state["m"], opt_state["v"])
    new_p, new_m, new_v = (tree_map(lambda _, o, j=j: o[j], params, out)
                           for j in range(3))
    metrics = {"grad_norm": gnorm, "lr": lr}
    return new_p, {"m": new_m, "v": new_v, "step": step}, metrics


# ---------------------------------------------------------------------------
# int8 error-feedback gradient compression
# ---------------------------------------------------------------------------
def compress_int8(g):
    """Per-tensor symmetric int8 quantization → (q, scale)."""
    amax = torch.max(torch.abs(g)) + 1e-12
    scale = amax / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress_int8(q, scale):
    return q.float() * scale


def compressed_psum(g, mesh, residual=None, axis=("data", "model")):
    """Error-feedback compressed all-reduce over a ``launch.mesh``
    ``DeviceMesh``: quantize (g + residual) to int8, sum the int8
    payloads (as int32) and the scales over the shards, and return
    (avg_grad, new_residual) with avg = Σq · (Σscale / n) / n.

    Every shard of this process contributes ``g`` (replicated over the
    local shards); other processes contribute theirs.  The int8
    all-reduce of ``dist.shard_refine.make_allreduce_fn`` computes
    another function — the mean of each shard's own q·scale, with a
    clamped scale and no +1e-12 — so this one does its own reduction.
    """
    n = shard_count(mesh, axis)
    if residual is not None:
        g = g + residual
    q, scale = compress_int8(g)
    local = len(mesh.devices)
    summed = q.to(torch.int32) * local
    scale_sum = scale * local
    if mesh.group is not None:
        import torch.distributed as dist

        dev = _comm_device(mesh)
        summed, scale_sum = summed.to(dev), scale_sum.reshape(1).to(dev)
        dist.all_reduce(summed, op=dist.ReduceOp.SUM, group=mesh.group)
        dist.all_reduce(scale_sum, op=dist.ReduceOp.SUM, group=mesh.group)
        summed, scale_sum = summed.to(g.device), scale_sum[0].to(g.device)
    avg = summed.float() * (scale_sum / n) / n
    return avg, g - decompress_int8(q, scale)
