"""``launch.roofline.trace_costs``: the shapes-only trace that the port's
dry-run runs in place of XLA's cost and memory analyses.

Product FLOPs of a small LM (prefill, decode and a remat train step) by
dtype equal an analytic count and ``FlopCounterMode``'s total; bytes
moved and the temporary peak are exact on a hand-written op sequence; a
``torch.distributed`` all-reduce on a one-process gloo group counts its
bytes under the reference's kind name.  Nothing here has a JAX
counterpart: the reference reads the same terms from a TPU compile."""

import dataclasses
import functools

import pytest
import torch
import torch.distributed as dist
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import starcoder2_3b
from repro_torch.configs.base import TensorSpec, spec_tree
from repro_torch.configs.lm_family import lm_cells
from repro_torch.launch import roofline
from repro_torch.launch.roofline import meta_args, trace_costs
from repro_torch.models import transformer as T
from repro_torch.models.common import DTypePolicy

CFG = dataclasses.replace(starcoder2_3b.SMOKE, n_layers=2)
B, S, T_CACHE = 2, 64, 48


def _layer_fwd_flops(cfg, tokens, kv_len):
    """Products of one layer's forward over ``tokens`` query positions
    (B·S) against ``kv_len`` keys each: q, k, v, o projections, scores
    and values over every key (the mask is applied after), the plain
    GELU MLP."""
    d, H, KH, hd, f = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                       cfg.d_ff)
    proj = 2 * tokens * d * (H + 2 * KH) * hd + 2 * tokens * H * hd * d
    attn = 2 * 2 * tokens * H * kv_len * hd
    mlp = 2 * 2 * tokens * d * f
    return proj + attn + mlp


def _analytic(kind):
    L, d, V = CFG.n_layers, CFG.d_model, CFG.vocab
    if kind == "prefill":  # every position against the whole sequence
        return L * _layer_fwd_flops(CFG, B * S, S) + 2 * B * d * V
    if kind == "decode":   # one position against the cache's T slots
        return L * _layer_fwd_flops(CFG, B, T_CACHE) + 2 * B * d * V
    # train: per layer the forward, the remat forward again and a
    # backward of twice the forward; non-reentrant checkpointing stops
    # its recompute once the backward's saved tensors are back, so the
    # layer's last product (the MLP's down projection, which saves only
    # its inputs) is not recomputed; the loss head forward and backward
    down = 2 * B * S * CFG.d_ff * d
    return (L * (4 * _layer_fwd_flops(CFG, B * S, S) - down)
            + 3 * 2 * B * S * d * V)


def _step(kind):
    policy = DTypePolicy()
    if kind == "decode":
        p = spec_tree(T.init_lm(0, CFG, policy, device="meta"))
        return (functools.partial(T.lm_decode_step, cfg=CFG),
                (p, T.cache_spec(CFG, B, T_CACHE),
                 TensorSpec((B, 1), torch.int32), TensorSpec((), torch.int32)))
    cell = next(c for c in lm_cells("small", CFG, policy, None)
                if c.kind == kind)
    specs = list(cell.arg_specs)
    if kind == "train":
        specs[2] = {k: TensorSpec((B, S), v.dtype)
                    for k, v in specs[2].items()}
    else:
        specs[1] = TensorSpec((B, S), torch.int32)
    return cell.step_fn, tuple(specs)


@pytest.mark.parametrize("kind", ["prefill", "decode", "train"])
def test_product_flops_by_dtype(kind):
    step, specs = _step(kind)
    costs = trace_costs(step, specs)
    want = _analytic(kind)
    assert costs.flops_by_class == {"bf16": pytest.approx(want, rel=0,
                                                          abs=0.5)}
    with FlopCounterMode(display=False) as counter:
        step(*meta_args(specs))
    assert counter.get_total_flops() == want
    r = costs.roofline()
    assert r.t_compute == pytest.approx(want / roofline.BF16_FLOPS)
    assert r.flops == want and r.dominant in ("compute", "memory")


def test_tf32_class_follows_the_flag():
    a = TensorSpec((64, 32), torch.float32)
    b = TensorSpec((32, 16), torch.float32)
    old = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        on = trace_costs(torch.matmul, (a, b))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
    off = trace_costs(torch.matmul, (a, b))
    assert on.flops_by_class == {"tf32": 2 * 64 * 32 * 16}
    assert off.flops_by_class == {"f32": 2 * 64 * 32 * 16}


def _sequence(a, b, bias):
    c = a @ b                 # reads 8192 + 2048, writes 4096
    d = c + bias              # reads 4096 + 64, writes 4096
    e = d.t()                 # a view: nothing
    f = e.contiguous()        # reads 4096, writes 4096; live c, d, f
    del c                     # freed: live d, f
    f.mul_(2.0)               # in place: f once, 4096
    g = f[:, :8]              # a view: nothing
    return g.sum()            # reads 16·8·4 = 512, writes 4


def test_bytes_and_temp_peak_are_exact():
    specs = (TensorSpec((64, 32), torch.float32),
             TensorSpec((32, 16), torch.float32),
             TensorSpec((16,), torch.float32))
    costs = trace_costs(_sequence, specs)
    assert costs.hbm_bytes == ((8192 + 2048 + 4096) + (4096 + 64 + 4096)
                               + (4096 + 4096) + 4096 + (512 + 4))
    assert costs.argument_bytes == 8192 + 2048 + 64
    assert costs.temp_bytes == 3 * 4096
    assert costs.output_bytes == 4
    assert costs.flops_by_class == {"f32": 2 * 64 * 32 * 16}
    assert costs.hbm_bytes_over_l2 == 0


def test_indexed_reads_and_writes_count_rows():
    """A gather reads the rows it writes; an indexed write writes its
    source's rows, not the whole table."""
    def step(table, ids, rows):
        got = table[ids]               # reads ≤ 8·32·4, writes 8·32·4
        table.index_add_(0, ids, rows)  # reads ids + rows, writes 8 rows
        return got

    specs = (TensorSpec((100_000, 32), torch.float32),
             TensorSpec((8,), torch.int64), TensorSpec((8, 32), torch.float32))
    costs = trace_costs(step, specs)
    row_bytes = 8 * 32 * 4
    assert costs.hbm_bytes == (row_bytes + 64 + row_bytes) + (
        64 + row_bytes + row_bytes)


def test_allreduce_counts_as_all_reduce(tmp_path):
    store = dist.FileStore(str(tmp_path / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        def step(x):
            dist.all_reduce(x)
            return x * 2

        costs = trace_costs(step, (torch.ones(1000),))
    finally:
        dist.destroy_process_group()
    assert costs.coll_bytes == {"all-reduce": 4000}
    assert costs.coll_counts == {"all-reduce": 1}
    r = costs.roofline().as_dict()
    assert r["coll_bytes"] == 4000 and r["coll_counts"] == {"all-reduce": 1}
    assert r["coll_detail"] == {"all-reduce": 4000, "_ops": 1}
    assert r["t_collective_s"] == pytest.approx(4000 / roofline.NVLINK_BW)


def test_roofline_dict_has_the_reference_keys():
    keys = {"flops", "hbm_bytes", "coll_bytes", "coll_detail",
            "coll_counts", "t_compute_s", "t_memory_s", "t_collective_s",
            "dominant", "n_devices"}
    costs = trace_costs(torch.matmul, (TensorSpec((4, 4), torch.bfloat16),
                                       TensorSpec((4, 4), torch.bfloat16)))
    assert keys <= set(costs.roofline().as_dict())
