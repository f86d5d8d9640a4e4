"""Roofline terms on one NVIDIA H100 from a shapes-only trace of a step.

Three terms per (arch × shape), in seconds, for the card that runs the
whole cell:

    compute    = Σ_class ops[class] / rate[class]
    memory     = bytes moved / HBM bandwidth
    collective = collective bytes / NVLink bandwidth

:func:`trace_costs` runs a cell's own ``step_fn`` once on meta tensors
built from its ``TensorSpec`` leaves (nothing is allocated, nothing runs on
a device) under one ``TorchDispatchMode`` that sees every aten op the
eager program issues, forward and backward, and counts:

- **products** (matmul, bmm, addmm, baddbmm, convolution, scaled-dot-
  product attention) from ``torch.utils.flop_counter``'s formulas, by
  the input dtype: bf16/fp16 at the tensor-core rate; float32 at the
  SIMT rate, or at the TF32 rate when
  ``torch.backends.cuda.matmul.allow_tf32`` (``cudnn.allow_tf32`` for a
  convolution) is set while the op is traced.  Elementwise FLOPs are not
  counted, so "useful %" in ``report.py`` is model FLOPs over product
  FLOPs;
- **min-plus operations** of the Hopper kernels, which ``kernels/ops.py``
  reports from its shapes-only path (the reference's count: 2·S·J·z² per
  BF relaxation, 2·S·k·z² per ktrop relaxation, 2·B·E per
  ``bound_dist``; a fixed point at its iteration budget), at the FADD/
  FMNMX issue rate: one add or one min per lane and clock;
- **bytes**: the inputs plus the outputs of every op that allocates.  A
  view or an alias moves nothing; an op that writes its own input counts
  that input once; a gather (``index``, ``index_select``, ``embedding``,
  ``gather``) reads at most as many elements of its table as it writes;
  an indexed write (``index_put_``, ``index_add_``, ``scatter*_``) writes
  the rows of its source, not its whole destination; a stride-0
  (expanded) dimension is read once; ``empty`` writes nothing.  The port
  fuses nothing, so this is the eager program's HBM traffic, and it
  stands in for XLA's post-fusion "bytes accessed".  Bytes of ops whose
  working set (inputs plus outputs) exceeds the 50 MB L2 are kept apart
  (``hbm_bytes_over_l2``): only those must come from HBM;
- **memory**: ``argument_bytes`` and ``output_bytes`` (unique storages),
  and ``temp_bytes``, the peak of live non-argument storage during the
  step.  Lifetimes follow Python references and autograd's saved
  tensors (a storage is freed when its last reference dies), as the
  caching allocator sees them on the card; workspaces a CUDA kernel
  takes for itself (cuBLAS, sort) are not seen;
- **collectives**: bytes (of each op's first argument, its output) and
  counts of the ``torch.distributed`` collectives the step issues
  (``c10d`` ops in dispatch), under the reference's kind names.

Constants are the NVIDIA H100 SXM data sheet's (dense, no sparsity, at
700 W); a card set to a lower power limit runs slower under load.
"""

from __future__ import annotations

import dataclasses
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

# --- NVIDIA H100 SXM data sheet, dense, 700 W ------------------------------
BF16_FLOPS = 989.4e12      # bf16 / fp16 tensor cores, FLOP/s
TF32_FLOPS = 494.7e12      # TF32 tensor cores, FLOP/s
FP32_FLOPS = 66.9e12       # float32 outside the tensor cores (an FMA is 2)
MINPLUS_OPS = 33.5e12      # float32 add or min/max issue: 132 SMs × 128
#                            lanes × 1.98 GHz, op/s
HBM_BW = 3.35e12           # HBM3, B/s
NVLINK_BW = 450e9          # NVLink 4, B/s per direction per card
L2_BYTES = 50e6            # L2 cache

#: rate of each class of counted work
RATES = {
    "bf16": BF16_FLOPS,
    "fp16": BF16_FLOPS,
    "tf32": TF32_FLOPS,
    "f32": FP32_FLOPS,
    "f64": FP32_FLOPS,     # FP64 tensor cores run at the float32 SIMT rate
    "other": FP32_FLOPS,
    "minplus": MINPLUS_OPS,
}

_DTYPE_CLASS = {torch.bfloat16: "bf16", torch.float16: "fp16",
                torch.float32: "f32", torch.float64: "f64"}

_aten = torch.ops.aten
# allocate without writing
_NO_WRITE = {_aten.empty, _aten.empty_strided, _aten.empty_like,
             _aten.new_empty, _aten.new_empty_strided}
# read at most as many table elements as they write
_GATHERS = {_aten.index, _aten.index_select, _aten.embedding, _aten.gather}
# write the rows of their source into their first argument
_INDEXED_WRITES = {_aten.index_put_, _aten._index_put_impl_,
                   _aten.index_add_, _aten.index_copy_, _aten.scatter_,
                   _aten.scatter_add_, _aten.scatter_reduce_}
_CONVS = {_aten.convolution, _aten._convolution, _aten.convolution_backward,
          _aten.cudnn_convolution}
# c10d op name (without its trailing "_") → the reference's kind
_COLLECTIVES = {
    "allreduce": "all-reduce", "allreduce_coalesced": "all-reduce",
    "all_reduce": "all-reduce",
    "allgather": "all-gather", "_allgather_base": "all-gather",
    "allgather_coalesced": "all-gather",
    "allgather_into_tensor_coalesced": "all-gather",
    "all_gather_into_tensor": "all-gather",
    "reduce_scatter": "reduce-scatter", "_reduce_scatter_base": "reduce-scatter",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "alltoall": "all-to-all", "alltoall_base": "all-to-all",
    "all_to_all_single": "all-to-all",
    "send": "collective-permute", "recv": "collective-permute",
    "broadcast": "broadcast",
}


def _storage_id(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def _read_bytes(t: torch.Tensor) -> int:
    """Bytes of ``t`` as an op reads it: a stride-0 dimension once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride:
            n *= size
    return n * t.element_size()


def _tensors(tree) -> list:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def _tf32(func) -> bool:
    if func in _CONVS:
        return bool(torch.backends.cudnn.allow_tf32)
    return bool(torch.backends.cuda.matmul.allow_tf32)


@dataclasses.dataclass
class Costs:
    """What one trace of a step counted (see the module docstring)."""

    flops_by_class: dict = dataclasses.field(default_factory=dict)
    hbm_bytes: int = 0
    hbm_bytes_over_l2: int = 0
    coll_bytes: dict = dataclasses.field(default_factory=dict)
    coll_counts: dict = dataclasses.field(default_factory=dict)
    kernels: dict = dataclasses.field(default_factory=dict)
    argument_bytes: int = 0
    output_bytes: int = 0
    temp_bytes: int = 0
    n_ops: int = 0

    def add_flops(self, cls: str, n: float) -> None:
        self.flops_by_class[cls] = self.flops_by_class.get(cls, 0.0) + n

    def add_bytes(self, n: int) -> None:
        self.hbm_bytes += n
        if n > L2_BYTES:
            self.hbm_bytes_over_l2 += n

    def memory(self) -> dict:
        return {"argument_bytes": self.argument_bytes,
                "output_bytes": self.output_bytes,
                "temp_bytes": self.temp_bytes,
                "generated_code_bytes": None}

    def roofline(self, n_devices: int = 1) -> "Roofline":
        detail = dict(self.coll_bytes)
        detail["_ops"] = sum(self.coll_counts.values())
        detail["_counts"] = dict(self.coll_counts)
        return Roofline(
            flops=float(sum(self.flops_by_class.values())),
            hbm_bytes=float(self.hbm_bytes),
            coll_bytes=float(sum(self.coll_bytes.values())),
            coll_detail=detail, n_devices=n_devices,
            flops_by_class=dict(self.flops_by_class),
            hbm_bytes_over_l2=float(self.hbm_bytes_over_l2))


class _Tracer(TorchDispatchMode):
    """Counts each aten op's products, bytes and collectives, and the
    live non-argument storage after each op."""

    def __init__(self, costs: Costs, argument_storages: set):
        super().__init__()
        self.costs = costs
        self.known = set(argument_storages)
        self.live = 0

    def _freed(self, sid: int, n: int) -> None:
        self.known.discard(sid)
        self.live -= n

    def kernel_cost(self, kernel: str, n_bytes: int, ops: float) -> None:
        k = self.costs.kernels.setdefault(
            kernel, {"calls": 0, "bytes": 0, "minplus_ops": 0.0})
        k["calls"] += 1
        k["bytes"] += n_bytes
        k["minplus_ops"] += ops
        self.costs.add_bytes(n_bytes)
        self.costs.add_flops("minplus", ops)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        costs = self.costs
        costs.n_ops += 1
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        if func.namespace in ("c10d", "_c10d_functional"):
            name = func.__name__.split(".")[0].rstrip("_")
            kind = _COLLECTIVES.get(name, name)
            first = _tensors(args[:1]) or outs
            costs.coll_bytes[kind] = (costs.coll_bytes.get(kind, 0)
                                      + sum(t.nbytes for t in first))
            costs.coll_counts[kind] = costs.coll_counts.get(kind, 0) + 1
            return out
        in_ids = {_storage_id(t) for t in ins}
        fresh = []
        for t in outs:
            sid = _storage_id(t)
            if sid in in_ids:
                continue
            fresh.append(t)
            if sid not in self.known:
                st = t.untyped_storage()
                n = st.nbytes()
                self.known.add(sid)
                self.live += n
                weakref.finalize(st, self._freed, sid, n).atexit = False
        if self.live > costs.temp_bytes:
            costs.temp_bytes = self.live

        packet = func.overloadpacket
        formula = flop_registry.get(packet)
        if formula is not None and ins:
            cls = _DTYPE_CLASS.get(ins[0].dtype, "other")
            if cls == "f32" and _tf32(packet):
                cls = "tf32"
            costs.add_flops(cls, float(formula(*args, **kwargs,
                                               out_val=out)))
        if packet in _NO_WRITE:
            return out
        if func._schema.is_mutable:
            out_ids = {_storage_id(t) for t in outs}
            if packet in _INDEXED_WRITES:
                self_id = _storage_id(ins[0])
                rest = [t for t in ins if _storage_id(t) != self_id]
                rows = max((t.numel() for t in rest), default=0)
                n = (sum(_read_bytes(t) for t in rest)
                     + rows * ins[0].element_size())
            else:
                n = (sum(_read_bytes(t) for t in ins
                         if _storage_id(t) not in out_ids)
                     + sum(t.nbytes for t in outs))
        elif not fresh:
            return out  # a view or an alias
        else:
            written = sum(t.nbytes for t in fresh)
            reads = [_read_bytes(t) for t in ins]
            if packet in _GATHERS and reads:
                reads[0] = min(reads[0], written)
            n = sum(reads) + written
        costs.add_bytes(n)
        return out


def meta_args(tree):
    """Meta tensors for the ``TensorSpec`` leaves of a tree (shapes and
    dtypes only; nothing is allocated); other leaves are kept."""
    from repro_torch.configs.base import TensorSpec
    from repro_torch.models.common import tree_map

    return tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype,
                                          device="meta")
                    if isinstance(s, TensorSpec) else s, tree)


def _unique_bytes(tensors) -> int:
    seen = {}
    for t in tensors:
        seen.setdefault(_storage_id(t), t.untyped_storage().nbytes())
    return sum(seen.values())


def trace_costs(step_fn, args) -> Costs:
    """Run ``step_fn(*args)`` once under the tracer and return its
    :class:`Costs`.  ``args`` may hold ``TensorSpec`` leaves (made meta
    tensors here) or tensors (used as they are)."""
    from repro_torch.kernels import ops

    args = meta_args(tuple(args))
    arg_tensors = _tensors(args)
    costs = Costs(argument_bytes=_unique_bytes(arg_tensors))
    tracer = _Tracer(costs, {_storage_id(t) for t in arg_tensors})
    ops.COST_SINKS.append(tracer.kernel_cost)
    try:
        with tracer:
            out = step_fn(*args)
    finally:
        ops.COST_SINKS.remove(tracer.kernel_cost)
    arg_ids = {_storage_id(t) for t in arg_tensors}
    costs.output_bytes = _unique_bytes(
        t for t in _tensors(out) if _storage_id(t) not in arg_ids)
    return costs


@dataclasses.dataclass
class Roofline:
    flops: float
    hbm_bytes: float
    coll_bytes: float
    coll_detail: dict
    n_devices: int
    flops_by_class: dict = dataclasses.field(default_factory=dict)
    hbm_bytes_over_l2: float = 0.0

    @property
    def t_compute(self) -> float:
        return sum(n / RATES[c] for c, n in self.flops_by_class.items())

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def t_memory_over_l2(self) -> float:
        return self.hbm_bytes_over_l2 / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / NVLINK_BW

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.t_compute,
            "memory": self.t_memory,
            "collective": self.t_collective,
        }
        return max(terms, key=terms.get)

    def as_dict(self) -> dict:
        return {
            "flops": self.flops,
            "hbm_bytes": self.hbm_bytes,
            "coll_bytes": self.coll_bytes,
            "coll_detail": {
                k: v for k, v in self.coll_detail.items() if k != "_counts"
            },
            "coll_counts": self.coll_detail.get("_counts", {}),
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "dominant": self.dominant,
            "n_devices": self.n_devices,
            "flops_by_class": dict(self.flops_by_class),
            "t_compute_by_class_s": {c: n / RATES[c] for c, n
                                     in self.flops_by_class.items()},
            "hbm_bytes_over_l2": self.hbm_bytes_over_l2,
            "t_memory_over_l2_s": self.t_memory_over_l2,
        }
