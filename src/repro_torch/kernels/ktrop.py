"""Launchers of the Hopper kernels in ``csrc/ktrop.cu``.

The port of the Pallas TPU kernel ``ktrop_relax`` (``repro/kernels/
ktrop.py``) and of the fixed point ``engine.dense.ktrop_solve`` iterates
around it.  Built and called like ``kernels/bf_relax.py``: each launcher
checks device, dtype, shape and contiguity, allocates with
``torch.empty``, launches on PyTorch's current stream without
synchronising, and raises if the launch was refused.  The public,
counted wrappers are in :mod:`repro_torch.kernels.ops`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ._build import (SMEM_LIMIT, check_launch, check_row_size, check_row_stage,
                     check_tensor, edge_list_slots, edge_list_smem, library,
                     row_stage_smem)
from ._build import step_layout as _step_layout

K_MAX = 16  # levels a thread keeps in registers (the TPU kernel's own plan)


def solve_smem(k: int, z: int) -> int:
    """Shared-memory bytes of one ``ktrop_solve`` block (mirrors the CUDA
    source): D double-buffered as two [k][z] f32 tiles, and the in-edge
    list in what is left, up to ``EDGE_SLOTS`` slots per vertex (none, and
    the dense loop, where no slot fits)."""
    base = 2 * k * z * 4
    return base + edge_list_smem(base, z)


def layout_smem(k: int, z: int, slots: int, stages: int) -> int:
    """Shared-memory bytes of one ``ktrop_relax_step`` block with this list
    and ring (``step_smem`` in the CUDA source): the staging ring, D[s] as
    [k][z] f32, next sources and the in-edge list."""
    return (row_stage_smem(stages) + k * z * 4 + z * 4
            + (8 + 4 * z + 8 * slots * z if slots else 0))


@functools.cache
def step_layout(k: int, z: int) -> tuple[int, int, int]:
    """(slots, stages, shared-memory bytes) of one ``ktrop_relax_step``
    block (``_build.step_layout``).  Slots 0: every row scans the dense
    row."""
    ring = row_stage_smem(0)
    return _step_layout(lambda slots: layout_smem(k, z, slots, 0) - ring, z)


def step_smem(k: int, z: int) -> int:
    """Shared-memory bytes of one ``ktrop_relax_step`` block."""
    return step_layout(k, z)[2]


def _check_k(k: int) -> None:
    if not 1 <= k <= K_MAX:
        raise ValueError(f"the ktrop kernels take 1 <= k <= {K_MAX}, got {k}")


@functools.cache
def _lib():
    lib = library("ktrop")
    P, I = ctypes.c_void_p, ctypes.c_int
    check_row_stage(lib, "ktrop")
    lib.ktrop_relax_step.argtypes = [P] * 4 + [I] * 5 + [P]
    lib.ktrop_relax_step.restype = I
    lib.ktrop_step_blocks_per_sm.argtypes = [I] * 4
    lib.ktrop_step_blocks_per_sm.restype = I
    lib.ktrop_solve.argtypes = [P] * 5 + [I] * 5 + [P]
    lib.ktrop_solve.restype = I
    lib.ktrop_solve_blocks_per_sm.argtypes = [I] * 3
    lib.ktrop_solve_blocks_per_sm.restype = I
    return lib


def solve_blocks_per_sm(k: int, z: int) -> int:
    """Blocks of ``ktrop_solve`` one SM of the current card holds at once
    at this k and z (the CUDA occupancy query)."""
    _check_k(k)
    return _lib().ktrop_solve_blocks_per_sm(
        k, z, edge_list_slots(2 * k * z * 4, z))


def step_blocks_per_sm(k: int, z: int) -> int:
    """Blocks of ``ktrop_relax_step`` one SM of the current card holds at
    once at this k and z (the CUDA occupancy query)."""
    _check_k(k)
    slots, stages, _ = step_layout(k, z)
    return _lib().ktrop_step_blocks_per_sm(k, z, slots, stages)


def relax_step(D, adj, with_path: bool = False):
    """Launch ``ktrop_relax_step``: one k-distinct relaxation, the Pallas
    ``ktrop_relax`` contract at any z whose D[s] fits in shared memory.
    D [S,k,z] f32 ascending along k, adj [S,z,z] f32 → [S,k,z] f32;
    ``with_path`` adds path [S] int32: 1 where the row folded its
    in-edge list (D[s] ≥ 0 and every column within the list's slots), 0
    where it scanned every u.  Both give the plain version's bytes."""
    S, k, z = D.shape
    dev = D.device
    _check_k(k)
    check_row_size(z)
    if step_smem(k, z) > SMEM_LIMIT:
        raise ValueError(f"ktrop_relax_step keeps D[s] in shared memory: "
                         f"k={k}, z={z} needs more than a block has "
                         f"({SMEM_LIMIT} bytes)")
    check_tensor("D", D, torch.float32, (S, k, z), dev)
    check_tensor("adj", adj, torch.float32, (S, z, z), dev)
    out = torch.empty_like(D)
    path = torch.empty((S,), dtype=torch.int32, device=dev)
    if S == 0 or z == 0:
        return (out, path) if with_path else out
    slots, stages, _ = step_layout(k, z)
    with torch.cuda.device(dev):
        err = _lib().ktrop_relax_step(
            D.data_ptr(), adj.data_ptr(), out.data_ptr(), path.data_ptr(),
            S, k, z, slots, stages,
            torch.cuda.current_stream(dev).cuda_stream)
    check_launch(err, "ktrop_relax_step")
    return (out, path) if with_path else out


def solve(adj, src, k: int, max_iters: int | None = None):
    """Launch ``ktrop_solve``: the k-distinct fixed point from ``src`` in
    one kernel.  adj [S,z,z] f32, src [S] int32 (each in [0, z)) →
    (D [S,k,z] f32, iters [S] int32: the relaxations each row ran, at
    most ``max_iters``, default z·k+8 as in the reference; list [S]
    int32: 1 where the row ran from its in-edge list, 0 where a column
    over the list's budget made it run the dense loop)."""
    S, z, _ = adj.shape
    dev = adj.device
    _check_k(k)
    if solve_smem(k, z) > SMEM_LIMIT:
        raise ValueError(f"ktrop_solve keeps D in shared memory: k={k}, "
                         f"z={z} needs {solve_smem(k, z)} bytes, more than "
                         f"a block has ({SMEM_LIMIT})")
    check_tensor("adj", adj, torch.float32, (S, z, z), dev)
    check_tensor("src", src, torch.int32, (S,), dev)
    max_iters = z * k + 8 if max_iters is None else int(max_iters)
    D = torch.empty((S, k, z), dtype=torch.float32, device=dev)
    iters = torch.empty((S,), dtype=torch.int32, device=dev)
    used_list = torch.empty_like(iters)
    if S == 0 or z == 0:
        return D, iters, used_list
    with torch.cuda.device(dev):
        err = _lib().ktrop_solve(
            adj.data_ptr(), src.data_ptr(), D.data_ptr(), iters.data_ptr(),
            used_list.data_ptr(), S, k, z, max_iters,
            edge_list_slots(2 * k * z * 4, z),
            torch.cuda.current_stream(dev).cuda_stream)
    check_launch(err, "ktrop_solve")
    return D, iters, used_list
