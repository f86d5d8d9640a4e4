"""Launchers of the Hopper kernels in ``csrc/bf_relax.cu``.

The port of the Pallas TPU kernel ``bf_relax`` (``repro/kernels/
bf_relax.py``) and of the fixed point iterated around it.  The CUDA
source is built with ``nvcc`` into a shared library with a plain C
interface and called through :mod:`ctypes` (see :mod:`._build`).

Each launcher checks device, dtype, shape and contiguity, allocates its
outputs with ``torch.empty``, launches on PyTorch's current stream and
raises if the launch was refused.  Nothing synchronises.  The public,
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

_TILES = (32, 16, 8, 4, 2, 1)


def layout_smem(jt: int, z: int, slots: int, stages: int) -> int:
    """Shared-memory bytes of one ``bf_relax_step`` block with this list
    and ring (``step_smem`` in the CUDA source): the staging ring, the
    [z][jt+1] distance tile, spur and ban words, next sources, caps and
    the in-edge list."""
    pitch = jt + 1 if jt > 1 else 1
    return (row_stage_smem(stages) + z * pitch * 4 + 3 * z * 4 + jt * 4
            + (8 + 4 * z + 8 * slots * z if slots else 0))


@functools.cache
def step_layout(jt: int, z: int) -> tuple[int, int, int]:
    """(slots, stages, shared-memory bytes) of one ``bf_relax_step`` block
    (``_build.step_layout``).  Slots 0: every block dense."""
    ring = row_stage_smem(0)
    return _step_layout(lambda slots: layout_smem(jt, z, slots, 0) - ring, z)


def step_smem(jt: int, z: int) -> int:
    """Shared-memory bytes of one ``bf_relax_step`` block."""
    return step_layout(jt, z)[2]


def tile_smem(jt: int, z: int) -> int:
    """Shared-memory bytes of one ``bf_solve_grouped`` block without its
    in-edge list: two distance tiles (pitch jt + 1, or 1 at jt = 1),
    spur/ban/banned-vertex words, caps and spur data."""
    pitch = jt + 1 if jt > 1 else 1
    return 2 * z * pitch * 4 + 3 * z * 4 + 3 * jt * 4


def solve_smem(jt: int, z: int) -> int:
    """Shared-memory bytes of one ``bf_solve_grouped`` block (mirrors the
    CUDA source): the tiles and the in-edge list, which takes what is left
    of the block's shared memory, up to ``EDGE_SLOTS`` slots per vertex.
    It fits whenever the tiles do; a block without room for the list runs
    the dense loop."""
    base = tile_smem(jt, z)
    return base + edge_list_smem(base, z)


def tile_width(J: int, z: int, smem) -> int:
    """Problems per block: the smallest pow2 tile ≥ J (at most 32) whose
    shared memory fits, halved until it does.

    >>> tile_width(3, 96, solve_smem), tile_width(40, 256, solve_smem)
    (4, 32)
    >>> tile_width(32, 1024, solve_smem)
    16
    """
    jt = next(t for t in reversed(_TILES) if t >= min(J, 32))
    while smem(jt, z) > SMEM_LIMIT:
        if jt == 1:
            raise ValueError(f"z={z} needs more shared memory than a block "
                             "has, even at one problem per block")
        jt //= 2
    return jt


@functools.cache
def _lib():
    lib = library("bf_relax")
    P, I = ctypes.c_void_p, ctypes.c_int
    check_row_stage(lib, "bf")
    lib.bf_relax_step.argtypes = [P] * 7 + [I] * 6 + [P]
    lib.bf_relax_step.restype = I
    lib.bf_step_blocks_per_sm.argtypes = [I] * 4
    lib.bf_step_blocks_per_sm.restype = I
    lib.bf_solve_grouped.argtypes = [P] * 10 + [I] * 6 + [P]
    lib.bf_solve_grouped.restype = I
    lib.bf_solve_blocks_per_sm.argtypes = [I] * 3
    lib.bf_solve_blocks_per_sm.restype = I
    return lib


def solve_blocks_per_sm(J: int, z: int) -> int:
    """Blocks of ``bf_solve_grouped`` one SM of the current card holds at
    once at this J and z (the CUDA occupancy query)."""
    jt = tile_width(J, z, solve_smem)
    return _lib().bf_solve_blocks_per_sm(
        z, jt, edge_list_slots(tile_smem(jt, z), z))


def step_blocks_per_sm(J: int, z: int) -> int:
    """Blocks of ``bf_relax_step`` one SM of the current card holds at
    once at this J and z (the CUDA occupancy query)."""
    jt = tile_width(J, z, step_smem)
    slots, stages, _ = step_layout(jt, z)
    return _lib().bf_step_blocks_per_sm(z, jt, slots, stages)


def relax_step(dist, adj, spur_onehot, banned_next, cap,
               with_path: bool = False):
    """Launch ``bf_relax_step``: one masked relaxation, the Pallas
    ``bf_relax`` contract.  dist [S,J,z] f32, adj [S,z,z] f32,
    spur_onehot/banned_next [S,J,z] bool, cap [S,J] f32 → [S,J,z] f32;
    ``with_path`` adds path [S, ceil(J/jt)] int32: 1 where the block
    relaxed from its in-edge list (every distance ≥ 0, every cap ≤ INF
    and every column within the list's slots), 0 where it ran the dense
    scan.  Both give the plain version's bytes."""
    S, J, z = dist.shape
    dev = dist.device
    check_row_size(z)
    check_tensor("dist", dist, torch.float32, (S, J, z), dev)
    check_tensor("adj", adj, torch.float32, (S, z, z), dev)
    check_tensor("spur_onehot", spur_onehot, torch.bool, (S, J, z), dev)
    check_tensor("banned_next", banned_next, torch.bool, (S, J, z), dev)
    check_tensor("cap", cap, torch.float32, (S, J), dev)
    out = torch.empty_like(dist)
    jt = tile_width(J, z, step_smem) if z else 1
    path = torch.empty((S, -(-J // jt)), dtype=torch.int32, device=dev)
    if S == 0 or J == 0 or z == 0:
        return (out, path) if with_path else out
    slots, stages, _ = step_layout(jt, z)
    with torch.cuda.device(dev):
        err = _lib().bf_relax_step(
            dist.data_ptr(), adj.data_ptr(), spur_onehot.data_ptr(),
            banned_next.data_ptr(), cap.data_ptr(), out.data_ptr(),
            path.data_ptr(), S, J, z, jt, slots, stages,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    check_launch(err, "bf_relax_step")
    return (out, path) if with_path else out


def solve_grouped(adj, init, banned_v, spur_onehot, banned_next, cap,
                  max_iters: int | None = None):
    """Launch ``bf_solve_grouped``: the whole masked grouped fixed point
    plus parents in one kernel.

    adj [S,z,z] f32, init [S,J,z] f32, banned_v/spur_onehot/banned_next
    [S,J,z] bool, cap [S,J] f32 → (dist [S,J,z] f32, parents [S,J,z]
    int32, iters [S, ceil(J/jt)] int32: the relaxations each block ran,
    at most ``max_iters``, default z, the reference's iteration cap;
    list [S, ceil(J/jt)] int32: 1 where the block ran from its in-edge
    list, 0 where a column over the list's budget made it run the dense
    loop).  The kernel skips adjacency entries ≥ INF, which keeps every
    byte for adj ≥ 0, init ≥ 0 and cap ≤ INF (``csrc/in_edges.cuh``)."""
    S, z, _ = adj.shape
    J = init.shape[1]
    dev = adj.device
    check_tensor("adj", adj, torch.float32, (S, z, z), dev)
    check_tensor("init", init, torch.float32, (S, J, z), dev)
    for name, m in (("banned_v", banned_v), ("spur_onehot", spur_onehot),
                    ("banned_next", banned_next)):
        check_tensor(name, m, torch.bool, (S, J, z), dev)
    check_tensor("cap", cap, torch.float32, (S, J), dev)
    jt = tile_width(J, z, solve_smem)
    dist = torch.empty_like(init)
    parent = torch.empty((S, J, z), dtype=torch.int32, device=dev)
    iters = torch.empty((S, -(-J // jt)), dtype=torch.int32, device=dev)
    used_list = torch.empty_like(iters)
    if S == 0 or J == 0 or z == 0:
        return dist, parent, iters, used_list
    with torch.cuda.device(dev):
        err = _lib().bf_solve_grouped(
            adj.data_ptr(), init.data_ptr(), banned_v.data_ptr(),
            spur_onehot.data_ptr(), banned_next.data_ptr(), cap.data_ptr(),
            dist.data_ptr(), parent.data_ptr(), iters.data_ptr(),
            used_list.data_ptr(), S, J, z,
            z if max_iters is None else int(max_iters), jt,
            edge_list_slots(tile_smem(jt, z), z),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    check_launch(err, "bf_solve_grouped")
    return dist, parent, iters, used_list
