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

from ._build import library

# dynamic shared memory one block may opt into on sm_90 (227 KiB)
SMEM_LIMIT = 232_448
_TILES = (32, 16, 8, 4, 2, 1)


def step_smem(jt: int, z: int) -> int:
    """Shared-memory bytes of one ``bf_relax_step`` block (mirrors the
    CUDA source): the [z][jt] distance tile, spur words, caps."""
    return z * jt * 4 + z * 4 + jt * 4


def solve_smem(jt: int, z: int) -> int:
    """Shared-memory bytes of one ``bf_solve_grouped`` block: two
    distance tiles, spur/ban/banned-vertex words, caps and spur data."""
    return 2 * z * jt * 4 + 3 * z * 4 + 3 * jt * 4


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
    lib.bf_relax_step.argtypes = [P] * 6 + [I] * 4 + [P]
    lib.bf_relax_step.restype = I
    lib.bf_solve_grouped.argtypes = [P] * 9 + [I] * 5 + [P]
    lib.bf_solve_grouped.restype = I
    return lib


def _check(name, t, dtype, shape, device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t)}")
    if t.device != device or device.type != "cuda":
        raise ValueError(f"{name} must lie on the CUDA device {device}, "
                         f"got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def relax_step(dist, adj, spur_onehot, banned_next, cap):
    """Launch ``bf_relax_step``: one masked relaxation, the Pallas
    ``bf_relax`` contract.  dist [S,J,z] f32, adj [S,z,z] f32,
    spur_onehot/banned_next [S,J,z] bool, cap [S,J] f32 → [S,J,z] f32."""
    S, J, z = dist.shape
    dev = dist.device
    _check("dist", dist, torch.float32, (S, J, z), dev)
    _check("adj", adj, torch.float32, (S, z, z), dev)
    _check("spur_onehot", spur_onehot, torch.bool, (S, J, z), dev)
    _check("banned_next", banned_next, torch.bool, (S, J, z), dev)
    _check("cap", cap, torch.float32, (S, J), dev)
    out = torch.empty_like(dist)
    if S == 0 or J == 0 or z == 0:
        return out
    jt = tile_width(J, z, step_smem)
    with torch.cuda.device(dev):
        err = _lib().bf_relax_step(
            dist.data_ptr(), adj.data_ptr(), spur_onehot.data_ptr(),
            banned_next.data_ptr(), cap.data_ptr(), out.data_ptr(),
            S, J, z, jt, torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on(err, "bf_relax_step")
    return out


def solve_grouped(adj, init, banned_v, spur_onehot, banned_next, cap):
    """Launch ``bf_solve_grouped``: the whole masked grouped fixed point
    plus parents in one kernel.

    adj [S,z,z] f32, init [S,J,z] f32, banned_v/spur_onehot/banned_next
    [S,J,z] bool, cap [S,J] f32 → (dist [S,J,z] f32, parents [S,J,z]
    int32, iters [S, ceil(J/jt)] int32: the relaxations each block ran,
    at most z, the reference's iteration cap)."""
    S, z, _ = adj.shape
    J = init.shape[1]
    dev = adj.device
    _check("adj", adj, torch.float32, (S, z, z), dev)
    _check("init", init, torch.float32, (S, J, z), dev)
    for name, m in (("banned_v", banned_v), ("spur_onehot", spur_onehot),
                    ("banned_next", banned_next)):
        _check(name, m, torch.bool, (S, J, z), dev)
    _check("cap", cap, torch.float32, (S, J), dev)
    jt = tile_width(J, z, solve_smem)
    dist = torch.empty_like(init)
    parent = torch.empty((S, J, z), dtype=torch.int32, device=dev)
    iters = torch.empty((S, -(-J // jt)), dtype=torch.int32, device=dev)
    if S == 0 or J == 0 or z == 0:
        return dist, parent, iters
    with torch.cuda.device(dev):
        err = _lib().bf_solve_grouped(
            adj.data_ptr(), init.data_ptr(), banned_v.data_ptr(),
            spur_onehot.data_ptr(), banned_next.data_ptr(), cap.data_ptr(),
            dist.data_ptr(), parent.data_ptr(), iters.data_ptr(),
            S, J, z, z, jt, torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on(err, "bf_solve_grouped")
    return dist, parent, iters
