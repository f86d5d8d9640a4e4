"""Launcher of the Hopper kernel in ``csrc/level_walk.cu``.

The kernel rebuilds, in one launch, every representative walk of the
bounding-path levels that ``ktrop_solve`` leaves on the card: the batch
form of ``core.bounding.extract_level_path``.  It replaces no TPU kernel
(the JAX package rebuilds each walk on the host).  Built and called like
``kernels/ktrop.py``: the launcher checks device, dtype, shape and
contiguity, allocates with ``torch.empty``, launches on PyTorch's current
stream without synchronising, and raises if the launch was refused.  The
public, counted wrapper is :func:`repro_torch.kernels.ops.level_walks`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ._build import SMEM_LIMIT, check_launch, check_tensor, library

#: the seen set is a register bitmask of at most 32 words
Z_MAX = 32 * 32


def staged_smem(k: int, z: int, h_max: int) -> int:
    """Shared memory of one block: a row's levels [k, z] f32 and its
    subgraph's in-edge table (z + 1 offsets, h_max sources, weights and
    edge ids)."""
    return 4 * k * z + 4 * (z + 1) + 12 * h_max


@functools.cache
def _lib():
    lib = library("level_walk")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.level_walks.argtypes = [P] * 14 + [I] * 4 + [P]
    lib.level_walks.restype = I
    return lib


def walks(D, row_sub, row_src, row_max_len, in_ptr, in_src, in_w, in_eid,
          walk_ptr, walk_dst, walk_level, h_max: int):
    """Launch ``level_walks``: D [S,k,z] f32; row_sub/row_src/row_max_len
    [S] int32; in_ptr [G,z+1] int32; in_src/in_eid [H] int32, in_w [H] f32;
    walk_ptr [S+1] int32; walk_dst [W] int32, walk_level [W] f32; h_max
    the most in-edges of one subgraph → (verts [W,z] int32, eids [W,z]
    int32, n [W] int32), as :func:`ref.level_walks_ref` (entries past a
    walk's end are not written)."""
    S, k, z = D.shape
    dev = D.device
    if z > Z_MAX:
        raise ValueError(f"level_walks keeps a walk's seen set in {Z_MAX // 32}"
                         f" words: z={z} is over {Z_MAX}")
    if staged_smem(k, z, h_max) > SMEM_LIMIT:
        raise ValueError(f"level_walks stages a row's levels and in-edges in "
                         f"shared memory: k={k}, z={z}, {h_max} in-edges need "
                         f"{staged_smem(k, z, h_max)} B, over {SMEM_LIMIT}")
    G, H, W = in_ptr.shape[0], in_src.shape[0], walk_dst.shape[0]
    check_tensor("D", D, torch.float32, (S, k, z), dev)
    for name, t in (("row_sub", row_sub), ("row_src", row_src),
                    ("row_max_len", row_max_len)):
        check_tensor(name, t, torch.int32, (S,), dev)
    check_tensor("in_ptr", in_ptr, torch.int32, (G, z + 1), dev)
    check_tensor("in_src", in_src, torch.int32, (H,), dev)
    check_tensor("in_w", in_w, torch.float32, (H,), dev)
    check_tensor("in_eid", in_eid, torch.int32, (H,), dev)
    check_tensor("walk_ptr", walk_ptr, torch.int32, (S + 1,), dev)
    check_tensor("walk_dst", walk_dst, torch.int32, (W,), dev)
    check_tensor("walk_level", walk_level, torch.float32, (W,), dev)
    verts = torch.empty((W, z), dtype=torch.int32, device=dev)
    eids = torch.empty_like(verts)
    n = torch.empty((W,), dtype=torch.int32, device=dev)
    if S == 0 or W == 0:
        return verts, eids, n
    with torch.cuda.device(dev):
        err = _lib().level_walks(
            D.data_ptr(), row_sub.data_ptr(), row_src.data_ptr(),
            row_max_len.data_ptr(), in_ptr.data_ptr(), in_src.data_ptr(),
            in_w.data_ptr(), in_eid.data_ptr(), walk_ptr.data_ptr(),
            walk_dst.data_ptr(), walk_level.data_ptr(), verts.data_ptr(),
            eids.data_ptr(), n.data_ptr(), S, k, z, int(h_max),
            torch.cuda.current_stream(dev).cuda_stream)
    check_launch(err, "level_walks")
    return verts, eids, n
