"""Build the port's CUDA sources into shared libraries, at first use.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into its own shared
library with a plain C interface, loaded through :mod:`ctypes`.  No
PyTorch header is included, so a build takes seconds.  The library's
file name carries a hash of its source, the shared headers
(``csrc/*.cuh``) and the flags, so a changed source or header is never
served a stale build.  Builds go to ``repro_torch/build/`` (listed
in ``.gitignore``); :func:`build_all` starts one ``nvcc`` per source, all
at once.

It also holds what every launcher checks: :func:`check_tensor` before
a launch and :func:`check_launch` after it.  Nothing here runs at
import: the CPU-only test host has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build"

# dynamic shared memory one block may opt into on sm_90 (227 KiB)
SMEM_LIMIT = 232_448

#: slots per vertex of a fused solve's in-edge list (``csrc/in_edges.cuh``)
#: where shared memory allows: a road subgraph's in-degree, diagonal
#: included, stays far below it
EDGE_SLOTS = 16

#: the step kernels' staged row read (``csrc/row_stage.cuh``): floats per
#: chunk (one 1-D bulk copy each), chunks in flight per block (at least
#: ROW_STAGES, at most ROW_MAX_STAGES) and the bytes before the ring
ROW_CHUNK = 1024
ROW_STAGES = 3
ROW_MAX_STAGES = 8
ROW_RING = 128

#: in-edge slots per vertex a step block keeps before it trades slots for
#: blocks per SM (a road subgraph's in-degree, diagonal included, is <= 5)
STEP_MIN_SLOTS = 8

# shared memory of one SM on sm_90 (228 KiB), and what it keeps per block
SM_SMEM = 233_472
SM_SMEM_PER_BLOCK = 1024

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

#: per source: {"seconds": build time, "log": nvcc's output (ptxas -v:
#: registers, shared memory, spills)}; filled by the builds of this process
BUILD_INFO: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = Path("/usr/local/cuda/bin/nvcc")
    if fallback.exists():
        return str(fallback)
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "host with the CUDA toolkit")


def _target(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def edge_list_slots(base_smem: int, z: int) -> int:
    """Slots per vertex of the in-edge list a fused-solve block keeps in
    the shared memory left beside its ``base_smem`` bytes: at most
    :data:`EDGE_SLOTS` (and z), 0 when not one slot fits (every block then
    runs the dense loop).

    >>> edge_list_slots(71_040, 256), edge_list_slots(230_000, 256)
    (16, 0)
    """
    if z <= 0:
        return 0
    room = SMEM_LIMIT - base_smem - 8 - 4 * z  # alignment, degrees
    return max(0, min(EDGE_SLOTS, z, room // (8 * z)))


def edge_list_smem(base_smem: int, z: int) -> int:
    """Shared-memory bytes of that list (``in_edges_smem`` in the CUDA
    header): 8 bytes per slot, 4 bytes of degree per vertex and 8 of
    alignment."""
    slots = edge_list_slots(base_smem, z)
    return 8 + 4 * z + 8 * slots * z if slots else 0


def row_stage_smem(stages: int) -> int:
    """Shared-memory bytes of the staging area (``row_stage_smem`` in the
    CUDA header): barriers and head/tail buffer, then the ring of
    ``stages`` chunks."""
    return ROW_RING + stages * ROW_CHUNK * 4


def step_layout(other, z: int) -> tuple[int, int, int]:
    """(slots, stages, shared-memory bytes) of a step kernel's block whose
    arrays beside the ring take ``other(slots)`` bytes.  On the H100 the
    step kernels' time went with blocks per SM, not with chunks in flight
    (their tile loads and relaxations overlap only with other blocks), so:
    slots up to STEP_MIN_SLOTS first, then the most blocks per SM, then
    the most slots (up to EDGE_SLOTS and z), then the most stages, at
    least ROW_STAGES.  The bytes exceed SMEM_LIMIT only where nothing fits.

    >>> step_layout(lambda slots: 11_264 + 8 + 4 * 256 + 2048 * slots, 256)
    (10, 3, 45192)
    """
    best = (0, ROW_STAGES, other(0) + row_stage_smem(ROW_STAGES))
    best_key = None
    for slots in range(min(EDGE_SLOTS, z) + 1):
        for stages in range(ROW_STAGES, ROW_MAX_STAGES + 1):
            smem = other(slots) + row_stage_smem(stages)
            if smem > SMEM_LIMIT:
                continue
            key = (min(slots, STEP_MIN_SLOTS),
                   SM_SMEM // (smem + SM_SMEM_PER_BLOCK), slots, stages)
            if best_key is None or key > best_key:
                best, best_key = (slots, stages, smem), key
    return best


def check_row_size(z: int) -> None:
    """The step kernels index a row with int: z*z < 2^31."""
    if z * z >= 2 ** 31:
        raise ValueError(f"z={z}: the step kernels take z*z < 2^31")


def row_stage_plan(z: int, addr: int) -> dict:
    """How a step kernel's block reads its row of z*z f32 that starts at
    byte address ``addr`` (``row_plan`` in ``csrc/row_stage.cuh``): the
    ``head`` floats before the first 16-byte boundary and the ``tail``
    floats after the last whole 16 bytes by plain loads, the rest as
    ``chunks`` of (first float, floats), each one bulk copy from a 16-byte
    aligned address of a multiple of 16 bytes.

    >>> row_stage_plan(33, 4)
    {'head': 3, 'chunks': [(3, 1024), (1027, 60)], 'tail': 2}
    """
    if addr % 4:
        raise ValueError(f"an f32 row starts on 4 bytes, got address {addr}")
    n = z * z
    head = min(n, (-addr % 16) // 4)
    body = (n - head) // 4 * 4
    chunks = [(head + at, min(ROW_CHUNK, body - at))
              for at in range(0, body, ROW_CHUNK)]
    return {"head": head, "chunks": chunks, "tail": n - head - body}


def check_row_stage(lib, prefix: str) -> None:
    """Raise unless the library's staging layout (``<prefix>_row_stage``)
    is the one :func:`row_stage_plan` and the shared-memory sums assume."""
    fn = getattr(lib, f"{prefix}_row_stage")
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_int
    got = tuple(fn(i) for i in range(3))
    want = (ROW_MAX_STAGES, ROW_CHUNK, row_stage_smem(1))
    if got != want:
        raise RuntimeError(f"{prefix}: the CUDA row staging is {got}, the "
                           f"launcher assumes {want}")


def build_all() -> dict:
    """Compile every ``csrc/*.cu`` that has no current build, one ``nvcc``
    per source, all started together.  Returns ``{name: library path}``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    names = sorted(p.stem for p in CSRC.glob("*.cu"))
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        BUILD_INFO[name] = {"seconds": time.perf_counter() - t0, "log": log}
        if proc.returncode != 0:
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return {name: _target(name) for name in names}


@functools.cache
def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of ``csrc/<name>.cu``, built if needed."""
    path = _target(name)
    if not path.exists():
        path = build_all()[name]
    return ctypes.CDLL(str(path))


def check_tensor(name, t, dtype, shape, device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    the CUDA ``device``."""
    import torch

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


def check_launch(err: int, name: str) -> None:
    """Raise if a C launcher returned a CUDA error (a refused launch)."""
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
