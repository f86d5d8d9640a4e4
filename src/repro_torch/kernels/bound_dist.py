"""Launcher of the Hopper kernel in ``csrc/bound_dist.cu``.

The port of the Pallas TPU kernel ``bound_dist`` (``repro/kernels/
bound_dist.py``), with a subgraph index per query rather than per
256-query block.  Built and called like ``kernels/bf_relax.py``; the
public, counted wrappers are in :mod:`repro_torch.kernels.ops`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ._build import check_launch, check_tensor, library


@functools.cache
def _lib():
    lib = library("bound_dist")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.bound_dist.argtypes = [P] * 6 + [I] * 2 + [P]
    lib.bound_dist.restype = I
    return lib


def bound_dist(w_sorted, n_sorted, cum_before, sub, phi):
    """Launch ``bound_dist``: w_sorted/n_sorted/cum_before [S,E] f32 (an
    ascending unit-weight profile per subgraph), sub [B] int32 (each in
    [0, S)), phi [B] f32 → BD [B] f32."""
    S, E = w_sorted.shape
    B = phi.shape[0]
    dev = w_sorted.device
    for name, t in (("w_sorted", w_sorted), ("n_sorted", n_sorted),
                    ("cum_before", cum_before)):
        check_tensor(name, t, torch.float32, (S, E), dev)
    check_tensor("sub", sub, torch.int32, (B,), dev)
    check_tensor("phi", phi, torch.float32, (B,), dev)
    out = torch.empty((B,), dtype=torch.float32, device=dev)
    if B == 0:
        return out
    with torch.cuda.device(dev):
        err = _lib().bound_dist(
            w_sorted.data_ptr(), n_sorted.data_ptr(), cum_before.data_ptr(),
            sub.data_ptr(), phi.data_ptr(), out.data_ptr(), B, E,
            torch.cuda.current_stream(dev).cuda_stream)
    check_launch(err, "bound_dist")
    return out
