"""The yardstick for kernel roofline shares: a frozen table of peaks and
the bytes a kernel call must move, counted from its shapes.

Rates are NVIDIA's H100 SXM data sheet: 3.35 TB/s of HBM3, and the
float32 add / min issue rate of 132 SMs x 128 lanes at the boost clock
(33.5e12 op/s), the rate the program's own ``launch/roofline.py`` uses
for min-plus work.  They assume the card's full power limit of 700 W;
the run prints the card's limit beside the share.
"""

from __future__ import annotations

#: peaks by ``torch.cuda.get_device_name()``
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12,
                              "minplus_ops_per_s": 33.5e12},
}


def bf_solve_grouped_bytes(S: int, J: int, z: int) -> int:
    """Bytes one ``bf_solve_grouped`` call must move: each input read once
    (adjacency [S,z,z] f32, initial distances [S,J,z] f32, three [S,J,z]
    bool masks, caps [S,J] f32) and each output written once (distances
    [S,J,z] f32, parents [S,J,z] i32, and at least one i32 iteration count
    and one path flag per row).  The min-plus work depends on the data
    (iterations to the fixed point, edges per row) and is not counted, so
    the bound is a lower bound on the call's time."""
    n = S * J * z
    return 4 * S * z * z + 4 * n + 3 * n + 4 * S * J + 8 * n + 8 * S


def bound_s(kind: str, n_bytes: float) -> float | None:
    """Least seconds ``n_bytes`` take at the card's HBM rate (None for a
    card the table does not know)."""
    peak = PEAKS.get(kind)
    if peak is None:
        return None
    return n_bytes / peak["hbm_bytes_per_s"]
