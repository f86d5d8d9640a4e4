"""Slab geometry in one place: every layout decision a solver backend
imposes on the [S, J, z] grouped-solve data plane.

Before this module, layout knowledge was scattered as constants across
four layers: ``pack_subgraphs`` hard-coded its lane default, the dense
worker overrode it with ``lane=8``, ``dist.grouped_yen`` owned the
hot-row ``_bucket_shape`` packing, and the Pallas kernels asserted their
own ``z % 128`` alignment.  The jnp and Pallas solvers genuinely want
*different* geometry — jnp relaxation compute is O(z²) per problem so a
tight lane (8) minimizes padded work, while the Pallas kernels block on
the TPU lane tile (z % 128 == 0) and the f32 sublane tile (J % 8 == 0)
with a VMEM-bounded J — so geometry must be a *backend property*, not a
constant.  A :class:`SlabLayout` packages it:

* ``lane`` — z-alignment of packed ``[S, z, z]`` slabs;
* ``j_align``/``j_max`` — alignment and VMEM bound of the J (problems
  per slab row) axis of a grouped solve bucket;
* ``bucket_shape`` — the hot-row packing rule: pick the [S_pad, J_pad]
  bucket minimizing padded area, splitting rows with more jobs than
  J_pad across duplicate slab rows;
* ``pack_round`` — materialize one round's jobs into FRESH scratch
  buffers (adjacency rows copied, never aliased), which is what makes
  ``jax.jit(donate_argnums=...)`` buffer donation safe: a donated round
  buffer can be consumed by the solve without invalidating the worker's
  persistent slab.

``repro.engine.backend.SolverBackend`` carries one; everything else
(cluster slab packing, the grouped-Yen round packer) reads geometry from
the backend's layout instead of hard-coding it.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["SlabLayout", "PLAIN_LAYOUT", "HOPPER_LAYOUT", "TRANSFER_STATS",
           "reset_transfer_stats"]

# matches engine.dense.INF (finite "infinity" keeps min-plus NaN-free)
# without importing jax here — layout is pure-host geometry
_INF = float(3.0e38)

# adjacency-staging counters: how many rounds copied slab rows on the
# host (→ a host→device transfer per dispatch) vs gathered them from a
# device-resident mirror.  The device-residency acceptance test asserts
# host_rounds stays 0 on the steady-state query path.
TRANSFER_STATS = {"host_rounds": 0, "device_rounds": 0}


def reset_transfer_stats():
    TRANSFER_STATS["host_rounds"] = 0
    TRANSFER_STATS["device_rounds"] = 0


def _pow2(n: int) -> int:
    n = int(n)
    return 1 << (n - 1).bit_length() if n > 1 else 1


@dataclasses.dataclass(frozen=True)
class SlabLayout:
    """Geometry one solver backend imposes on packed slabs and buckets.

    ``lane``     z-alignment: packed slabs round z up to a multiple.
    ``j_align``  J-alignment of grouped-solve buckets (1 = none; the
                 Pallas kernels want the f32 sublane tile, 8).
    ``j_max``    upper bound on J per bucket (None = unbounded): rows
                 with more jobs split across duplicate slab rows, which
                 keeps the per-grid-step VMEM working set bounded.
    """

    name: str
    lane: int = 8
    j_align: int = 1
    j_max: int | None = None

    def __post_init__(self):
        if self.lane < 1 or self.j_align < 1:
            raise ValueError("lane and j_align must be ≥ 1")
        if self.j_max is not None and self.j_max % self.j_align:
            raise ValueError(
                f"j_max {self.j_max} must be a multiple of "
                f"j_align {self.j_align}"
            )

    def align_z(self, z: int) -> int:
        """Round a vertex count up to this layout's lane tile."""
        return int(self.lane * ((int(z) + self.lane - 1) // self.lane))

    def align_j(self, j: int) -> int:
        """Round a problem count up to this layout's J alignment."""
        a = self.j_align
        return int(a * ((int(j) + a - 1) // a))

    def bucket_shape(self, per_row_counts, s_multiple: int = 1):
        """Pick the [S_pad, J_pad] bucket minimizing padded area.

        A row with more jobs than ``J_pad`` is split across duplicate
        slab rows, so the padded problem count is Σ ceil(n_r / J) · J
        instead of n_rows · max(n_r) — without the split, one hot
        subgraph (the common case when many concurrent queries cross
        the same boundary region) inflates EVERY row to its
        pow2-rounded max and the merged batch costs more compute than
        the per-query solves it replaced.  Candidates stay pow2
        multiples of ``j_align`` capped at ``j_max``, and S a pow2
        multiple of ``s_multiple``, so shapes reuse jit buckets.
        """
        per_row_counts = [int(n) for n in per_row_counts]
        if not per_row_counts:
            raise ValueError("bucket_shape needs at least one row count")
        j_hi = self.align_j(_pow2(max(per_row_counts)))
        if self.j_max is not None:
            j_hi = min(j_hi, self.j_max)
        j_hi = max(j_hi, self.j_align)
        best = None
        j = self.j_align
        while j <= j_hi:
            s_need = sum(-(-n // j) for n in per_row_counts)
            s_pad = _pow2(s_need)
            if s_pad % s_multiple:
                s_pad = -(-s_pad // s_multiple) * s_multiple
            # padded relax compute ∝ S·J; the +1 term charges the
            # [S, z, z] adjacency duplication/transfer that row-splitting
            # adds
            cost = s_pad * (j + 1)
            if best is None or cost < best[0]:
                best = (cost, s_pad, j)
            j *= 2
        _, s_pad, j_pad = best
        return s_pad, j_pad

    def pack_round(self, adj, jobs, s_multiple: int = 1, gather=None):
        """Pack one grouped-solve round's jobs into fresh device buffers.

        ``jobs``: [(slab_row, spur, banned_v bool[z], banned_next bool[z],
        cap)].  Returns ``((adj_used, init, bv, so, bn, cap), slots)``
        with ``slots[i]`` the packed (row, j) position of job ``i``; the
        bucket shape comes from :meth:`bucket_shape` (hot rows split
        across duplicate slab rows).

        ``gather`` (optional ``rows int32[S_pad] -> adj[S_pad, z, z]``)
        sources the round's adjacency from a DEVICE-RESIDENT slab mirror
        (``engine.dense.gather_slab_rows``) instead of copying rows on
        the host: the steady-state query path then transfers only the
        small init/mask buffers per dispatch, never the [S, z, z] slab.
        Layout stays jax-free — the callable owns all device specifics.

        Every returned array is a FRESH scratch buffer — adjacency rows
        are copied (or device-gathered) out of the persistent slab,
        never aliased — so a backend may hand them to a solver jitted
        with ``donate_argnums`` (the donated device buffers are consumed
        by the solve) without ever invalidating the worker's slab or a
        caller-held mask.  This is the donation-safety contract the
        async pipeline relies on: round buffers die with the round.
        (The adjacency argument itself is never donated.)
        """
        z = adj.shape[-1]
        counts: dict = {}
        for row, *_ in jobs:
            counts[row] = counts.get(row, 0) + 1
        S_pad, J_pad = self.bucket_shape(list(counts.values()), s_multiple)

        slab_rows: list[int] = []  # original slab row per packed position
        cursor: dict = {}  # row → [packed position, jobs filled there]
        slots = []
        for row, *_ in jobs:
            cur = cursor.get(row)
            if cur is None or cur[1] == J_pad:
                cur = [len(slab_rows), 0]
                slab_rows.append(row)
            slots.append((cur[0], cur[1]))
            cur[1] += 1
            cursor[row] = cur
        S_ = len(slab_rows)

        if gather is not None:
            # filler rows duplicate row 0; their problems stay all-INF
            rows = slab_rows + [slab_rows[0]] * (S_pad - S_)
            adj_used = gather(np.asarray(rows, np.int32))
            TRANSFER_STATS["device_rounds"] += 1
        else:
            adj_used = np.empty((S_pad, z, z), np.float32)
            adj_used[:S_] = adj[slab_rows]
            adj_used[S_:] = adj[slab_rows[0]]  # filler; problems stay all-INF
            TRANSFER_STATS["host_rounds"] += 1
        init = np.full((S_pad, J_pad, z), _INF, np.float32)
        bv = np.zeros((S_pad, J_pad, z), bool)
        so = np.zeros((S_pad, J_pad, z), bool)
        bn = np.zeros((S_pad, J_pad, z), bool)
        cap = np.full((S_pad, J_pad), _INF, np.float32)
        for (sr, j), (row, spur, banned_v, banned_next, job_cap) in zip(
                slots, jobs):
            init[sr, j, spur] = 0.0
            bv[sr, j] = banned_v
            so[sr, j, spur] = True
            bn[sr, j] = banned_next
            cap[sr, j] = job_cap
        return (adj_used, init, bv, so, bn, cap), slots


# The plain PyTorch grouped solvers want tight slabs: relaxation compute
# is O(z²) per problem, so padding 20-vertex subgraphs to z=128 costs ~40x
# the useful work.  J buckets are free-form pow2.
PLAIN_LAYOUT = SlabLayout(name="plain-tight", lane=8)

# The Hopper fused solve (csrc/bf_relax.cu) gives one thread to each output
# vertex, so z is aligned to the 32-thread warp; a block holds up to 32
# problems of one slab row (one bit each in the packed mask words), and J
# buckets in multiples of 8 keep the per-problem register tile unrolled.
HOPPER_LAYOUT = SlabLayout(name="hopper-cuda", lane=32, j_align=8, j_max=32)
