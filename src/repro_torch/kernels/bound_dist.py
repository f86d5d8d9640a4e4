"""Launchers of the Hopper kernels in ``csrc/bound_dist.cu``.

The port of the Pallas TPU kernel ``bound_dist`` (``repro/kernels/
bound_dist.py``).  The TPU kernel wants its queries pre-grouped by
subgraph; here :func:`group` does that on the card (a counting sort over
the S subgraphs, cut into work items of at most ``PER_ITEM`` queries of
one subgraph), and :func:`evaluate` runs the clip-sums, ``BATCH`` work
items at a time, from their profile rows staged in shared memory segment
by segment.  :func:`bound_dist` is both, on queries in any order.  Built
and called like ``kernels/bf_relax.py``; the public, counted wrapper is
:func:`repro_torch.kernels.ops.bound_dist`.  Nothing synchronises the
host; the grouping's scratch (counts, offsets, order, φ in bucket order,
work items: about 37 MB at the ``maintain`` shape) comes from
``torch.empty``/``torch.zeros``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ._build import check_launch, check_tensor, library

# The kernel's layout (kMaxQ, kRows, kSeg in ``csrc/bound_dist.cu``),
# known here without the library for sizing the grouping's scratch and the
# grid; :func:`_lib` refuses a library that disagrees.
#: queries per work item (the kernel's query slots per lane)
PER_ITEM = 64
#: work items an evaluation block takes at once, one lane each
BATCH = 8
#: profile entries per staged segment of a row
SEGMENT = 256


class Groups(NamedTuple):
    """The queries grouped by subgraph, as the evaluation reads them."""

    counts: torch.Tensor      # [S] int32: queries per subgraph
    offsets: torch.Tensor     # [S+1] int32: each bucket's first position
    order: torch.Tensor       # [B] int32: query ids in bucket order
    phi_sorted: torch.Tensor  # [B] f32: their φ, in bucket order
    item_off: torch.Tensor    # [S+1] int32: each subgraph's first work item
    items: torch.Tensor       # [max_items, 4] int32: each work item's
                              # subgraph, bucket positions [first, last)
                              # and the bits of its largest φ (f32)


def max_items(B: int, S: int, per_item: int) -> int:
    """An upper bound on the work items of B queries over S subgraphs,
    ``sum_s ceil(counts[s] / per_item)``, known without reading counts:
    every non-empty subgraph adds at most one partial item.

    >>> max_items(4_000_000, 122_880, 64), max_items(10, 5, 64)
    (185380, 5)
    """
    return min(B, min(S, B) + B // per_item)


@functools.cache
def _lib():
    lib = library("bound_dist")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.bound_dist_histogram.argtypes = [P, P, I, P]
    lib.bound_dist_scatter.argtypes = [P] * 5 + [I, P]
    lib.bound_dist_items.argtypes = [P] * 4 + [I] * 2 + [P]
    lib.bound_dist_eval.argtypes = [P] * 8 + [I] * 4 + [P]
    lib.bound_dist_blocks_per_sm.argtypes = []
    lib.bound_dist_layout.argtypes = [P]
    lib.bound_dist_layout.restype = None
    for fn in (lib.bound_dist_histogram, lib.bound_dist_scatter,
               lib.bound_dist_items, lib.bound_dist_eval,
               lib.bound_dist_blocks_per_sm):
        fn.restype = I
    layout = (ctypes.c_int * 3)()
    lib.bound_dist_layout(layout)
    if tuple(layout) != (PER_ITEM, BATCH, SEGMENT):
        raise RuntimeError(
            f"bound_dist: the library's layout (queries per item, items "
            f"per batch, segment) is {tuple(layout)}, the launcher's "
            f"{(PER_ITEM, BATCH, SEGMENT)}")
    return lib


@functools.cache
def blocks_per_sm(device_index: int) -> int:
    """Evaluation blocks one SM holds at once (the occupancy query)."""
    with torch.cuda.device(device_index):
        blocks = _lib().bound_dist_blocks_per_sm()
    if blocks <= 0:
        raise RuntimeError("bound_dist: the occupancy query failed")
    return blocks


def group(sub, phi, S: int) -> Groups:
    """Group B queries by subgraph on the card: sub [B] int32 (each in
    [0, S)), phi [B] f32 → :class:`Groups`.  The order inside a bucket
    varies from run to run (atomics); counts, offsets and work items do
    not."""
    dev = sub.device
    B = sub.shape[0]
    check_tensor("sub", sub, torch.int32, (B,), dev)
    check_tensor("phi", phi, torch.float32, (B,), dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib = _lib()
    counts = torch.zeros((S,), dtype=torch.int32, device=dev)
    offsets = torch.zeros((S + 1,), dtype=torch.int32, device=dev)
    item_off = torch.zeros_like(offsets)
    order = torch.empty((B,), dtype=torch.int32, device=dev)
    phi_sorted = torch.empty((B,), dtype=torch.float32, device=dev)
    items = torch.empty((max_items(B, S, PER_ITEM), 4), dtype=torch.int32,
                        device=dev)
    if B == 0 or S == 0:
        return Groups(counts, offsets, order, phi_sorted, item_off, items)
    with torch.cuda.device(dev):
        check_launch(lib.bound_dist_histogram(
            sub.data_ptr(), counts.data_ptr(), B, stream),
            "bound_dist histogram")
        torch.cumsum(counts, 0, dtype=torch.int32, out=offsets[1:])
        cursor = offsets[:-1].clone()
        check_launch(lib.bound_dist_scatter(
            sub.data_ptr(), phi.data_ptr(), cursor.data_ptr(),
            order.data_ptr(), phi_sorted.data_ptr(), B, stream),
            "bound_dist scatter")
        torch.cumsum(torch.div(counts + (PER_ITEM - 1), PER_ITEM,
                               rounding_mode="floor"),
                     0, dtype=torch.int32, out=item_off[1:])
        check_launch(lib.bound_dist_items(
            offsets.data_ptr(), item_off.data_ptr(), phi_sorted.data_ptr(),
            items.data_ptr(), S, items.shape[0], stream),
            "bound_dist items")
    return Groups(counts, offsets, order, phi_sorted, item_off, items)


def evaluate(w_sorted, n_sorted, cum_before, groups: Groups):
    """The clip-sums of the grouped queries → BD [B] f32, in the queries'
    own order: persistent blocks take batches of ``BATCH`` work items and
    stage their rows in segments of ``SEGMENT`` entries."""
    S, E = w_sorted.shape
    B = groups.order.shape[0]
    dev = w_sorted.device
    for name, t in (("w_sorted", w_sorted), ("n_sorted", n_sorted),
                    ("cum_before", cum_before)):
        check_tensor(name, t, torch.float32, (S, E), dev)
    # the parts of the grouping the kernel reads, made by group() for
    # these B queries over these S subgraphs
    for name, dtype, shape in (
            ("order", torch.int32, (B,)),
            ("phi_sorted", torch.float32, (B,)),
            ("item_off", torch.int32, (S + 1,)),
            ("items", torch.int32, (max_items(B, S, PER_ITEM), 4))):
        check_tensor(f"groups.{name}", getattr(groups, name), dtype, shape,
                     dev)
    out = torch.empty((B,), dtype=torch.float32, device=dev)
    if B == 0:
        return out
    if E == 0:
        return out.zero_()
    vec = E % 4 == 0 and all(t.data_ptr() % 16 == 0
                             for t in (w_sorted, n_sorted, cum_before))
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    grid = min(-(-groups.items.shape[0] // BATCH),
               blocks_per_sm(index) * sms)
    with torch.cuda.device(dev):
        err = _lib().bound_dist_eval(
            w_sorted.data_ptr(), n_sorted.data_ptr(), cum_before.data_ptr(),
            groups.order.data_ptr(), groups.phi_sorted.data_ptr(),
            groups.item_off.data_ptr(), groups.items.data_ptr(),
            out.data_ptr(), S, E, grid, int(vec),
            torch.cuda.current_stream(dev).cuda_stream)
    check_launch(err, "bound_dist")
    return out


def bound_dist(w_sorted, n_sorted, cum_before, sub, phi):
    """Launch ``bound_dist``: w_sorted/n_sorted/cum_before [S,E] f32 (an
    ascending unit-weight profile per subgraph), sub [B] int32 (each in
    [0, S), any order), phi [B] f32 → BD [B] f32.  Groups the queries
    (:func:`group`), then evaluates them (:func:`evaluate`)."""
    return evaluate(w_sorted, n_sorted, cum_before,
                    group(sub, phi, w_sorted.shape[0]))
