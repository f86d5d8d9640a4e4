// Compact in-edge list of one adjacency row, held in shared memory.
//
// Built from device memory by the fused fixed-point kernels
// (bf_solve_grouped in bf_relax.cu, ktrop_solve in ktrop.cu:
// build_in_edges), and from a staged row by the step kernels
// (append_in_edges).  A block owns slab row s and iterates a
// relaxation over adj[s] tens of times.  The row is z*z f32 (256 KiB at
// z=256) and does not fit in shared memory beside the distance tiles, but a
// road subgraph's row is about 98% INF (no edge).  So the block reads the
// dense row from device memory once, keeps only its finite entries, and
// runs every iteration (and the BF parent epilogue) from that list.
//
// Layout (ELL): for destination v, its in-edges (u, adj[s,u,v]) with
// adj < INF sit in slots i = 0 .. deg[v]-1 at e[i*z + v], in ascending u.
// A slot is 8 bytes, read with one load: the word offset of u's values in
// the kernel's distance tile (u * scale) and the weight.  The diagonal is
// kept when it is finite.  Plus 4 bytes of degree per vertex.  Per-vertex
// slots, not a prefix-summed CSC, so each thread fills its own column in
// one pass and the row is read from device memory exactly once; the price
// is that the budget is a column's in-degree (at most `slots`) rather than
// the row's total.  A block with a column over budget (or no room for any
// slot), or whose inputs fail the checks below, runs the dense loop over
// every u instead: the kernel's own data decides, and both loops give the
// plain version's bytes.
//
// Order.  Ascending u within a column is what the BF parent epilogue needs:
// its argmin keeps the first index of the min (engine/dense.py,
// bf_parents_grouped), so two in-edges that tie must be visited in u order.
// Min and the k-distinct set do not depend on order.
//
// Why skipping adj >= INF keeps the bytes.  Precondition: the distances
// (levels) are >= 0, +inf included.  A skipped term is then d[u] + adj >=
// INF (a cut term is INF).  A BF relaxation's minimum starts at INF, as the
// Pallas kernel's accumulator does, so such a term never changes it: the
// values, the change test and the iteration counts agree with the dense
// scan's.  In the parent epilogue a skipped term (>= INF) can never be the
// argmin of a reached v, whose kept minimum lies within 1e-6 of dist <
// INF/2; an unreached v gets -1 either way.  For ktrop a candidate >= INF
// is never inserted into the k-list, so a skipped entry never changes it.
// The argument reads adj only at the skipped entries (adj >= INF, or NaN,
// whose terms lose every fminf and are never inserted either way).
//
// Who checks what.  One relaxation needs d >= 0 (no NaN), which the step
// kernels check per block on their input; a negative entry is finite and
// stays in the list.  The fused solves iterate: a negative weight can push
// a distance below zero mid-solve, after which d[u] + INF < INF and a
// skipped term could win.  So bf_solve_grouped checks its initial
// distances (>= 0, no NaN) at tile load (ktrop_solve's D0 is 0 and INF),
// and build_in_edges checks every kept weight for >= 0 in both; a block
// where a check fails runs its dense loop, as a block with a column over
// the list's budget does, and reports it (list_out).  The BF kernels also
// send a block with a cap above INF (or NaN) to the dense loop: with the
// minimum starting at INF the list would keep those bytes too (a minimum
// starting at +inf would not), and the check costs one compare per cap.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define IE_INF 3.0e38f

struct __align__(8) InEdge {
  int at;   // u * scale: where source u's values start
  float w;  // adj[s,u,v]
};

// The list's place in dynamic shared memory, from the first free byte:
// the slots [slots][z] (8-byte aligned), then the degrees [z].
struct InEdgeList {
  InEdge* e;
  int* deg;
  __device__ InEdgeList(void* free, int z, int slots) {
    e = reinterpret_cast<InEdge*>((reinterpret_cast<uintptr_t>(free) + 7) &
                                  ~uintptr_t(7));
    deg = reinterpret_cast<int*>(e + (size_t)slots * z);
  }
};

// Build the in-edge list of adj_s ([z][z] f32, device memory) into `list`
// (shared memory), with at = u * scale.  Each thread fills the columns
// v = tid, tid + blockDim, ...; for one u a warp's loads are consecutive in
// v (coalesced).  Ends with a block barrier and returns, on every thread,
// whether the list may replace the row: every thread's `ok` (its own
// checks of the block's other inputs) held, every kept weight is >= 0 and
// every column fit (false also when slots == 0: the row is then not read
// at all, nor by a thread whose `ok` failed).
__device__ __forceinline__ bool build_in_edges(const float* __restrict__ adj_s,
                                               int z, int slots, int scale,
                                               InEdgeList list,
                                               bool ok = true) {
  constexpr int kUnroll = 16;  // loads in flight per thread
  int over = slots <= 0 || !ok;
  if (!over) {
    for (int v = threadIdx.x; v < z; v += blockDim.x) {
      int n = 0;
      for (int u0 = 0; u0 < z; u0 += kUnroll) {
        float a[kUnroll];
#pragma unroll
        for (int t = 0; t < kUnroll; ++t)
          a[t] = u0 + t < z ? __ldg(adj_s + (size_t)(u0 + t) * z + v) : IE_INF;
#pragma unroll
        for (int t = 0; t < kUnroll; ++t) {
          if (a[t] < IE_INF) {
            over |= a[t] < 0.0f;  // a negative weight: the dense loop
            if (n < slots) list.e[n * z + v] = InEdge{(u0 + t) * scale, a[t]};
            ++n;
          }
        }
      }
      list.deg[v] = n;
      over |= n > slots;
    }
  }
  return !__syncthreads_or(over);
}

// The same list built from a row staged in shared memory (the step
// kernels, row_stage.cuh): append the finite entries of column v in the
// flat range [f0, f1) of the row (entry f = u*z + v at buf[f - f0]) to
// the list, from source u on, counting them in n.  The ranges are
// contiguous and ascending, so the column's next entry is u*z + v and its
// slots stay in ascending u.  Entries past `slots` are counted, not kept.
__device__ __forceinline__ void append_column(const float* buf, int f0,
                                              int f1, int z, int slots,
                                              int scale, InEdgeList list,
                                              int v, int& u, int& n) {
  for (int f = u * z + v; f < f1; f += z, ++u) {
    const float a = buf[f - f0];
    if (a < IE_INF) {
      if (n < slots) list.e[n * z + v] = InEdge{u * scale, a};
      ++n;
    }
  }
}

// append_column for the columns v = tid, tid + blockDim, ... of a block
// with fewer threads than columns: each column's degree and next source
// (next_u, [z] in shared memory) kept between ranges, set to 0 by the
// same thread before the first.  For one u the lanes read consecutive
// words (no bank conflict).
__device__ __forceinline__ void append_in_edges(const float* buf, int f0,
                                                int f1, int z, int slots,
                                                int scale, InEdgeList list,
                                                int* next_u) {
  for (int v = threadIdx.x; v < z; v += blockDim.x) {
    int u = next_u[v];
    if (u * z + v >= f1) continue;
    int n = list.deg[v];
    append_column(buf, f0, f1, z, slots, scale, list, v, u, n);
    list.deg[v] = n;
    next_u[v] = u;
  }
}

// Bytes of the list with `slots` per vertex (0 slots: no list at all),
// alignment padding included.
inline size_t in_edges_smem(int z, int slots) {
  return slots > 0 ? 8 + (size_t)z * 4 + (size_t)slots * z * 8 : 0;
}
