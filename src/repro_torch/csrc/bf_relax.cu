// Masked min-plus Bellman-Ford relaxation for Hopper (sm_90a), CUDA cores.
//
// Replaces the Pallas TPU kernel `bf_relax` (src/repro/kernels/bf_relax.py,
// `_bf_relax_kernel`) and the `lax.while_loop` that iterates it to a fixed
// point (`_pallas_grouped_solver`, src/repro/engine/backend.py), together
// with the parent recovery that follows it (`bf_parents_grouped`,
// src/repro/engine/dense.py).  Two kernels:
//
//   bf_relax_step_kernel     one relaxation with the Pallas contract:
//                            new[s,j,v] = min(dist[s,j,v],
//                                             min_u dist[s,j,u] + adj[s,u,v])
//                            where a term is cut if spur[s,j,u] && ban[s,j,v],
//                            then values > cap[s,j] become INF.  Any J, any z
//                            whose tiles fit in shared memory, general
//                            0/1 masks, any values.
//   bf_solve_grouped_kernel  the whole fixed point of the serving path: relax,
//                            cap clamp, banned-vertex re-mask and change test
//                            per iteration, at most max_iters iterations, then
//                            the parent epilogue.  The host never waits per
//                            iteration.
//
// Layout of the step kernel.  One block owns slab row s and a tile of JT
// problems of it (blockIdx.y walks the tiles of J).  One relaxation reads
// the row once, so the read of the adjacency (2.15 GB at the refine_dense
// shape, 0.64 ms at 3.35 TB/s) is its bound.  The row streams through
// shared memory in 4 KiB chunks, 3-8 in flight per block (row_stage.cuh:
// bulk copies on mbarriers, started before the tiles load), where a
// dependent load per (u, v) and thread kept about 3 KB in flight per SM.
// The block loads its tiles (distances [z][P] by cp.async, spur and ban
// words: bit j = problem j; each thread its columns) and
// checks the list's preconditions: each distance >= 0, under which
// skipping the entries adj >= INF keeps every byte, and each cap <= INF
// (in_edges.cuh).
// Where they hold (the sparse path), each thread appends the finite
// entries of its columns to the in-edge list as the chunks land (2% of
// the row on a road subgraph, 1,216 of 65,536 at z=256) and then relaxes
// its columns from the list, JT problems in registers: one add and one
// min per kept (u, v, j), where the dense scan spends them on all
// z^2*JT terms (98% of them non-edges).  A block that fails the
// preconditions runs the dense scan from the same staged chunks, one pass
// per blockDim columns with each thread's column's JT minima in registers
// (one pass at z <= 256); a block whose row has a column over the list's
// budget streams the row again that way.  The data chooses the path, per
// block, and both give the plain version's bytes; the launcher's `path`
// output reports it.  The list, not a per-warp test of each staged u: on
// a road row about 45% of (warp, u) pairs hold an edge, so a warp-uniform
// skip would still run the JT add+min on them, about 20 times the list's
// work.  What bounds it on the H100: blocks per SM and the latency of
// each block's own phases, not chunks in flight.  A block's tile loads,
// relaxation and stores overlap only with other blocks' streams, so the
// launcher picks the layout with the most blocks per SM (three at the
// refine_dense shape: 80 registers for the JT = 32 minima and about 75
// KiB of shared memory) over more stages (scripts/sweep_step_layouts.py
// times the alternatives); and the tiles load with every byte in flight:
// the distances by 4-byte cp.async, the masks as 32-bit words across the
// block where z % 4 == 0 (one byte per column and problem otherwise).
//
// Layout of the fused solve.  The block reads its adjacency row from device
// memory once and keeps the finite entries as a compact in-edge list in
// shared memory (in_edges.cuh: about 4.75 entries per vertex on a road
// subgraph, 1,216 of 65,536 at z=256).  Every iteration of the fixed point
// and the parent epilogue then run from the list: one add and one min per
// kept (u, v, j), where a dense scan spends them on all z^2*JT terms and
// rereads the 256 KiB row from L2/device memory each iteration.  Threads
// map to (v, j) pairs: a warp's lanes run along j, 32/JT vertices per warp
// when JT < 32 (serving buckets have J=8), so for one warp-uniform in-edge
// (u, w) the lanes read d[u][j] and add the same w; the cut is bit j of
// spur[u] & ban[v], and a vertex with no banned next hop (98% of them)
// takes a loop without the cut test, two in-edges per step.  The distance
// tiles are [z][P] with an odd pitch P = JT+1, so both that read and the
// tile's load and store, which run along v to be coalesced in device
// memory, are free of bank conflicts.  No per-problem register array is
// kept; the block runs up to 512 threads, two blocks per SM at the
// refine_dense shape (64 registers, about 102 KiB of shared memory each).
// A block whose row has a column over the list's budget, or whose inputs
// fail the list's checks (a negative weight or initial distance, a cap
// above INF, a NaN), runs the same mapping over every u, reading
// adj[s,u,v] from device memory (the dense loop).  What bounds it: not the single read of the row (2.15 GB at the
// refine_dense shape, 0.64 ms at 3.35 TB/s) but instruction issue, about
// 70 warp instructions per vertex group and iteration for 4.75 in-edges,
// and the per-iteration block barriers.
//
// Exactness.  Only f32 add, min and compare are used, so the order of the
// u-reduction does not change the result.  INF is the finite 3.0e38: INF+INF
// overflows to +inf and then loses every min, exactly as in the reference.
// The relaxation's accumulators start at INF, as the Pallas kernel's do
// (`best = INF`), so a relaxation never returns more than INF, even from a
// distance of +inf under a cap of +inf; the parent epilogue's minimum
// starts at +inf, as bf_parents_grouped's argmin over the candidates.  The
// parent tolerance test is built with __fsub_rn/__fmul_rn (and --fmad=false)
// so no contraction changes its rounding.  Stopping each block on its own
// change test gives the same bytes as the reference's global test: one
// relaxation of a block that did not decrease returns the same values again
// (monotone f32 add; values clamped by the cap stay clamped).  The fused
// solve's list skips the entries with adj >= INF; in_edges.cuh gives the
// argument that this keeps every byte (values, parents, iteration counts)
// given adj >= 0 and init >= 0.  The block checks both (the initial
// distances at tile load, with the caps <= INF, and the weights as the
// list is built) and runs its dense loop where one fails.
// Within a column the list is in ascending u, so the parent epilogue's
// strict < keeps the first index of the min, as the dense scan does.

#include <cuda_runtime.h>
#include <stdint.h>

#include "in_edges.cuh"
#include "row_stage.cuh"

#define BF_INF 3.0e38f

namespace {

__device__ __forceinline__ float pos_inf() { return __int_as_float(0x7f800000); }

// Both kernels keep their distance tiles as [z][P] with an odd pitch
// P (JT + 1, or 1 at JT = 1): the lanes of a warp that read d[u][0..JT)
// for one u, and those that read d[v][j] for consecutive v (the coalesced
// tile load and store), all hit distinct banks.
template <int JT>
__host__ __device__ constexpr int tile_pitch() { return JT > 1 ? JT + 1 : 1; }

// acc[j] = min(acc[j], d[u][j] + a) for the JT problems, the terms with
// bit j of `cut` (spur[u] & ban[v]) replaced by INF; du = d + u*P.
template <int JT>
__device__ __forceinline__ void relax_term(float (&acc)[JT], const float* du,
                                           uint32_t cut, float a) {
  if (cut == 0u) {
#pragma unroll
    for (int j = 0; j < JT; ++j) acc[j] = fminf(acc[j], __fadd_rn(du[j], a));
  } else {
#pragma unroll
    for (int j = 0; j < JT; ++j) {
      const float c = ((cut >> j) & 1u) ? BF_INF : __fadd_rn(du[j], a);
      acc[j] = fminf(acc[j], c);
    }
  }
}

// OR bit j of each nonzero mask byte m[j*z + v] into words[v], for the
// jn rows of a [jn][z] byte tile read as 32-bit words (z % 4 == 0, m
// 4-byte aligned): consecutive threads take consecutive words, so the
// loads are coalesced and independent; most bytes are 0 and cost no
// shared-memory atomic.
__device__ __forceinline__ void mask_words(const uint8_t* __restrict__ m,
                                           int jn, int z,
                                           uint32_t* words) {
  const int per_row = z / 4;
  const uint32_t* m4 = reinterpret_cast<const uint32_t*>(m);
  constexpr int kUnroll = 8;
  for (int w0 = threadIdx.x; w0 < jn * per_row; w0 += kUnroll * blockDim.x) {
    uint32_t x[kUnroll];
#pragma unroll
    for (int t = 0; t < kUnroll; ++t) {
      const int w = w0 + t * blockDim.x;
      x[t] = w < jn * per_row ? __ldg(m4 + w) : 0u;
    }
#pragma unroll
    for (int t = 0; t < kUnroll; ++t) {
      if (x[t] == 0u) continue;
      const int w = w0 + t * blockDim.x;
      const int j = w / per_row, v = 4 * (w - j * per_row);
#pragma unroll
      for (int b = 0; b < 4; ++b)
        if ((x[t] >> (8 * b)) & 0xffu) atomicOr(&words[v + b], 1u << j);
    }
  }
}

// Column v of the tile's output: min(old, the minima), values over the
// cap INF; out_t = out + the tile's first problem, stores along v.
template <int JT>
__device__ __forceinline__ void store_column(float* __restrict__ out_t,
                                             const float* d_sh,
                                             const float* cap_sh,
                                             const float (&acc)[JT], int z,
                                             int v, int jn) {
  constexpr int P = tile_pitch<JT>();
#pragma unroll
  for (int j = 0; j < JT; ++j) {
    if (j < jn) {
      float nw = fminf(d_sh[v * P + j], acc[j]);
      if (nw > cap_sh[j]) nw = BF_INF;
      out_t[(size_t)j * z + v] = nw;
    }
  }
}

// At most 256 threads and three blocks per SM (the refine_dense shape's
// shared memory, about 75 KiB a block, allows three).
template <int JT>
__global__ void __launch_bounds__(256, 3) bf_relax_step_kernel(
    const float* __restrict__ dist, const float* __restrict__ adj,
    const uint8_t* __restrict__ so, const uint8_t* __restrict__ bn,
    const float* __restrict__ cap, float* __restrict__ out,
    int32_t* __restrict__ path_out, int J, int z, int slots, int stages) {
  constexpr int P = tile_pitch<JT>();
  extern __shared__ __align__(16) unsigned char smem[];
  const RowStage st = row_stage_at(smem, stages);
  float* d_sh = reinterpret_cast<float*>(smem + row_stage_smem(stages));
  uint32_t* spur_sh = reinterpret_cast<uint32_t*>(d_sh + z * P);  // [z]
  uint32_t* ban_sh = spur_sh + z;                                 // [z]
  int* next_u = reinterpret_cast<int*>(ban_sh + z);               // [z]
  float* cap_sh = reinterpret_cast<float*>(next_u + z);           // [JT]
  const InEdgeList list(cap_sh + JT, z, slots);

  const int s = blockIdx.x;
  const int j0 = blockIdx.y * JT;
  const int jn = min(JT, J - j0);
  const size_t sj = ((size_t)s * J + j0) * z;
  const RowPlan plan = row_plan(adj + (size_t)s * z * z, z * z);
  unsigned uses = 0;
  row_init(st);
  row_begin(st, plan, uses);  // the row streams in while the tiles load

  // Tiles, each thread its columns v (loads coalesced along v; the thread
  // owns v's mask words, so no atomics).  The distances go straight to
  // shared memory by 4-byte cp.async, all JT of a column in flight at
  // once, while the mask bytes come through registers; then the list's
  // checks: every distance >= 0 and every cap <= INF, no NaN in either
  // (in_edges.cuh)
  int ok = 1;
  for (int j = threadIdx.x; j < JT; j += blockDim.x) {
    const float c = j < jn ? cap[(size_t)s * J + j0 + j] : BF_INF;
    cap_sh[j] = c;
    ok &= c <= BF_INF;
  }
  for (int v = threadIdx.x; v < z; v += blockDim.x) {
#pragma unroll
    for (int j = 0; j < JT; ++j) {
      if (j < jn)
        cp_async4(&d_sh[v * P + j], dist + sj + (size_t)j * z + v);
      else
        d_sh[v * P + j] = BF_INF;
    }
  }
  cp_async_commit();
  const bool words = z % 4 == 0 &&
                     ((reinterpret_cast<uintptr_t>(so + sj) |
                       reinterpret_cast<uintptr_t>(bn + sj)) & 3u) == 0;
  for (int v = threadIdx.x; v < z; v += blockDim.x) {
    uint32_t spur = 0u, ban = 0u;
    if (!words) {
#pragma unroll
      for (int j = 0; j < JT; ++j) {
        if (j < jn) {
          const size_t at = sj + (size_t)j * z + v;
          spur |= (so[at] ? 1u : 0u) << j;
          ban |= (bn[at] ? 1u : 0u) << j;
        }
      }
    }
    spur_sh[v] = spur;
    ban_sh[v] = ban;
    next_u[v] = 0;
    if (slots > 0) list.deg[v] = 0;
  }
  if (words) {  // 4 columns a load, every word of the tile in flight
    __syncthreads();
    mask_words(so + sj, jn, z, spur_sh);
    mask_words(bn + sj, jn, z, ban_sh);
  }
  cp_async_wait_all();  // this thread's distances landed
  for (int v = threadIdx.x; v < z; v += blockDim.x) {
#pragma unroll
    for (int j = 0; j < JT; ++j) ok &= d_sh[v * P + j] >= 0.0f;
  }
  bool sparse = __syncthreads_and(ok) && slots > 0;
  bool begun = true;  // the pass row_begin started above is unread

  // Where each column's minima come from: the list (sparse), or a dense
  // pass per blockDim columns, each thread's column in registers
  if (sparse) {  // one pass: the finite entries into the list
    if (z <= (int)blockDim.x) {  // a column a thread: its count in registers
      const int v = threadIdx.x;
      int u = 0, n = 0;
      row_stream(st, plan, uses, [&](const float* buf, int f0, int f1) {
        if (v < z) append_column(buf, f0, f1, z, slots, P, list, v, u, n);
      });
      if (v < z) list.deg[v] = n;
    } else {
      row_stream(st, plan, uses, [&](const float* buf, int f0, int f1) {
        append_in_edges(buf, f0, f1, z, slots, P, list, next_u);
      });
    }
    begun = false;
    int over = 0;
    for (int v = threadIdx.x; v < z; v += blockDim.x)
      over |= list.deg[v] > slots;
    sparse = !__syncthreads_or(over);  // a column over the budget: dense
  }
  for (int v = threadIdx.x; v < z; v += blockDim.x) {  // the list path
    if (!sparse) break;
    const uint32_t banb = ban_sh[v];
    float acc[JT];
#pragma unroll
    for (int j = 0; j < JT; ++j) acc[j] = BF_INF;
    const int n = list.deg[v];
    for (int i = 0; i < n; ++i) {
      const InEdge e = list.e[i * z + v];
      relax_term<JT>(acc, d_sh + e.at,
                     banb ? spur_sh[(unsigned)e.at / P] & banb : 0u, e.w);
    }
    store_column<JT>(out + sj, d_sh, cap_sh, acc, z, v, jn);
  }
  for (int v0 = 0; v0 < z && !sparse; v0 += blockDim.x) {  // dense passes
    if (!begun) {  // every thread is past the last pass's tail
      __syncthreads();
      row_begin(st, plan, uses);
      __syncthreads();
    }
    begun = false;
    const int v = v0 + threadIdx.x;
    const uint32_t banb = v < z ? ban_sh[v] : 0u;
    float acc[JT];
#pragma unroll
    for (int j = 0; j < JT; ++j) acc[j] = BF_INF;
    int u = 0;  // this thread's next source
    row_stream(st, plan, uses, [&](const float* buf, int f0, int f1) {
      if (v >= z) return;
      for (int f = u * z + v; f < f1; f += z, ++u)
        relax_term<JT>(acc, d_sh + u * P, spur_sh[u] & banb, buf[f - f0]);
    });
    if (v < z) store_column<JT>(out + sj, d_sh, cap_sh, acc, z, v, jn);
  }
  if (threadIdx.x == 0) path_out[(size_t)s * gridDim.y + blockIdx.y] = sparse;
}

// One term of the fused solve at in-edge e = (u*P, w): d[u][j] + w, or
// INF where the term is cut (bit j of ban[v], which `banj` holds, and bit
// j of spur[u]).
template <int JT>
__device__ __forceinline__ float solve_term(const float* d,
                                            const uint32_t* spur_sh, InEdge e,
                                            int j, bool banj) {
  constexpr int P = tile_pitch<JT>();
  return (banj && ((spur_sh[(unsigned)e.at / P] >> j) & 1u))
             ? BF_INF
             : __fadd_rn(d[e.at + j], e.w);
}

// One parent-epilogue candidate at vertex v from source u (its values at
// d + at): d[u][j] (INF at spur vertices) + w, kept in (best, arg) on a
// strict < so the first u of the min wins.  The diagonal is no hop.
__device__ __forceinline__ void parent_term(const float* d_at,
                                            const uint32_t* spur_sh, int u,
                                            int v, int j, float w,
                                            float& best, int& arg) {
  if (u == v) w = BF_INF;
  const float c = __fadd_rn(((spur_sh[u] >> j) & 1u) ? BF_INF : d_at[j], w);
  if (c < best) {
    best = c;
    arg = u;
  }
}

// At most 512 threads and two blocks per SM: the register cap (64) that
// keeps 32 warps resident at the refine_dense shape.
template <int JT>
__global__ void __launch_bounds__(512, 2) bf_solve_grouped_kernel(
    const float* __restrict__ adj, const float* __restrict__ init,
    const uint8_t* __restrict__ bv, const uint8_t* __restrict__ so,
    const uint8_t* __restrict__ bn, const float* __restrict__ cap,
    float* __restrict__ dist_out, int32_t* __restrict__ parent_out,
    int32_t* __restrict__ iters_out, int32_t* __restrict__ list_out, int J,
    int z, int max_iters, int slots) {
  constexpr int P = tile_pitch<JT>();
  extern __shared__ __align__(16) unsigned char smem[];
  float* d_cur = reinterpret_cast<float*>(smem);  // [z][P]
  float* d_nxt = d_cur + z * P;                   // [z][P]
  uint32_t* spur_sh = reinterpret_cast<uint32_t*>(d_nxt + z * P);  // [z]
  uint32_t* ban_sh = spur_sh + z;                                  // [z]
  uint32_t* bv_sh = ban_sh + z;                                    // [z]
  float* cap_sh = reinterpret_cast<float*>(bv_sh + z);             // [JT]
  float* dspur_sh = cap_sh + JT;                                   // [JT]
  int32_t* sidx_sh = reinterpret_cast<int32_t*>(dspur_sh + JT);    // [JT]
  const InEdgeList list(sidx_sh + JT, z, slots);

  const int s = blockIdx.x;
  const int j0 = blockIdx.y * JT;
  const int jn = min(JT, J - j0);
  const size_t sj = ((size_t)s * J + j0) * z;
  const float* adj_s = adj + (size_t)s * z * z;

  // Tiles, coalesced along v: dist0 = where(banned_v, INF, init), padding
  // problems INF; mask words (bit j = problem j) by all threads; and the
  // list's checks (in_edges.cuh): every initial distance >= 0 and every
  // cap <= INF, no NaN in either
  for (int v = threadIdx.x; v < z; v += blockDim.x)
    spur_sh[v] = ban_sh[v] = bv_sh[v] = 0u;
  int inputs_ok = 1;
  for (int j = threadIdx.x; j < JT; j += blockDim.x) {
    const float c = j < jn ? cap[(size_t)s * J + j0 + j] : BF_INF;
    cap_sh[j] = c;
    inputs_ok &= c <= BF_INF;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < JT * z; i += blockDim.x) {
    const int j = i / z, v = i - j * z;
    float d = BF_INF;
    if (j < jn) {
      const size_t at = sj + (size_t)j * z + v;
      const uint32_t bit = 1u << j;
      if (so[at]) atomicOr(&spur_sh[v], bit);
      if (bn[at]) atomicOr(&ban_sh[v], bit);
      if (bv[at]) atomicOr(&bv_sh[v], bit);
      else d = init[at];
    }
    d_cur[v * P + j] = d;
    inputs_ok &= d >= 0.0f;
  }
  // the one read of the row (which also checks every kept weight >= 0);
  // its closing barrier also publishes the tiles
  const bool use_list = build_in_edges(adj_s, z, slots, P, list, inputs_ok);

  // lane -> (v, j): lanes along j, 32/JT vertices per warp
  constexpr int G = 32 / JT;
  const int lane = threadIdx.x & 31;
  const int j = lane % JT;
  const int sub = lane / JT;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const int n_groups = (z + G - 1) / G;
  const float cap_j = cap_sh[j];

  int it = 0;
  while (it < max_iters) {
    int changed = 0;
    for (int g = warp; g < n_groups; g += n_warps) {
      const int v = g * G + sub;
      if (v >= z) continue;
      const uint32_t banb = ban_sh[v];
      float acc = BF_INF;
      if (use_list) {
        const InEdge* ev = list.e + v;
        const int n = list.deg[v];
        if (banb == 0u) {  // no term into v is cut: two in-edges per step
          int i = 0;
          for (; i + 2 <= n; i += 2) {
            const InEdge e0 = ev[i * z], e1 = ev[(i + 1) * z];
            acc = fminf(acc, fminf(__fadd_rn(d_cur[e0.at + j], e0.w),
                                   __fadd_rn(d_cur[e1.at + j], e1.w)));
          }
          if (i < n) {
            const InEdge e0 = ev[i * z];
            acc = fminf(acc, __fadd_rn(d_cur[e0.at + j], e0.w));
          }
        } else {
          const bool banj = (banb >> j) & 1u;
          for (int i = 0; i < n; ++i)
            acc = fminf(acc,
                        solve_term<JT>(d_cur, spur_sh, ev[i * z], j, banj));
        }
      } else {
        const bool banj = (banb >> j) & 1u;
        for (int u = 0; u < z; ++u)
          acc = fminf(acc, solve_term<JT>(
                               d_cur, spur_sh,
                               InEdge{u * P, __ldg(adj_s + (size_t)u * z + v)},
                               j, banj));
      }
      const float old = d_cur[v * P + j];
      float nw = fminf(old, acc);
      if (nw > cap_j) nw = BF_INF;            // cap clamp (Pallas kernel's)
      if ((bv_sh[v] >> j) & 1u) nw = BF_INF;  // banned-vertex re-mask
      d_nxt[v * P + j] = nw;
      changed |= (j < jn) && (nw < old);
    }
    ++it;
    const int any = __syncthreads_or(changed);
    float* t = d_cur;
    d_cur = d_nxt;
    d_nxt = t;
    if (!any) break;
  }

  // parent epilogue: the spur candidate of problem j is its first spur
  // vertex, d_spur its smallest spur distance (bf_parents_grouped)
  for (int jj = threadIdx.x; jj < JT; jj += blockDim.x) {
    float ds = BF_INF;
    int first = -1;
    for (int u = 0; u < z; ++u) {
      if ((spur_sh[u] >> jj) & 1u) {
        if (first < 0) first = u;
        ds = fminf(ds, d_cur[u * P + jj]);
      }
    }
    dspur_sh[jj] = ds;
    sidx_sh[jj] = first;
  }
  __syncthreads();

  int32_t* par_sh = reinterpret_cast<int32_t*>(d_nxt);  // [z][P], free now
  for (int g = warp; g < n_groups; g += n_warps) {
    const int v = g * G + sub;
    if (v >= z || j >= jn) continue;
    float best = pos_inf();
    int arg = 0;
    if (use_list) {  // in ascending u, as the dense scan
      const int n = list.deg[v];
      for (int i = 0; i < n; ++i) {
        const InEdge e = list.e[i * z + v];
        parent_term(d_cur + e.at, spur_sh, (unsigned)e.at / P, v, j, e.w,
                    best, arg);
      }
    } else {
      for (int u = 0; u < z; ++u)
        parent_term(d_cur + u * P, spur_sh, u, v, j,
                    __ldg(adj_s + (size_t)u * z + v), best, arg);
    }
    // no spur: the candidate is INF at index 0, as argmax of an all-false
    // mask gives in the reference
    const int si = sidx_sh[j];
    float sp = BF_INF;
    if (si >= 0 && !((ban_sh[v] >> j) & 1u)) {
      const float row = (si == v) ? BF_INF : __ldg(adj_s + (size_t)si * z + v);
      sp = __fadd_rn(dspur_sh[j], row);
    }
    if (sp < best) arg = si >= 0 ? si : 0;  // the spur wins only on a strict <
    best = fminf(best, sp);
    const float d = d_cur[v * P + j];
    const bool ok = fabsf(__fsub_rn(best, d)) <=
                    __fmul_rn(1e-6f, fmaxf(1.0f, fabsf(d)));
    const bool reached = d < BF_INF / 2.0f;
    const bool src = d <= 0.0f;
    par_sh[v * P + j] = (ok && reached && !src) ? arg : -1;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < jn * z; i += blockDim.x) {  // coalesced
    const int jj = i / z, v = i - jj * z;
    dist_out[sj + i] = d_cur[v * P + jj];
    parent_out[sj + i] = par_sh[v * P + jj];
  }
  if (threadIdx.x == 0) {
    iters_out[(size_t)s * gridDim.y + blockIdx.y] = it;
    list_out[(size_t)s * gridDim.y + blockIdx.y] = use_list;
  }
}

// The step kernel's shared memory: the staging ring, the distance tile
// [z][P], spur and ban words, next sources, caps and the in-edge list.
size_t step_smem(int jt, int z, int slots, int stages) {
  const int pitch = jt > 1 ? jt + 1 : 1;  // tile_pitch<JT>()
  return row_stage_smem(stages) + (size_t)z * pitch * 4 +
         3 * (size_t)z * 4 + (size_t)jt * 4 + in_edges_smem(z, slots);
}

size_t solve_smem(int jt, int z, int slots) {
  const int pitch = jt > 1 ? jt + 1 : 1;  // tile_pitch<JT>()
  return 2 * (size_t)z * pitch * 4 + 3 * (size_t)z * 4 + 3 * (size_t)jt * 4 +
         in_edges_smem(z, slots);
}

int block_threads(int z) {
  const int t = ((z + 31) / 32) * 32;
  return t < 256 ? t : 256;
}

// The fused solve's threads: one warp per group of 32/JT vertices, at most
// 16 warps, each taking the same number of groups.
int solve_threads(int jt, int z) {
  const int groups = (z + 32 / jt - 1) / (32 / jt);
  const int per_warp = (groups + 15) / 16;
  return 32 * ((groups + per_warp - 1) / per_warp);
}

template <int JT>
cudaError_t set_step_smem(size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(
      bf_relax_step_kernel<JT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(bf_relax_step_kernel<JT>,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

template <int JT>
int step_blocks_per_sm(int z, int slots, int stages) {
  const size_t smem = step_smem(JT, z, slots, stages);
  int blocks = 0;
  if (set_step_smem<JT>(smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, bf_relax_step_kernel<JT>, block_threads(z), smem) !=
          cudaSuccess)
    return -1;
  return blocks;
}

template <int JT>
cudaError_t launch_step(const float* dist, const float* adj, const uint8_t* so,
                        const uint8_t* bn, const float* cap, float* out,
                        int32_t* path, int S, int J, int z, int slots,
                        int stages, cudaStream_t stream) {
  const size_t smem = step_smem(JT, z, slots, stages);
  cudaError_t err = set_step_smem<JT>(smem);
  if (err != cudaSuccess) return err;
  dim3 grid(S, (J + JT - 1) / JT);
  bf_relax_step_kernel<JT><<<grid, block_threads(z), smem, stream>>>(
      dist, adj, so, bn, cap, out, path, J, z, slots, stages);
  return cudaGetLastError();
}

// Opt the fused solve into `smem` bytes per block and the largest
// shared-memory carveout, so that as many blocks share an SM as fit.
template <int JT>
cudaError_t set_solve_smem(size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(
      bf_solve_grouped_kernel<JT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(bf_solve_grouped_kernel<JT>,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

template <int JT>
int solve_blocks_per_sm(int z, int slots) {
  const size_t smem = solve_smem(JT, z, slots);
  int blocks = 0;
  if (set_solve_smem<JT>(smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, bf_solve_grouped_kernel<JT>, solve_threads(JT, z), smem) !=
          cudaSuccess)
    return -1;
  return blocks;
}

template <int JT>
cudaError_t launch_solve(const float* adj, const float* init, const uint8_t* bv,
                         const uint8_t* so, const uint8_t* bn, const float* cap,
                         float* dist, int32_t* parent, int32_t* iters,
                         int32_t* list, int S, int J, int z, int max_iters,
                         int slots, cudaStream_t stream) {
  const size_t smem = solve_smem(JT, z, slots);
  cudaError_t err = set_solve_smem<JT>(smem);
  if (err != cudaSuccess) return err;
  dim3 grid(S, (J + JT - 1) / JT);
  bf_solve_grouped_kernel<JT><<<grid, solve_threads(JT, z), smem, stream>>>(
      adj, init, bv, so, bn, cap, dist, parent, iters, list, J, z, max_iters,
      slots);
  return cudaGetLastError();
}

}  // namespace

#define BF_DISPATCH_JT(jt, call) \
  switch (jt) {                   \
    case 1: return call(1);       \
    case 2: return call(2);       \
    case 4: return call(4);       \
    case 8: return call(8);       \
    case 16: return call(16);     \
    case 32: return call(32);     \
    default: return (int)cudaErrorInvalidValue; \
  }

extern "C" {

// All pointers are device pointers to contiguous tensors: dist/out [S,J,z]
// f32, adj [S,z,z] f32 (any 4-byte aligned start), so/bn [S,J,z] bool (1
// byte), cap [S,J] f32; path [S, ceil(J/jt)] int32 (1 where the block
// relaxed from its in-edge list, 0 where it ran the dense scan).  `slots`
// is the list's slots per vertex (0: every block dense), `stages` the
// chunks in flight (4 to kRowMaxStages); z*z < 2^31.  Returns
// cudaGetLastError() after the launch (0 = launched).
int bf_relax_step(const void* dist, const void* adj, const void* so,
                  const void* bn, const void* cap, void* out, void* path,
                  int S, int J, int z, int jt, int slots, int stages,
                  void* stream) {
  if (stages < 1 || stages > kRowMaxStages) return (int)cudaErrorInvalidValue;
#define BF_STEP(JT_)                                                        \
  (int)launch_step<JT_>((const float*)dist, (const float*)adj,             \
                        (const uint8_t*)so, (const uint8_t*)bn,            \
                        (const float*)cap, (float*)out, (int32_t*)path, S, \
                        J, z, slots, stages, (cudaStream_t)stream)
  BF_DISPATCH_JT(jt, BF_STEP)
#undef BF_STEP
}

// Blocks of bf_relax_step that one SM holds at once for this tile width,
// z and list size (-1 if the query failed).
int bf_step_blocks_per_sm(int z, int jt, int slots, int stages) {
#define BF_SOCC(JT_) step_blocks_per_sm<JT_>(z, slots, stages)
  BF_DISPATCH_JT(jt, BF_SOCC)
#undef BF_SOCC
}

// The staged row read's layout (row_stage.cuh): 0 -> most stages, 1 ->
// floats per chunk, 2 -> bytes of the staging area at one stage; the
// launcher checks it.
int bf_row_stage(int what) {
  return what == 0 ? kRowMaxStages
                   : what == 1 ? kRowChunk : (int)row_stage_smem(1);
}

// adj [S,z,z] f32; init [S,J,z] f32; bv/so/bn [S,J,z] bool; cap [S,J] f32;
// outputs dist [S,J,z] f32, parent [S,J,z] int32, iters [S, ceil(J/jt)]
// int32 (iterations each block ran) and list [S, ceil(J/jt)] int32 (1 where
// the block ran from its in-edge list, 0 where it ran the dense loop).
// `slots` is the list's slots per vertex (0: no list).
int bf_solve_grouped(const void* adj, const void* init, const void* bv,
                     const void* so, const void* bn, const void* cap,
                     void* dist, void* parent, void* iters, void* list, int S,
                     int J, int z, int max_iters, int jt, int slots,
                     void* stream) {
#define BF_SOLVE(JT_)                                                       \
  (int)launch_solve<JT_>((const float*)adj, (const float*)init,            \
                         (const uint8_t*)bv, (const uint8_t*)so,           \
                         (const uint8_t*)bn, (const float*)cap,            \
                         (float*)dist, (int32_t*)parent, (int32_t*)iters,  \
                         (int32_t*)list, S, J, z, max_iters, slots,        \
                         (cudaStream_t)stream)
  BF_DISPATCH_JT(jt, BF_SOLVE)
#undef BF_SOLVE
}

// Blocks of bf_solve_grouped that one SM holds at once for this tile
// width, z and list size (-1 if the query failed).
int bf_solve_blocks_per_sm(int z, int jt, int slots) {
#define BF_OCC(JT_) solve_blocks_per_sm<JT_>(z, slots)
  BF_DISPATCH_JT(jt, BF_OCC)
#undef BF_OCC
}

}  // extern "C"
