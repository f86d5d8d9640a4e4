// Representative walks of the bounding-path levels for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package rebuilds each walk on the host, one
// call per (source, target, level) (src/repro/core/bounding.py,
// `extract_level_path`), and so did the port until its index build moved to
// the card.  This kernel rebuilds every walk of a build in one launch, from
// the levels `ktrop_solve` leaves on the card.
//
//   level_walks_kernel  for each walk w of slab row s (a boundary source of
//                       subgraph g = row_sub[s]): the walk from row_src[s]
//                       to walk_dst[w] of total weight walk_level[w], found
//                       backwards from the target as the host does it.
//
// The host's rule, step by step (`extract_level_path`): at vertex v with
// remainder `need`, scan v's in-edges u->v in ascending half-edge order; a
// step is possible where rem = need - w >= 0 and rem is one of u's levels;
// the step with the smallest rem wins, the first such step a tie.  No
// possible step, or a step onto a vertex the walk has seen, means the level
// has no simple representative (length 0 out).  The walk ends at the source
// with nothing left; it fails once it holds more than row_max_len[s]
// vertices.  Each step's edge id is given by in_eid, which the caller fills
// with `_path_edge_ids`'s rule (the first CSR half-edge u->v).
//
// Exactness.  The levels are sums of integer vfrag counts below 2^24, so
// every value, remainder and comparison is exact in f32 and the host's 1e-9
// tolerances are equalities here: the walk, its vertices and its edges are
// the host's, bit for bit.
//
// Layout.  One block per row.  The row's levels D[s] ([k][z] f32) and its
// subgraph's in-edge table (offsets, sources, weights, edge ids) are staged
// in shared memory (a road subgraph: about 5 KiB); the launch is refused
// where they do not fit (the launcher raises first).  One thread per walk,
// the block striding over the row's walks.  The seen set is a bitmask of
// ceil(z/32) words in registers (NW is a template parameter, so the words
// stay unrolled).  A thread writes its walk target-first into its own row of the
// [W, z] outputs (a simple walk has at most z vertices) and reverses it in
// place at the end.
//
// What bounds it.  Nothing of the card's peaks: a walk is a chain of
// dependent steps (a few in-edges, a few level compares each) and the bytes
// are the staged inputs plus the written walks, some tens of MB at the
// index-build shape.  The launch is latency-bound by the longest walk of a
// row; at ~22 walks a row, one block holds them all in flight.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;
constexpr int kSmemLimit = 232448;  // dynamic shared memory of one block

template <int NW>
__device__ __forceinline__ void seen_add(uint32_t (&seen)[NW], int v) {
  const int word = v >> 5;
  const uint32_t bit = 1u << (v & 31);
#pragma unroll
  for (int i = 0; i < NW; ++i)
    if (i == word) seen[i] |= bit;
}

template <int NW>
__device__ __forceinline__ bool seen_has(const uint32_t (&seen)[NW], int v) {
  const int word = v >> 5;
  const uint32_t bit = 1u << (v & 31);
  bool hit = false;
#pragma unroll
  for (int i = 0; i < NW; ++i)
    if (i == word) hit = (seen[i] & bit) != 0u;
  return hit;
}

// Is x one of u's levels (ascending, INF padded)?
__device__ __forceinline__ bool is_level(const float* du, int k, int z,
                                         float x) {
  for (int j = 0; j < k; ++j) {
    const float d = du[j * z];
    if (d == x) return true;
    if (d > x) return false;
  }
  return false;
}

size_t staged_smem(int k, int z, int h_max) {
  return (size_t)k * z * 4 + (size_t)(z + 1) * 4 + (size_t)h_max * 12;
}

template <int NW>
__global__ void __launch_bounds__(kThreads) level_walks_kernel(
    const float* __restrict__ D, const int32_t* __restrict__ row_sub,
    const int32_t* __restrict__ row_src,
    const int32_t* __restrict__ row_max_len,
    const int32_t* __restrict__ in_ptr, const int32_t* __restrict__ in_src,
    const float* __restrict__ in_w, const int32_t* __restrict__ in_eid,
    const int32_t* __restrict__ walk_ptr,
    const int32_t* __restrict__ walk_dst,
    const float* __restrict__ walk_level, int32_t* __restrict__ verts,
    int32_t* __restrict__ eids, int32_t* __restrict__ n_out, int k, int z) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int s = blockIdx.x;
  const int w_lo = walk_ptr[s], w_hi = walk_ptr[s + 1];
  if (w_lo == w_hi) return;  // the whole block leaves together
  const int src = row_src[s];
  const int max_len = row_max_len[s];
  const int32_t* gp = in_ptr + (size_t)row_sub[s] * (z + 1);
  const float* Dg = D + (size_t)s * k * z;
  // stage D[s], then the offsets from the slice's start, then the slice
  const int base = gp[0];
  const int h = gp[z] - base;
  float* Ds = reinterpret_cast<float*>(smem);
  int32_t* ptr = reinterpret_cast<int32_t*>(Ds + k * z);
  int32_t* u_of = ptr + z + 1;
  float* w_of = reinterpret_cast<float*>(u_of + h);
  int32_t* e_of = reinterpret_cast<int32_t*>(w_of + h);
  for (int i = threadIdx.x; i < k * z; i += blockDim.x) Ds[i] = Dg[i];
  for (int i = threadIdx.x; i <= z; i += blockDim.x) ptr[i] = gp[i] - base;
  for (int i = threadIdx.x; i < h; i += blockDim.x) {
    u_of[i] = in_src[base + i];
    w_of[i] = in_w[base + i];
    e_of[i] = in_eid[base + i];
  }
  __syncthreads();

  for (int w = w_lo + threadIdx.x; w < w_hi; w += blockDim.x) {
    int32_t* vo = verts + (size_t)w * z;
    int32_t* eo = eids + (size_t)w * z;
    uint32_t seen[NW];
#pragma unroll
    for (int i = 0; i < NW; ++i) seen[i] = 0u;
    int v = walk_dst[w];
    float need = walk_level[w];
    seen_add<NW>(seen, v);
    vo[0] = v;
    int n = 1;
    bool simple = true;
    while (v != src || need > 0.0f) {
      int best_u = -1, best_p = 0;
      float best_rem = 0.0f;
      for (int p = ptr[v]; p < ptr[v + 1]; ++p) {
        const float rem = __fsub_rn(need, w_of[p]);
        if (rem < 0.0f) continue;
        const int u = u_of[p];
        if (!is_level(Ds + u, k, z, rem)) continue;
        if (best_u < 0 || rem < best_rem) {
          best_u = u;
          best_rem = rem;
          best_p = p;
        }
      }
      if (best_u < 0 || seen_has<NW>(seen, best_u)) {
        simple = false;
        break;
      }
      seen_add<NW>(seen, best_u);
      vo[n] = best_u;  // n < z: every vertex written so far is distinct
      eo[n - 1] = e_of[best_p];
      ++n;
      need = best_rem;
      v = best_u;
      if (n > max_len) {
        simple = false;
        break;
      }
    }
    if (!simple) {
      n_out[w] = 0;
      continue;
    }
    for (int i = 0, j = n - 1; i < j; ++i, --j) {  // source first
      const int32_t t = vo[i];
      vo[i] = vo[j];
      vo[j] = t;
    }
    for (int i = 0, j = n - 2; i < j; ++i, --j) {
      const int32_t t = eo[i];
      eo[i] = eo[j];
      eo[j] = t;
    }
    n_out[w] = n;
  }
}

template <int NW>
cudaError_t launch(const float* D, const int32_t* row_sub,
                   const int32_t* row_src, const int32_t* row_max_len,
                   const int32_t* in_ptr, const int32_t* in_src,
                   const float* in_w, const int32_t* in_eid,
                   const int32_t* walk_ptr, const int32_t* walk_dst,
                   const float* walk_level, int32_t* verts, int32_t* eids,
                   int32_t* n_out, int S, int k, int z, int h_max,
                   cudaStream_t stream) {
  const size_t smem = staged_smem(k, z, h_max);
  if (smem > (size_t)kSmemLimit) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      level_walks_kernel<NW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  level_walks_kernel<NW><<<S, kThreads, smem, stream>>>(
      D, row_sub, row_src, row_max_len, in_ptr, in_src, in_w, in_eid,
      walk_ptr, walk_dst, walk_level, verts, eids, n_out, k, z);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// All pointers are device pointers to contiguous tensors: D [S,k,z] f32
// (each row's levels, ascending, INF padded); row_sub, row_src, row_max_len
// [S] int32; in_ptr [G,z+1] int32 (the in-edges of v in subgraph g are
// entries in_ptr[g,v] to in_ptr[g,v+1] of in_src/in_w/in_eid, ascending
// half-edge order); walk_ptr [S+1] int32 (row s owns walks walk_ptr[s] to
// walk_ptr[s+1]); walk_dst [W] int32, walk_level [W] f32; outputs verts and
// eids [W,z] int32 (the first n and n-1 entries) and n [W] int32 (0: no
// simple walk).  h_max is the most in-edges of one subgraph; z <= 32 * 32,
// and k*z*4 + (z+1)*4 + h_max*12 bytes (the staged tables) <= kSmemLimit.
// Returns cudaGetLastError() after the launch (0 = launched).
int level_walks(const void* D, const void* row_sub, const void* row_src,
                const void* row_max_len, const void* in_ptr,
                const void* in_src, const void* in_w, const void* in_eid,
                const void* walk_ptr, const void* walk_dst,
                const void* walk_level, void* verts, void* eids, void* n_out,
                int S, int k, int z, int h_max, void* stream) {
#define LW_LAUNCH(NW_)                                                       \
  launch<NW_>((const float*)D, (const int32_t*)row_sub,                      \
              (const int32_t*)row_src, (const int32_t*)row_max_len,          \
              (const int32_t*)in_ptr, (const int32_t*)in_src,                \
              (const float*)in_w, (const int32_t*)in_eid,                    \
              (const int32_t*)walk_ptr, (const int32_t*)walk_dst,            \
              (const float*)walk_level, (int32_t*)verts, (int32_t*)eids,     \
              (int32_t*)n_out, S, k, z, h_max, (cudaStream_t)stream)
  const int words = (z + 31) / 32;
  if (words <= 1) return (int)LW_LAUNCH(1);
  if (words <= 2) return (int)LW_LAUNCH(2);
  if (words <= 4) return (int)LW_LAUNCH(4);
  if (words <= 8) return (int)LW_LAUNCH(8);
  if (words <= 16) return (int)LW_LAUNCH(16);
  if (words <= 32) return (int)LW_LAUNCH(32);
#undef LW_LAUNCH
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
