// Masked min-plus Bellman-Ford relaxation for Hopper (sm_90a), CUDA cores.
//
// Replaces the Pallas TPU kernel `bf_relax` (src/repro/kernels/bf_relax.py,
// `_bf_relax_kernel`) and the `lax.while_loop` that iterates it to a fixed
// point (`_pallas_grouped_solver`, src/repro/engine/backend.py), together
// with the parent recovery that follows it (`bf_parents_grouped`,
// src/repro/engine/dense.py).  Two kernels share one relaxation routine:
//
//   bf_relax_step_kernel     one relaxation with the Pallas contract:
//                            new[s,j,v] = min(dist[s,j,v],
//                                             min_u dist[s,j,u] + adj[s,u,v])
//                            where a term is cut if spur[s,j,u] && ban[s,j,v],
//                            then values > cap[s,j] become INF.  Any z, any J,
//                            general 0/1 masks.
//   bf_solve_grouped_kernel  the whole fixed point of the serving path: relax,
//                            cap clamp, banned-vertex re-mask and change test
//                            per iteration, at most max_iters iterations, then
//                            the parent epilogue.  The host never waits per
//                            iteration.
//
// Layout.  One block owns slab row s and a tile of JT problems of it
// (blockIdx.y walks the tiles of J).  The tile's distances live in shared
// memory as [z][JT] (for one u, the JT values are contiguous and every
// thread of a warp reads the same address: a broadcast).  Each thread owns
// output vertices v = tid, tid + blockDim, ... and keeps one f32 accumulator
// per problem in registers.  The loop over u reads adj[s,u,v] from device
// memory, coalesced across the warp, once per iteration for all JT problems.
// Spur and ban masks are packed into 32-bit words (bit j = problem j), so the
// cut test is one AND per (u, v) and the common uncut case takes a loop with
// no per-problem test.
//
// What bounds it.  Min-plus has no tensor-core form: every (s, j, u, v) term
// is one FADD and one FMNMX on the CUDA cores.  At the refine_dense shape
// (S=8192, J=32, z=256) one iteration is S*J*z^2 = 17.2e9 add+min pairs
// against S*z^2*4 B = 2 GiB of adjacency, so the fixed point is bound by
// operations, not bytes: the JT-wide tile makes each adjacency element feed
// JT problems.  The adjacency row of one block (256 KiB at z=256) does not fit
// in shared memory next to the distance tiles; it is streamed from L2/device
// memory each iteration.  Staging u-tiles of it through TMA, and clusters
// that share them, are left for a later change.
//
// Exactness.  Only f32 add, min and compare are used, so the order of the
// u-reduction does not change the result.  INF is the finite 3.0e38: INF+INF
// overflows to +inf and then loses every min, exactly as in the reference.
// The accumulators start at +inf, as jnp.min over the candidates does.  The
// parent tolerance test is built with __fsub_rn/__fmul_rn (and --fmad=false)
// so no contraction changes its rounding.  Stopping each block on its own
// change test gives the same bytes as the reference's global test: one
// relaxation of a block that did not decrease returns the same values again
// (monotone f32 add; values clamped by the cap stay clamped).

#include <cuda_runtime.h>
#include <stdint.h>

#define BF_INF 3.0e38f

namespace {

__device__ __forceinline__ float pos_inf() { return __int_as_float(0x7f800000); }

// acc[j] = min over u of (d[u][j] + adj[u][v]), terms with bit j of
// (spur_sh[u] & ban_bits) set replaced by INF.
template <int JT>
__device__ __forceinline__ void relax_vertex(const float* __restrict__ adj_s,
                                             const float* d_sh,
                                             const uint32_t* spur_sh,
                                             uint32_t ban_bits, int z, int v,
                                             float (&acc)[JT]) {
#pragma unroll
  for (int j = 0; j < JT; ++j) acc[j] = pos_inf();
  for (int u = 0; u < z; ++u) {
    const float a = __ldg(adj_s + (size_t)u * z + v);
    const float* du = d_sh + u * JT;
    const uint32_t cut = spur_sh[u] & ban_bits;
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
}

// Shared-memory tile loads common to both kernels: distances of the tile
// ([z][JT], padding problems INF), packed spur words and caps.
template <int JT>
__device__ __forceinline__ void load_tile(const float* __restrict__ dist_sj,
                                          const uint8_t* __restrict__ so_sj,
                                          const float* __restrict__ cap_sj,
                                          const uint8_t* __restrict__ bv_sj,
                                          int jn, int z, float* d_sh,
                                          uint32_t* spur_sh, float* cap_sh) {
  for (int i = threadIdx.x; i < z * JT; i += blockDim.x) {
    const int u = i / JT, j = i % JT;
    float d = BF_INF;
    if (j < jn) {
      d = dist_sj[(size_t)j * z + u];
      if (bv_sj != nullptr && bv_sj[(size_t)j * z + u]) d = BF_INF;
    }
    d_sh[i] = d;
  }
  for (int u = threadIdx.x; u < z; u += blockDim.x) {
    uint32_t bits = 0u;
    for (int j = 0; j < jn; ++j)
      bits |= (so_sj[(size_t)j * z + u] ? 1u : 0u) << j;
    spur_sh[u] = bits;
  }
  for (int j = threadIdx.x; j < JT; j += blockDim.x)
    cap_sh[j] = j < jn ? cap_sj[j] : BF_INF;
}

__device__ __forceinline__ uint32_t pack_bits(const uint8_t* __restrict__ m_sj,
                                              int jn, int z, int v) {
  uint32_t bits = 0u;
  for (int j = 0; j < jn; ++j) bits |= (m_sj[(size_t)j * z + v] ? 1u : 0u) << j;
  return bits;
}

template <int JT>
__global__ void bf_relax_step_kernel(const float* __restrict__ dist,
                                     const float* __restrict__ adj,
                                     const uint8_t* __restrict__ so,
                                     const uint8_t* __restrict__ bn,
                                     const float* __restrict__ cap,
                                     float* __restrict__ out, int J, int z) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* d_sh = reinterpret_cast<float*>(smem);           // [z][JT]
  uint32_t* spur_sh = reinterpret_cast<uint32_t*>(d_sh + z * JT);  // [z]
  float* cap_sh = reinterpret_cast<float*>(spur_sh + z);  // [JT]

  const int s = blockIdx.x;
  const int j0 = blockIdx.y * JT;
  const int jn = min(JT, J - j0);
  const size_t sj = ((size_t)s * J + j0) * z;
  const float* adj_s = adj + (size_t)s * z * z;

  load_tile<JT>(dist + sj, so + sj, cap + (size_t)s * J + j0, nullptr, jn, z,
                d_sh, spur_sh, cap_sh);
  __syncthreads();

  for (int v = threadIdx.x; v < z; v += blockDim.x) {
    float acc[JT];
    relax_vertex<JT>(adj_s, d_sh, spur_sh, pack_bits(bn + sj, jn, z, v), z, v,
                     acc);
#pragma unroll
    for (int j = 0; j < JT; ++j) {
      if (j < jn) {
        float nw = fminf(d_sh[v * JT + j], acc[j]);
        if (nw > cap_sh[j]) nw = BF_INF;
        out[sj + (size_t)j * z + v] = nw;
      }
    }
  }
}

template <int JT>
__global__ void bf_solve_grouped_kernel(
    const float* __restrict__ adj, const float* __restrict__ init,
    const uint8_t* __restrict__ bv, const uint8_t* __restrict__ so,
    const uint8_t* __restrict__ bn, const float* __restrict__ cap,
    float* __restrict__ dist_out, int32_t* __restrict__ parent_out,
    int32_t* __restrict__ iters_out, int J, int z, int max_iters) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* d_cur = reinterpret_cast<float*>(smem);  // [z][JT]
  float* d_nxt = d_cur + z * JT;                  // [z][JT]
  uint32_t* spur_sh = reinterpret_cast<uint32_t*>(d_nxt + z * JT);  // [z]
  uint32_t* ban_sh = spur_sh + z;                                   // [z]
  uint32_t* bv_sh = ban_sh + z;                                     // [z]
  float* cap_sh = reinterpret_cast<float*>(bv_sh + z);              // [JT]
  float* dspur_sh = cap_sh + JT;                                    // [JT]
  int32_t* sidx_sh = reinterpret_cast<int32_t*>(dspur_sh + JT);     // [JT]

  const int s = blockIdx.x;
  const int j0 = blockIdx.y * JT;
  const int jn = min(JT, J - j0);
  const size_t sj = ((size_t)s * J + j0) * z;
  const float* adj_s = adj + (size_t)s * z * z;

  // dist0 = where(banned_v, INF, init)
  load_tile<JT>(init + sj, so + sj, cap + (size_t)s * J + j0, bv + sj, jn, z,
                d_cur, spur_sh, cap_sh);
  for (int v = threadIdx.x; v < z; v += blockDim.x) {
    ban_sh[v] = pack_bits(bn + sj, jn, z, v);
    bv_sh[v] = pack_bits(bv + sj, jn, z, v);
  }
  __syncthreads();

  int it = 0;
  while (it < max_iters) {
    int changed = 0;
    for (int v = threadIdx.x; v < z; v += blockDim.x) {
      float acc[JT];
      relax_vertex<JT>(adj_s, d_cur, spur_sh, ban_sh[v], z, v, acc);
      const uint32_t bvb = bv_sh[v];
#pragma unroll
      for (int j = 0; j < JT; ++j) {
        const float old = d_cur[v * JT + j];
        float nw = fminf(old, acc[j]);
        if (nw > cap_sh[j]) nw = BF_INF;   // cap clamp (in the Pallas kernel)
        if ((bvb >> j) & 1u) nw = BF_INF;  // banned-vertex re-mask
        d_nxt[v * JT + j] = nw;
        changed |= (j < jn) && (nw < old);
      }
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
  for (int j = threadIdx.x; j < JT; j += blockDim.x) {
    float ds = BF_INF;
    int first = -1;
    for (int u = 0; u < z; ++u) {
      if ((spur_sh[u] >> j) & 1u) {
        if (first < 0) first = u;
        ds = fminf(ds, d_cur[u * JT + j]);
      }
    }
    dspur_sh[j] = ds;
    sidx_sh[j] = first;
  }
  __syncthreads();

  for (int v = threadIdx.x; v < z; v += blockDim.x) {
    float best[JT];
    int arg[JT];
#pragma unroll
    for (int j = 0; j < JT; ++j) {
      best[j] = pos_inf();
      arg[j] = 0;
    }
    for (int u = 0; u < z; ++u) {
      const float a = (u == v) ? BF_INF : __ldg(adj_s + (size_t)u * z + v);
      const float* du = d_cur + u * JT;
      const uint32_t sp = spur_sh[u];
#pragma unroll
      for (int j = 0; j < JT; ++j) {
        const float c = __fadd_rn(((sp >> j) & 1u) ? BF_INF : du[j], a);
        if (c < best[j]) {  // strict: the first index of the min wins
          best[j] = c;
          arg[j] = u;
        }
      }
    }
    const uint32_t banb = ban_sh[v];
#pragma unroll
    for (int j = 0; j < JT; ++j) {
      if (j >= jn) continue;
      // no spur: the candidate is INF at index 0, as argmax of an all-false
      // mask gives in the reference
      const int si = sidx_sh[j];
      float sp = BF_INF;
      if (si >= 0 && !((banb >> j) & 1u)) {
        const float row = (si == v) ? BF_INF : __ldg(adj_s + (size_t)si * z + v);
        sp = __fadd_rn(dspur_sh[j], row);
      }
      float bval = best[j];
      int bu = arg[j];
      if (sp < bval) bu = si >= 0 ? si : 0;  // the spur wins only on a strict <
      bval = fminf(bval, sp);
      const float d = d_cur[v * JT + j];
      const bool ok = fabsf(__fsub_rn(bval, d)) <=
                      __fmul_rn(1e-6f, fmaxf(1.0f, fabsf(d)));
      const bool reached = d < BF_INF / 2.0f;
      const bool src = d <= 0.0f;
      dist_out[sj + (size_t)j * z + v] = d;
      parent_out[sj + (size_t)j * z + v] = (ok && reached && !src) ? bu : -1;
    }
  }
  if (threadIdx.x == 0) iters_out[(size_t)s * gridDim.y + blockIdx.y] = it;
}

size_t step_smem(int jt, int z) {
  return (size_t)z * jt * 4 + (size_t)z * 4 + (size_t)jt * 4;
}

size_t solve_smem(int jt, int z) {
  return 2 * (size_t)z * jt * 4 + 3 * (size_t)z * 4 + 3 * (size_t)jt * 4;
}

int block_threads(int z) {
  const int t = ((z + 31) / 32) * 32;
  return t < 256 ? t : 256;
}

template <int JT>
cudaError_t launch_step(const float* dist, const float* adj, const uint8_t* so,
                        const uint8_t* bn, const float* cap, float* out, int S,
                        int J, int z, cudaStream_t stream) {
  const size_t smem = step_smem(JT, z);
  cudaError_t err = cudaFuncSetAttribute(
      bf_relax_step_kernel<JT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(S, (J + JT - 1) / JT);
  bf_relax_step_kernel<JT><<<grid, block_threads(z), smem, stream>>>(
      dist, adj, so, bn, cap, out, J, z);
  return cudaGetLastError();
}

template <int JT>
cudaError_t launch_solve(const float* adj, const float* init, const uint8_t* bv,
                         const uint8_t* so, const uint8_t* bn, const float* cap,
                         float* dist, int32_t* parent, int32_t* iters, int S,
                         int J, int z, int max_iters, cudaStream_t stream) {
  const size_t smem = solve_smem(JT, z);
  cudaError_t err = cudaFuncSetAttribute(
      bf_solve_grouped_kernel<JT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(S, (J + JT - 1) / JT);
  bf_solve_grouped_kernel<JT><<<grid, block_threads(z), smem, stream>>>(
      adj, init, bv, so, bn, cap, dist, parent, iters, J, z, max_iters);
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
// f32, adj [S,z,z] f32, so/bn [S,J,z] bool (1 byte), cap [S,J] f32.
// Returns cudaGetLastError() after the launch (0 = launched).
int bf_relax_step(const void* dist, const void* adj, const void* so,
                  const void* bn, const void* cap, void* out, int S, int J,
                  int z, int jt, void* stream) {
#define BF_STEP(JT_)                                                        \
  (int)launch_step<JT_>((const float*)dist, (const float*)adj,             \
                        (const uint8_t*)so, (const uint8_t*)bn,            \
                        (const float*)cap, (float*)out, S, J, z,           \
                        (cudaStream_t)stream)
  BF_DISPATCH_JT(jt, BF_STEP)
#undef BF_STEP
}

// adj [S,z,z] f32; init [S,J,z] f32; bv/so/bn [S,J,z] bool; cap [S,J] f32;
// outputs dist [S,J,z] f32, parent [S,J,z] int32, iters [S, ceil(J/jt)]
// int32 (iterations each block ran).
int bf_solve_grouped(const void* adj, const void* init, const void* bv,
                     const void* so, const void* bn, const void* cap,
                     void* dist, void* parent, void* iters, int S, int J,
                     int z, int max_iters, int jt, void* stream) {
#define BF_SOLVE(JT_)                                                       \
  (int)launch_solve<JT_>((const float*)adj, (const float*)init,            \
                         (const uint8_t*)bv, (const uint8_t*)so,           \
                         (const uint8_t*)bn, (const float*)cap,            \
                         (float*)dist, (int32_t*)parent, (int32_t*)iters,  \
                         S, J, z, max_iters, (cudaStream_t)stream)
  BF_DISPATCH_JT(jt, BF_SOLVE)
#undef BF_SOLVE
}

}  // extern "C"
