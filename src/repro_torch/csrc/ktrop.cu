// k-distinct tropical (min-plus) relaxation for Hopper (sm_90a), CUDA cores.
//
// Replaces the Pallas TPU kernel `ktrop_relax` (src/repro/kernels/ktrop.py,
// `_ktrop_kernel`) and the `lax.while_loop` that iterates it to a fixed point
// (`ktrop_solve`, src/repro/engine/dense.py).  Two kernels share one scan:
//
//   ktrop_relax_step_kernel  one relaxation with the Pallas contract: for each
//                            v, the k smallest DISTINCT values among D[s,:,v]
//                            and D[s,j,u] + adj[s,u,v], INF padded.  Any z;
//                            k <= 16 (the TPU kernel's own VMEM plan).
//   ktrop_solve_kernel       the whole fixed point of the index build (the
//                            `levels` cell): D0 from src, relax and change
//                            test per iteration, at most max_iters
//                            iterations; returns D and the iterations each
//                            row ran.  The host never waits per iteration.
//
// Contract.  D is ascending along k for every (s, v), and every value of D
// and adj is INF (the finite 3.0e38) or far below it, so a candidate is
// either below INF or is padding (INF, or +inf where INF+INF overflows).
// Every D the solve produces is ascending.
//
// Layout.  Each thread owns one column v and keeps the sorted list of the k
// smallest distinct values seen so far in registers (K is a template
// parameter, so the list is unrolled).  D[s] is staged in shared memory as
// [u][K]: for one u every thread of a warp reads the same addresses (a
// broadcast).  The loop over u reads adj[s,u,v] coalesced across the warp.
// The step kernel tiles u through 48 KiB of shared memory, so it takes any
// z; the solve keeps D double-buffered in shared memory (2*K*z*4 bytes,
// 20 KiB at the levels shape), one block per slab row.
//
// What bounds it.  One relaxation reads the adjacency once: S*z*z*4 bytes
// (2.15 GB at S=8192, z=256), 0.64 ms at 3.35 TB/s, against at most
// S*z*z*k add+compare pairs (5.4e9, 0.16 ms at the f32 rate), and with the
// early exit below about S*(z*z + k*nnz) on road subgraphs, whose rows hold
// nnz ~ 2% finite entries: bound by bytes.  The fused solve rereads its 256 KiB adjacency row from L2/device memory every
// iteration (it does not fit in shared memory beside D), so it moves
// iterations x 2.15 GB; a compact edge list of the row in shared memory is
// the next step and is not attempted here.  The TPU kernel's k passes of
// strict-greater masked minima are not carried over: they do k times the
// work.  Instead each candidate costs one add and one compare against the
// list's k-th value; only a smaller candidate is inserted.  Since D[j,u] is
// ascending in j, the first candidate of u that is not smaller ends the
// j loop (f32 add is monotone), so a vertex u with no edge into v (adj INF)
// costs one add and one compare.
//
// Exactness.  The set of the k smallest distinct values does not depend on
// the order candidates are visited, and f32 add is the only arithmetic, so
// the result is bitwise equal to the reference's sort, dedupe, sort: its
// first k entries are the k smallest distinct values below INF followed by
// INF (the overflowing +inf can never be among them).  Candidates >= INF
// are never inserted, and the list starts as INF.  Stopping each row on its
// own change test gives the global loop's bytes: a relaxation keeps D's own
// levels, so for a distinct ascending D no value grows, "nothing decreased"
// means the row maps to itself, and it does so from then on.

#include <cuda_runtime.h>
#include <stdint.h>

#define KT_INF 3.0e38f

namespace {

constexpr int kStepSmem = 48 * 1024;  // step kernel's D tile (static limit)

// Insert x (< T[K-1]) into the ascending list T of distinct values; a value
// already in T is dropped.  INF entries are empty slots.
template <int K>
__device__ __forceinline__ void insert_distinct(float (&T)[K], float x) {
  bool dup = false;
#pragma unroll
  for (int i = 0; i < K; ++i) dup |= (T[i] == x);
  if (dup) return;
#pragma unroll
  for (int i = K - 1; i > 0; --i)
    T[i] = (T[i - 1] > x) ? T[i - 1] : fminf(T[i], x);
  T[0] = fminf(T[0], x);
}

// Fold column v's own levels into T.
template <int K>
__device__ __forceinline__ void fold_own(float (&T)[K], const float* dv,
                                         int stride) {
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const float x = dv[j * stride];
    if (x < T[K - 1]) insert_distinct<K>(T, x);
  }
}

// Fold the candidates d_sh[uu][j] + adj[u0+uu, v] for uu < un into T.
template <int K>
__device__ __forceinline__ void fold_tile(float (&T)[K],
                                          const float* __restrict__ adj_col,
                                          int z, const float* d_sh, int u0,
                                          int un) {
  for (int uu = 0; uu < un; ++uu) {
    const float a = __ldg(adj_col + (size_t)(u0 + uu) * z);
    const float* du = d_sh + uu * K;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const float c = __fadd_rn(du[j], a);
      if (!(c < T[K - 1])) break;  // D ascending: the rest of u is no smaller
      insert_distinct<K>(T, c);
    }
  }
}

template <int K>
__global__ void ktrop_relax_step_kernel(const float* __restrict__ D,
                                        const float* __restrict__ adj,
                                        float* __restrict__ out, int z,
                                        int ut) {
  extern __shared__ __align__(16) float d_sh[];  // [ut][K]
  const int s = blockIdx.x;
  const int v = blockIdx.y * blockDim.x + threadIdx.x;
  const bool live = v < z;
  const float* D_s = D + (size_t)s * K * z;
  const float* adj_s = adj + (size_t)s * z * z;

  float T[K];
#pragma unroll
  for (int i = 0; i < K; ++i) T[i] = KT_INF;
  if (live) fold_own<K>(T, D_s + v, z);

  for (int u0 = 0; u0 < z; u0 += ut) {
    const int un = min(ut, z - u0);
    __syncthreads();  // the previous tile is consumed
    for (int i = threadIdx.x; i < un * K; i += blockDim.x) {
      const int j = i / un, uu = i % un;  // coalesced along u
      d_sh[uu * K + j] = D_s[(size_t)j * z + u0 + uu];
    }
    __syncthreads();
    if (live) fold_tile<K>(T, adj_s + v, z, d_sh, u0, un);
  }
  if (live) {
#pragma unroll
    for (int j = 0; j < K; ++j) out[(size_t)s * K * z + (size_t)j * z + v] = T[j];
  }
}

template <int K>
__global__ void ktrop_solve_kernel(const float* __restrict__ adj,
                                   const int32_t* __restrict__ src,
                                   float* __restrict__ D_out,
                                   int32_t* __restrict__ iters_out, int z,
                                   int max_iters) {
  extern __shared__ __align__(16) float smem[];
  float* cur = smem;         // [z][K]
  float* nxt = smem + z * K;  // [z][K]
  const int s = blockIdx.x;
  const float* adj_s = adj + (size_t)s * z * z;

  // D0: level 0 is 0 at the source, all else INF
  const int sv = src[s];
  for (int i = threadIdx.x; i < z * K; i += blockDim.x)
    cur[i] = (sv >= 0 && sv < z && i == sv * K) ? 0.0f : KT_INF;
  __syncthreads();

  int it = 0;
  while (it < max_iters) {
    int changed = 0;
    for (int v = threadIdx.x; v < z; v += blockDim.x) {
      float T[K];
#pragma unroll
      for (int i = 0; i < K; ++i) T[i] = KT_INF;
      const float* dv = cur + v * K;
      fold_own<K>(T, dv, 1);
      fold_tile<K>(T, adj_s + v, z, cur, 0, z);
#pragma unroll
      for (int j = 0; j < K; ++j) {
        nxt[v * K + j] = T[j];
        changed |= T[j] < dv[j];
      }
    }
    ++it;
    const int any = __syncthreads_or(changed);
    float* t = cur;
    cur = nxt;
    nxt = t;
    if (!any) break;
  }

  for (int i = threadIdx.x; i < z * K; i += blockDim.x) {
    const int j = i / z, v = i % z;  // coalesced store of [K][z]
    D_out[(size_t)s * K * z + i] = cur[v * K + j];
  }
  if (threadIdx.x == 0) iters_out[s] = it;
}

int block_threads(int z) {
  const int t = ((z + 31) / 32) * 32;
  return t < 256 ? t : 256;
}

template <int K>
cudaError_t launch_step(const float* D, const float* adj, float* out, int S,
                        int z, cudaStream_t stream) {
  const int threads = block_threads(z);
  const int ut = min(z, kStepSmem / (K * 4));
  dim3 grid(S, (z + threads - 1) / threads);
  ktrop_relax_step_kernel<K><<<grid, threads, (size_t)ut * K * 4, stream>>>(
      D, adj, out, z, ut);
  return cudaGetLastError();
}

template <int K>
cudaError_t launch_solve(const float* adj, const int32_t* src, float* D,
                         int32_t* iters, int S, int z, int max_iters,
                         cudaStream_t stream) {
  const size_t smem = 2 * (size_t)K * z * 4;
  cudaError_t err = cudaFuncSetAttribute(
      ktrop_solve_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  ktrop_solve_kernel<K><<<S, block_threads(z), smem, stream>>>(
      adj, src, D, iters, z, max_iters);
  return cudaGetLastError();
}

}  // namespace

#define KT_DISPATCH_K(k, call)                    \
  switch (k) {                                    \
    case 1: return call(1);                       \
    case 2: return call(2);                       \
    case 3: return call(3);                       \
    case 4: return call(4);                       \
    case 5: return call(5);                       \
    case 6: return call(6);                       \
    case 7: return call(7);                       \
    case 8: return call(8);                       \
    case 9: return call(9);                       \
    case 10: return call(10);                     \
    case 11: return call(11);                     \
    case 12: return call(12);                     \
    case 13: return call(13);                     \
    case 14: return call(14);                     \
    case 15: return call(15);                     \
    case 16: return call(16);                     \
    default: return (int)cudaErrorInvalidValue;   \
  }

extern "C" {

// All pointers are device pointers to contiguous tensors: D/out [S,k,z] f32,
// adj [S,z,z] f32.  Returns cudaGetLastError() after the launch (0 =
// launched).
int ktrop_relax_step(const void* D, const void* adj, void* out, int S, int k,
                     int z, void* stream) {
#define KT_STEP(K_)                                                        \
  (int)launch_step<K_>((const float*)D, (const float*)adj, (float*)out, S, \
                       z, (cudaStream_t)stream)
  KT_DISPATCH_K(k, KT_STEP)
#undef KT_STEP
}

// adj [S,z,z] f32; src [S] int32; outputs D [S,k,z] f32 and iters [S] int32
// (the relaxations each row ran, at most max_iters).
int ktrop_solve(const void* adj, const void* src, void* D, void* iters, int S,
                int k, int z, int max_iters, void* stream) {
#define KT_SOLVE(K_)                                                      \
  (int)launch_solve<K_>((const float*)adj, (const int32_t*)src, (float*)D, \
                        (int32_t*)iters, S, z, max_iters,                  \
                        (cudaStream_t)stream)
  KT_DISPATCH_K(k, KT_SOLVE)
#undef KT_SOLVE
}

}  // extern "C"
