// Batched bound-distance evaluation for Hopper (sm_90a), CUDA cores.
//
// Replaces the Pallas TPU kernel `bound_dist` (src/repro/kernels/
// bound_dist.py, `_bound_dist_kernel`):
//
//   BD[b] = sum_e w_sorted[sub[b],e] * clip(phi[b] - cum_before[sub[b],e],
//                                           0, n_sorted[sub[b],e])
//
// over an ascending-sorted unit-weight profile (the sum of the phi[b]
// smallest unit weights of subgraph sub[b]).  Padded entries (w = INF,
// n = 0) add INF * 0 = 0.
//
// Layout.  One warp per query: it loads sub[b] and phi[b], its lanes stride
// along the profile row (coalesced), each keeps an f32 partial sum, and a
// shuffle reduction adds the 32 partials.  The query index is per query,
// not per 256-query block as on the TPU (where a scalar-prefetched index
// map wants each block to share one subgraph): the maintain cell's queries
// arrive in random subgraph order, about 33 per subgraph.
//
// What bounds it.  The function needs each of the three [S,E] f32 profile
// arrays once (3.02 GB at S=122,880, E=2,048) plus 12 bytes per query:
// 0.92 ms at 3.35 TB/s, above the 4.1e10 operations (0.61 ms at the f32
// rate).  With random sub each query rereads its 24 KiB row instead, about
// 98 GB at B=4,000,000, so this kernel is bound by those rereads; grouping
// the queries by subgraph before the launch would cut them to about one
// read of the profile and is left for a later change.
//
// Exactness.  The sum runs in another order than the plain version's
// torch.sum (lane partials, then a shuffle tree), so results agree to a
// tolerance, not bit for bit.  Subtract, clamp, multiply and add are each
// rounded on their own (__f*_rn, --fmad=false).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__global__ void bound_dist_kernel(const float* __restrict__ w,
                                  const float* __restrict__ n,
                                  const float* __restrict__ cb,
                                  const int32_t* __restrict__ sub,
                                  const float* __restrict__ phi,
                                  float* __restrict__ out, int B, int E) {
  const int lane = threadIdx.x & 31;
  const long long b =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (b >= B) return;  // uniform per warp
  const size_t row = (size_t)sub[b] * E;
  const float p = phi[b];
  float acc = 0.0f;
  for (int e = lane; e < E; e += 32) {
    const float take =
        fminf(fmaxf(__fsub_rn(p, cb[row + e]), 0.0f), n[row + e]);
    acc = __fadd_rn(acc, __fmul_rn(w[row + e], take));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc = __fadd_rn(acc, __shfl_down_sync(0xffffffffu, acc, off));
  if (lane == 0) out[b] = acc;
}

}  // namespace

extern "C" {

// All pointers are device pointers to contiguous tensors: w_sorted,
// n_sorted, cum_before [S,E] f32; sub [B] int32 (each in [0, S)); phi [B]
// f32; out [B] f32.  Returns cudaGetLastError() after the launch.
int bound_dist(const void* w, const void* n, const void* cb, const void* sub,
               const void* phi, void* out, int B, int E, void* stream) {
  const int blocks = (B + kWarpsPerBlock - 1) / kWarpsPerBlock;
  bound_dist_kernel<<<blocks, kWarpsPerBlock * 32, 0, (cudaStream_t)stream>>>(
      (const float*)w, (const float*)n, (const float*)cb, (const int32_t*)sub,
      (const float*)phi, (float*)out, B, E);
  return (int)cudaGetLastError();
}

}  // extern "C"
