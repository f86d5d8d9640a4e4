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
// Grouping.  The TPU kernel takes its queries pre-grouped by subgraph in
// blocks of 256 and reads one profile row per block.  Here the queries come
// in any order and are grouped on the card by a counting sort over the S
// subgraphs:
//
//   bd_histogram_kernel  counts[s] = queries of subgraph s (int32 atomics);
//   (the launcher)       offsets = their scan (torch.cumsum); work items of
//                        at most kMaxQ = 64 queries of one subgraph,
//                        ceil(counts[s] / kMaxQ) of them, item_off = their scan;
//   bd_scatter_kernel    order and phi_sorted: query ids and phi in bucket
//                        order (atomics on a copy of the offsets, so the
//                        order inside a bucket varies from run to run);
//   bd_items_kernel      items[i] = (subgraph, first, last, largest phi).
//
// Layout.  bd_eval_kernel runs a persistent grid of 256-thread blocks;
// block g takes a contiguous range of work items, 8 at a time (a batch:
// the items of one subgraph are consecutive and share one staged row).  A
// batch's rows are staged in shared memory in segments of 256 entries
// ([cum_before, n, w], 1 KiB each) by 1-D bulk copies (TMA) that report to
// an mbarrier, in two slots: segment t+1 lands while segment t is
// evaluated.  A row stages its next segment only while the batch's largest
// phi on that subgraph lies past the next segment's first cum_before, so a
// subgraph with no query costs no read and a profile's padded tail is not
// read either.  Rows of any E go segment by segment.
//
// Prefix sums.  A query's sum in the loop's order stops at k, the count of
// cum_before < phi.  Where the running counts are exact (cum_before[e+1] ==
// cum_before[e] + n[e] in f32 without rounding and n[e] >= +0; checked per
// segment with TwoSum, into the next segment's first entry too), every term
// before k-1 is w*n: cum_before[e+1] < phi gives phi - cum_before[e] > n[e]
// exactly.  So the loop's sum after k-1 terms is P[k-2], the sequential
// prefix of w*n.  Per segment, a warp per row checks it and puts w*n in
// place of n; one lane per row (warp 0, the 8 rows in step) runs the chain
// of adds of P along the segment, from the carry of the segments before;
// then each query whose stop lies in the segment (or at the next one's
// first entry, or at the row's end) finds k by binary search and adds its
// last term to P[k-2], with n[k-1] = cum_before[k] - cum_before[k-1]
// (exact) or the segment's kept last n.  From the first segment whose
// counts are not exact on, the row's queries run the loop itself instead:
// from the carry, one term per entry, up to the first cum_before >= phi.
//
// What bounds it.  The function needs, of each subgraph that has queries,
// the row up to its queries' largest stop (w and n below it, cum_before up
// to it), plus 12 bytes per query; at the maintain shape (S=122,880,
// E=2,048, B=4M) that is about three quarters of the 3.02 GB profile, since
// the padded tail and the entries past the largest phi are not needed.
// The kernel reads only the segments some query needs, and waits mostly
// on those bulk copies; the rest is per-segment work (barriers, the TwoSum
// check, the chain: one dependent add per entry, shared by the 8 rows of a
// batch).  The plain form, one thread per query summing its own terms,
// lost to instruction issue: a warp runs to its largest stop, and every
// lane recomputes the same prefix.
//
// Exactness.  The result is ref.bound_dist_seq_ref's bit for bit: terms in
// ascending e, each subtract, min, multiply and add rounded on its own
// (__f*_rn, --fmad=false), stopping at the first e with cum_before[e] >=
// phi.  Before the stop phi - cum_before[e] > 0, so the clamp at 0 is the
// identity and is not computed.  A query's bytes do not depend on where
// the grouping placed it.  Where cum_before is the exclusive running count
// of n >= 0 and w >= 0, every term after the stop is w * (+0) = +0, which
// changes no byte of the non-negative sum, so the early stop gives the
// loop run to E as well.  phi past the row's total finds no stop and runs
// to E.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// The layout the launcher (kernels/bound_dist.py) mirrors as PER_ITEM,
// BATCH and SEGMENT and checks against bound_dist_layout() at load.
constexpr int kMaxQ = 64;   // queries of a work item at most
constexpr int kRows = 8;    // work items of a batch, one lane each
constexpr int kSeg = 256;   // profile entries per staged segment

__global__ void bd_histogram_kernel(const int32_t* __restrict__ sub,
                                    int32_t* __restrict__ counts, int B) {
  for (int b = blockIdx.x * blockDim.x + threadIdx.x; b < B;
       b += gridDim.x * blockDim.x)
    atomicAdd(&counts[sub[b]], 1);
}

// order[pos] = b and phi_sorted[pos] = phi[b] at the next free position of
// sub[b]'s bucket.
__global__ void bd_scatter_kernel(const int32_t* __restrict__ sub,
                                  const float* __restrict__ phi,
                                  int32_t* __restrict__ cursor,
                                  int32_t* __restrict__ order,
                                  float* __restrict__ phi_sorted, int B) {
  for (int b = blockIdx.x * blockDim.x + threadIdx.x; b < B;
       b += gridDim.x * blockDim.x) {
    const int pos = atomicAdd(&cursor[sub[b]], 1);
    order[pos] = b;
    phi_sorted[pos] = phi[b];
  }
}

// items[i] = (s, first, last, bits of the largest phi): work item i is the
// chunk i - item_off[s] of subgraph s, the last s with item_off[s] <= i (so
// never a subgraph without items), and holds the bucket positions
// [first, last).
__global__ void bd_items_kernel(const int32_t* __restrict__ offsets,
                                const int32_t* __restrict__ item_off,
                                const float* __restrict__ phi_sorted,
                                int4* __restrict__ items, int S,
                                int max_items) {
  const int n_items = item_off[S];
  for (int i = blockIdx.x * blockDim.x + threadIdx.x;
       i < min(n_items, max_items); i += gridDim.x * blockDim.x) {
    int lo = 0, hi = S - 1;  // item_off[lo] <= i < item_off[hi + 1]
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (item_off[mid] <= i)
        lo = mid;
      else
        hi = mid - 1;
    }
    const int first = offsets[lo] + (i - item_off[lo]) * kMaxQ;
    const int last = min(first + kMaxQ, offsets[lo + 1]);
    float top = phi_sorted[first];
    for (int q = first + 1; q < last; ++q) top = fmaxf(top, phi_sorted[q]);
    items[i] = make_int4(lo, first, last, __float_as_int(top));
  }
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
      smem_addr(bar)));
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// The one arrival of the barrier's phase, which completes once `bytes` of
// bulk copies have landed.
__device__ __forceinline__ void mbar_arrive_expect(uint64_t* bar,
                                                   unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra.uni WAIT%=;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// A 1-D bulk copy (TMA) of `bytes` (a multiple of 16, both addresses
// 16-byte aligned) into shared memory, reported to `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// One term of the clip-sum before the stop (c < p): the clamp at 0 is the
// identity there.
__device__ __forceinline__ float add_term(float acc, float p, float c,
                                          float n, float w) {
  return __fadd_rn(acc, __fmul_rn(w, fminf(__fsub_rn(p, c), n)));
}

// ---------------------------------------------------------------------------
// evaluation
// ---------------------------------------------------------------------------
constexpr unsigned kFull = 0xffffffffu;
constexpr int kPitch = kSeg + 4;   // 16-byte rows; float4 reads of the 8
                                   // rows at one entry fall in distinct banks
constexpr int kThreads = 256;      // threads of an evaluation block
constexpr int kRowThreads = kThreads / kRows;  // threads a row: 32
constexpr int kHalf = kSeg / 2;    // = 4 * kRowThreads
constexpr int kPerThread = kRows * kMaxQ / kThreads;  // query slots: 2
static_assert(kHalf == 4 * kRowThreads && kRowThreads == 32, "layout");
static_assert(kPerThread * kThreads == kRows * kMaxQ,
              "every query slot of a batch has a thread");

struct EvalShared {
  float seg[2][3][kRows][kPitch];  // two slots of [cum_before, n, w] rows
  int first[kRows + 1];  // each lane's first bucket position, and the end
  int home[kRows];       // the lane whose staged row a lane's queries read:
                         // the batch's first lane of the same subgraph
  int row[kRows];        // each lane's subgraph
  float top[kRows];      // largest phi of a home lane's subgraph (batch)
  float cb_next[kRows];  // cum_before at the next segment's first entry
  float cin[kRows];      // prefix of w*n before the segment (home lanes)
  float n_last[kRows];   // n at the segment's last entry (its product
                         // takes its place)
  float gate[kRows];     // a query of the row runs on past this segment
                         // iff gate < phi (+inf: it stops or is done)
  int need[2][kRows];    // home lane staged in the slot's segment
  int by_prefix[kRows];  // every segment so far exact (home lanes)
  int switched[kRows];   // this segment moved the row to the loop
  int any_next;          // some row stages the next segment
  uint64_t bar[2];       // each slot's bulk copies landed (vec)
};

// sum + v[0].x + ... + v[1].w in that order, each add rounded; v becomes
// the running sums
__device__ __forceinline__ float add8(float sum, float4 (&v)[2]) {
#pragma unroll
  for (int g = 0; g < 2; ++g) {
    v[g].x = sum = __fadd_rn(sum, v[g].x);
    v[g].y = sum = __fadd_rn(sum, v[g].y);
    v[g].z = sum = __fadd_rn(sum, v[g].z);
    v[g].w = sum = __fadd_rn(sum, v[g].w);
  }
  return sum;
}

__device__ __forceinline__ float& at(EvalShared& sh, int slot, int a, int u,
                                     int e) {
  return sh.seg[slot][a][u][e];
}

// Stage segment `t` of every home lane's row whose need flag is set in
// `slot`, as [cum_before, n, w].  vec (16-byte aligned rows): one bulk copy
// per row and array, issued by warp 0 (lane = row), reported to the slot's
// barrier; otherwise 4-byte cp.async copies by every thread.
__device__ __forceinline__ void stage_segment(EvalShared& sh, int slot,
                                              const float* cb,
                                              const float* n,
                                              const float* w, int t, int E,
                                              bool vec) {
  const int e0 = t * kSeg, te = min(kSeg, E - e0);
  if (vec) {
    if (threadIdx.x >= 32) return;
    const int u = threadIdx.x;
    const bool mine = u < kRows && sh.need[slot][u];
    const unsigned rows = __popc(__ballot_sync(kFull, mine));
    if (u == 0) mbar_arrive_expect(&sh.bar[slot], rows * 3 * te * 4);
    __syncwarp();
    if (mine) {
      const size_t base = (size_t)sh.row[u] * E + e0;
      bulk_copy(&at(sh, slot, 0, u, 0), cb + base, te * 4, &sh.bar[slot]);
      bulk_copy(&at(sh, slot, 1, u, 0), n + base, te * 4, &sh.bar[slot]);
      bulk_copy(&at(sh, slot, 2, u, 0), w + base, te * 4, &sh.bar[slot]);
    }
  } else {
    constexpr int kPer = kRows * 3 * kSeg / kThreads;
#pragma unroll 4
    for (int m = 0; m < kPer; ++m) {
      const int c = threadIdx.x + m * kThreads;
      const int u = c / (3 * kSeg), rem = c - u * 3 * kSeg;
      const int a = rem / kSeg, e = rem - a * kSeg;
      if (!sh.need[slot][u] || e >= te) continue;
      const float* src = a == 0 ? cb : a == 1 ? n : w;
      cp_async4(&at(sh, slot, a, u, e),
                src + (size_t)sh.row[u] * E + e0 + e);
    }
    cp_async_commit();
  }
}

// Wait for the slot's segment: its barrier phase (vec) or every cp.async.
__device__ __forceinline__ void wait_segment(EvalShared& sh, int slot,
                                             unsigned parity, bool vec) {
  if (vec)
    mbar_wait(&sh.bar[slot], parity);
  else
    cp_async_wait_all();
}

// One pair of neighbouring entries of a row: cb + d == cb_next exactly in
// f32, with d >= +0 (the rounded sum is cb_next and TwoSum's error is 0).
__device__ __forceinline__ bool exact_step(float cb, float d, float cb_next) {
  const float s = __fadd_rn(cb, d);
  const float dp = __fsub_rn(s, cb);
  const float err = __fadd_rn(__fsub_rn(cb, __fsub_rn(s, dp)),
                              __fsub_rn(d, dp));
  return !signbit(d) && s == cb_next && err == 0.0f;
}

__global__ void __launch_bounds__(kThreads, 4)
    bd_eval_kernel(const float* __restrict__ w, const float* __restrict__ n,
                   const float* __restrict__ cb,
                   const int32_t* __restrict__ order,
                   const float* __restrict__ phi_sorted,
                   const int32_t* __restrict__ item_off,
                   const int4* __restrict__ items, float* __restrict__ out,
                   int S, int E, int vec) {
  extern __shared__ float4 smem4[];
  EvalShared& sh = *reinterpret_cast<EvalShared*>(smem4);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_items = item_off[S];
  const int batches = (n_items + kRows - 1) / kRows;
  const int per = (batches + gridDim.x - 1) / gridDim.x;
  const int bt_end = min(batches, (blockIdx.x + 1) * per);
  if (threadIdx.x == 0) {
    mbar_init(&sh.bar[0]);
    mbar_init(&sh.bar[1]);
  }
  __syncthreads();
  unsigned phase = 0;  // bit s: the parity of slot s's next barrier phase

  for (int bt = blockIdx.x * per; bt < bt_end; ++bt) {
    const int i0 = bt * kRows, rows = min(kRows, n_items - i0);
    // --- the batch's lanes (warp 0): subgraph, home lane, largest phi
    int row = -1;
    float carry = 0.0f, cbn = 0.0f;
    if (warp == 0) {
      const int4 it = lane < rows ? items[i0 + lane] : make_int4(-1, 0, 0, 0);
      row = it.x;
      const int before = __shfl_up_sync(kFull, it.x, 1);
      const bool head = lane < rows && (lane == 0 || before != it.x);
      const unsigned heads = __ballot_sync(kFull, head) | 1u;
      const int home = 31 - __clz(heads & (0xffffffffu >> (31 - lane)));
      float top = __int_as_float(it.w);  // max over the lanes of a home
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_down_sync(kFull, top, off);
        const int oh = __shfl_down_sync(kFull, home, off);
        if (lane + off < rows && oh == home) top = fmaxf(top, o);
      }
      if (lane < kRows) {
        sh.row[lane] = row;
        sh.home[lane] = home;
        sh.first[lane] = it.y;
        sh.top[lane] = top;
        sh.need[0][lane] = head;
        sh.by_prefix[lane] = 1;
      }
      if (lane == rows - 1) sh.first[rows] = it.z;
      if (head && kSeg < E) cbn = cb[(size_t)row * E + kSeg];
    }
    __syncthreads();
    stage_segment(sh, 0, cb, n, w, 0, E, vec);

    // --- this thread's queries: bucket positions P0 + threadIdx.x + j*256
    const int P0 = sh.first[0], P1 = sh.first[rows];
    float pq[kPerThread], aq[kPerThread];
    int hq[kPerThread];
    unsigned live = 0;
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const int pos = P0 + threadIdx.x + j * kThreads;
      aq[j] = 0.0f;
      pq[j] = 0.0f;
      hq[j] = 0;
      if (pos < P1) {
        int lo = 0;  // the lane holding pos: the last first[lo] <= pos
        for (int step = kRows / 2; step > 0; step >>= 1)
          if (lo + step < rows && sh.first[lo + step] <= pos) lo += step;
        pq[j] = phi_sorted[pos];
        hq[j] = sh.home[lo];
        live |= 1u << j;
      }
    }

    for (int t = 0;; ++t) {
      const int cur = t & 1;
      const int e0 = t * kSeg, te = min(kSeg, E - e0);
      const bool runs_on = e0 + kSeg < E;
      // warp 0: this segment's next cum_before; the rows that stage the
      // next segment (a query may run on past this one)
      if (warp == 0) {
        const bool mine = lane < kRows && sh.need[cur][lane];
        const bool next = mine && runs_on && cbn < sh.top[lane];
        if (lane < kRows) {
          sh.cb_next[lane] = cbn;
          sh.need[cur ^ 1][lane] = next;
        }
        const unsigned any = __ballot_sync(kFull, next);
        if (lane == 0) sh.any_next = any != 0;
        cbn = next && e0 + 2 * kSeg < E
                  ? cb[(size_t)row * E + e0 + 2 * kSeg] : 0.0f;
      }
      wait_segment(sh, cur, (phase >> cur) & 1u, vec);  // this segment
      phase ^= 1u << cur;
      __syncthreads();
      const bool any_next = sh.any_next;
      if (any_next) stage_segment(sh, cur ^ 1, cb, n, w, t + 1, E, vec);

      // --- exactness of the running counts, and the products w*n in
      // place of n: a warp a row, thread k on entries 4k..4k+3 and
      // kHalf+4k..kHalf+4k+3
      {
        const int u = warp, k = lane;
        const bool mine = sh.need[cur][u] && sh.by_prefix[u];
        const float nxt = runs_on ? sh.cb_next[u] : 0.0f;
        bool exact = true;
        float4 c[2], d[2];
        if (te == kSeg) {  // a whole segment: float4 reads, no bank conflict
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int e = kHalf * h + 4 * k;
            c[h] = *reinterpret_cast<const float4*>(&at(sh, cur, 0, u, e));
            d[h] = *reinterpret_cast<const float4*>(&at(sh, cur, 1, u, e));
          }
          // the first cum_before after each thread's four: its neighbour's
          const float after0 = __shfl_down_sync(kFull, c[0].x, 1);
          const float after1 = __shfl_down_sync(kFull, c[1].x, 1);
          const float mid = __shfl_sync(kFull, c[1].x, 0);
          if (mine) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const float last = k < kRowThreads - 1 ? (h ? after1 : after0)
                                                     : (h ? nxt : mid);
              exact &= exact_step(c[h].x, d[h].x, c[h].y);
              exact &= exact_step(c[h].y, d[h].y, c[h].z);
              exact &= exact_step(c[h].z, d[h].z, c[h].w);
              if (h == 0 || k < kRowThreads - 1 || runs_on)
                exact &= exact_step(c[h].w, d[h].w, last);
              else
                exact &= !signbit(d[h].w);
            }
          }
        } else if (mine) {
          for (int h = 0; h < 2; ++h)
            for (int i = 0; i < 4; ++i) {
              const int e = kHalf * h + 4 * k + i;
              if (e >= te) continue;
              const float ce = at(sh, cur, 0, u, e), de = at(sh, cur, 1, u, e);
              if (e + 1 < te)
                exact &= exact_step(ce, de, at(sh, cur, 0, u, e + 1));
              else if (runs_on)
                exact &= exact_step(ce, de, nxt);
              else
                exact &= !signbit(de);
            }
        }
        const bool row_exact = __all_sync(kFull, exact);
        if (mine && row_exact) {
          if (te == kSeg) {
            if (k == kRowThreads - 1) sh.n_last[u] = d[1].w;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int e = kHalf * h + 4 * k;
              const float4 ww =
                  *reinterpret_cast<const float4*>(&at(sh, cur, 2, u, e));
              float4 pr;
              pr.x = __fmul_rn(ww.x, d[h].x);
              pr.y = __fmul_rn(ww.y, d[h].y);
              pr.z = __fmul_rn(ww.z, d[h].z);
              pr.w = __fmul_rn(ww.w, d[h].w);
              *reinterpret_cast<float4*>(&at(sh, cur, 1, u, e)) = pr;
            }
          } else {
            for (int h = 0; h < 2; ++h)
              for (int i = 0; i < 4; ++i) {
                const int e = kHalf * h + 4 * k + i;
                if (e >= te) continue;
                const float de = at(sh, cur, 1, u, e);
                if (e == te - 1) sh.n_last[u] = de;
                at(sh, cur, 1, u, e) = __fmul_rn(at(sh, cur, 2, u, e), de);
              }
          }
        }
        if (k == 0) {
          if (mine) sh.by_prefix[u] = row_exact;
          sh.switched[u] = mine && !row_exact;
          sh.gate[u] = mine && row_exact && runs_on
                           ? nxt
                           : __int_as_float(0x7f800000);  // +inf
        }
      }
      __syncthreads();

      // --- the prefix of w*n along each exact row (warp 0, lane = row):
      // one chain of adds per row, all rows in step, each group's loads
      // issued a group ahead of its adds
      if (warp == 0 && lane < kRows && sh.need[cur][lane]) {
        sh.cin[lane] = carry;
        if (sh.by_prefix[lane]) {
          float* P = &at(sh, cur, 1, lane, 0);
          float4* P4 = reinterpret_cast<float4*>(P);
          float sum = carry;
          int e = 0;
          if (te == kSeg) {
            float4 a[2], b[2];
            a[0] = P4[0];
            a[1] = P4[1];
#pragma unroll
            for (int g = 0; g < kSeg / 8; g += 2) {
              b[0] = P4[2 * g + 2];
              b[1] = P4[2 * g + 3];
              sum = add8(sum, a);
              P4[2 * g] = a[0];
              P4[2 * g + 1] = a[1];
              if (g + 2 < kSeg / 8) {
                a[0] = P4[2 * g + 4];
                a[1] = P4[2 * g + 5];
              }
              sum = add8(sum, b);
              P4[2 * g + 2] = b[0];
              P4[2 * g + 3] = b[1];
            }
            e = kSeg;
          }
          for (; e < te; ++e) P[e] = sum = __fadd_rn(sum, P[e]);
          carry = sum;
        }
      }
      __syncthreads();

      // --- the queries on this segment: most run on (gate < phi)
      unsigned act = 0;
#pragma unroll
      for (int j = 0; j < kPerThread; ++j)
        if (!(sh.gate[hq[j]] < pq[j])) act |= 1u << j;
      act &= live;
#pragma unroll
      for (int j = 0; j < kPerThread; ++j) {
        if (!((act >> j) & 1u)) continue;
        const int u = hq[j];
        const float p = pq[j];
        if (!sh.need[cur][u]) {  // its row's queries all stopped before
          live &= ~(1u << j);
          continue;
        }
        const float* cb_r = &at(sh, cur, 0, u, 0);
        const float* n_r = &at(sh, cur, 1, u, 0);
        const float* w_r = &at(sh, cur, 2, u, 0);
        if (sh.by_prefix[u]) {
          // the stop k (the count of cum_before < p) is in this segment,
          // or is the next segment's first entry, or the row ends here
          int kk = 0;
          for (int step = kSeg; step > 0; step >>= 1)
            if (kk + step <= te && cb_r[kk + step - 1] < p) kk += step;
          const float cin = sh.cin[u];
          float r = cin;
          if (kk > 0) {
            const int jj = kk - 1;
            const float prev = jj == 0 ? cin : n_r[jj - 1];
            const float nj = kk < te ? __fsub_rn(cb_r[kk], cb_r[jj])
                                     : sh.n_last[u];
            r = add_term(prev, p, cb_r[jj], nj, w_r[jj]);
          }
          aq[j] = r;
          live &= ~(1u << j);
        } else {
          float acc = sh.switched[u] ? sh.cin[u] : aq[j];
          for (int e = 0; e < te; ++e) {
            const float c = cb_r[e];
            if (c >= p) {
              live &= ~(1u << j);
              break;
            }
            acc = add_term(acc, p, c, n_r[e], w_r[e]);
          }
          aq[j] = acc;
        }
      }
      // the next bulk copies into this slot follow these threads' writes
      if (vec) asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();  // shared state is rewritten at the next step
      if (!any_next) break;
    }
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const int pos = P0 + threadIdx.x + j * kThreads;
      if (pos < P1) out[order[pos]] = aq[j];
    }
  }
}

size_t eval_smem() { return sizeof(EvalShared); }

cudaError_t set_eval_smem(size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(
      bd_eval_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(bd_eval_kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

constexpr int kGroupThreads = 256;

int group_blocks(int n) {
  return n <= 0 ? 1 : min((n + kGroupThreads - 1) / kGroupThreads, 4096);
}

}  // namespace

extern "C" {

// sub [B] int32 (each in [0, S)); counts [S] int32, zeroed by the caller.
int bound_dist_histogram(const void* sub, void* counts, int B, void* stream) {
  bd_histogram_kernel<<<group_blocks(B), kGroupThreads, 0,
                        (cudaStream_t)stream>>>((const int32_t*)sub,
                                                (int32_t*)counts, B);
  return (int)cudaGetLastError();
}

// phi [B] f32; cursor [S] int32: a copy of each bucket's first position
// (advanced in place); order [B] int32 and phi_sorted [B] f32 receive the
// query ids and their phi in bucket order.
int bound_dist_scatter(const void* sub, const void* phi, void* cursor,
                       void* order, void* phi_sorted, int B, void* stream) {
  bd_scatter_kernel<<<group_blocks(B), kGroupThreads, 0,
                      (cudaStream_t)stream>>>(
      (const int32_t*)sub, (const float*)phi, (int32_t*)cursor,
      (int32_t*)order, (float*)phi_sorted, B);
  return (int)cudaGetLastError();
}

// offsets [S+1] int32 (each bucket's first position), item_off [S+1] int32
// (the exclusive scan of ceil(counts / kMaxQ)), phi_sorted [B] f32; items
// [max_items, 4] int32 (max_items >= item_off[S]) receives each work item's
// (subgraph, first, last, bits of its largest phi).
int bound_dist_items(const void* offsets, const void* item_off,
                     const void* phi_sorted, void* items, int S,
                     int max_items, void* stream) {
  bd_items_kernel<<<group_blocks(max_items), kGroupThreads, 0,
                    (cudaStream_t)stream>>>(
      (const int32_t*)offsets, (const int32_t*)item_off,
      (const float*)phi_sorted, (int4*)items, S, max_items);
  return (int)cudaGetLastError();
}

// w_sorted, n_sorted, cum_before [S,E] f32; order [B] int32, phi_sorted
// [B] f32, item_off [S+1] int32 and items [max_items, 4] int32 from the
// grouping (at most kMaxQ queries a work item); out [B] f32.  `grid`
// persistent blocks; `vec` 1 where every profile row starts 16-byte
// aligned.  Returns cudaGetLastError() after the launch.
int bound_dist_eval(const void* w, const void* n, const void* cb,
                    const void* order, const void* phi_sorted,
                    const void* item_off, const void* items, void* out,
                    int S, int E, int grid, int vec, void* stream) {
  const size_t smem = eval_smem();
  cudaError_t err = set_eval_smem(smem);
  if (err != cudaSuccess) return (int)err;
  bd_eval_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)w, (const float*)n, (const float*)cb,
      (const int32_t*)order, (const float*)phi_sorted,
      (const int32_t*)item_off, (const int4*)items, (float*)out, S, E, vec);
  return (int)cudaGetLastError();
}

// The layout: out[0] = queries of a work item at most, out[1] = work items
// of a batch, out[2] = profile entries of a staged segment.
void bound_dist_layout(int* out) {
  out[0] = kMaxQ;
  out[1] = kRows;
  out[2] = kSeg;
}

// Blocks of bd_eval_kernel that one SM holds at once (-1 if the query
// failed).
int bound_dist_blocks_per_sm() {
  const size_t smem = eval_smem();
  int blocks = 0;
  if (set_eval_smem(smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, bd_eval_kernel,
                                                    kThreads, smem) !=
          cudaSuccess)
    return -1;
  return blocks;
}

}  // extern "C"
