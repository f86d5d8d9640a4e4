// Staged read of one adjacency row through shared memory (Hopper, sm_90a).
//
// Shared by the step kernels (bf_relax_step in bf_relax.cu,
// ktrop_relax_step in ktrop.cu); the mbarrier and bulk-copy helpers are
// also those of bound_dist.cu.  A step kernel's block owns slab row s and
// needs all of adj[s]: z*z f32, contiguous, 256 KiB at z=256.  Read with
// one dependent load per (u, v) and thread, a block keeps too few bytes in
// flight (about 3 KB per SM) and the read runs at a fraction of the
// card's bandwidth.  Here one thread issues 1-D bulk copies (TMA) of
// kRowChunk floats (4 KiB) into a ring of buffers in shared memory, each
// reported to its own mbarrier, so stages * 4 KiB per block are in flight
// while the block works on the chunk that landed.  The launcher chooses
// the stages (3 to kRowMaxStages) and the list's slots for the most
// blocks per SM (kernels/_build.py::step_layout): the step kernels wait
// less on the read than on their own per-block phases (tile loads, the
// relaxation from the list), which only other blocks on the SM overlap.
// At the main shapes that keeps 45-60 KiB in flight per SM (3.35 TB/s *
// ~1 us / 132 SMs is about 25 KiB).
//
// Alignment.  A bulk copy needs 16-byte aligned addresses and a size that
// is a multiple of 16 bytes.  A row starts on a 16-byte boundary only for
// some z and s, and the tensor may be a view with a storage offset.  So
// the row is read as a flat range of n = z*z floats: the head (fewer than
// 4 floats up to the first 16-byte boundary) and the tail (fewer than 4
// after the last whole 16 bytes) by plain loads, the body in chunks.
// kernels/_build.py::row_stage_plan is the same plan in Python.
//
// Use.  row_begin (all threads) issues the first chunks and loads head and
// tail; after a block barrier, row_stream calls fn(buf, f0, f1) for the
// head, each chunk and the tail, in ascending order of the flat index:
// buf[f - f0] holds entry f = u*z + v for f0 <= f < f1.  A block barrier
// follows each chunk (its buffer is then refilled); none follows the tail,
// so the caller syncs before another thread reads what fn wrote.  A block
// may stream its row more than once (or drain a pass it began and does
// not need): `uses` counts the chunk copies made on the barriers so far
// and sets each wait's parity.  A consumer walks column v of the ranges
// by keeping its next source u: the ranges are contiguous and ascending,
// so no division is needed.  (Per-stage "empty" barriers in place of the
// block barrier, so warps drift apart, measured slower on the H100.)

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

}  // namespace

constexpr int kRowMaxStages = 8;  // chunks in flight per block, at most
constexpr int kRowChunk = 1024;   // floats per chunk (4 KiB)
constexpr int kRowRing = 128;     // bytes before the ring: the barriers
                                  // [kRowMaxStages], head and tail [8]

// Shared-memory bytes of the staging area with `stages` buffers (mirrored
// by kernels/_build.py::row_stage_smem).
__host__ __device__ constexpr size_t row_stage_smem(int stages) {
  return kRowRing + (size_t)stages * kRowChunk * 4;
}

struct RowStage {
  uint64_t* bar;  // [stages]
  float* edge;    // the head at [0, 4), the tail at [4, 8)
  float* buf;     // [stages][kRowChunk], 16-byte aligned
  int stages;
};

// The staging area at `base` (16-byte aligned), row_stage_smem(stages)
// bytes; the launcher chooses `stages` (4 to kRowMaxStages).
__device__ __forceinline__ RowStage row_stage_at(void* base, int stages) {
  RowStage st;
  st.bar = reinterpret_cast<uint64_t*>(base);
  st.edge = reinterpret_cast<float*>(st.bar + kRowMaxStages);
  st.buf = reinterpret_cast<float*>(reinterpret_cast<char*>(base) + kRowRing);
  st.stages = stages;
  return st;
}

// Flat indices are int: the launchers take z*z < 2^31.
struct RowPlan {
  const float* row;
  int n;       // floats of the row
  int head;    // plain loads up to the first 16-byte boundary (< 4)
  int body;    // bulk copies, a multiple of 4 floats
  int chunks;  // ceil(body / kRowChunk)
};

// The plan of a row at `row` (4-byte aligned, as every f32 tensor).
__device__ __forceinline__ RowPlan row_plan(const float* row, int n) {
  RowPlan p;
  p.row = row;
  p.n = n;
  const int mis = (int)(reinterpret_cast<uintptr_t>(row) & 15u);
  const int head = mis ? (16 - mis) / 4 : 0;
  p.head = head < n ? head : n;
  p.body = (n - p.head) / 4 * 4;
  p.chunks = (p.body + kRowChunk - 1) / kRowChunk;
  return p;
}

// Thread 0: bulk copy of chunk c into the buffer of use `use`.
__device__ __forceinline__ void row_issue(const RowStage& st,
                                          const RowPlan& p, int c,
                                          unsigned use) {
  const int slot = use % st.stages;
  const int at = c * kRowChunk;
  const unsigned bytes = (unsigned)min(kRowChunk, p.body - at) * 4;
  mbar_arrive_expect(&st.bar[slot], bytes);
  bulk_copy(st.buf + (size_t)slot * kRowChunk, p.row + p.head + at, bytes,
            &st.bar[slot]);
}

// Thread 0: the barriers of the ring, each expecting one arrival.
__device__ __forceinline__ void row_init(const RowStage& st) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < st.stages; ++i) mbar_init(&st.bar[i]);
  }
}

// All threads: start a pass over the row (the first chunks in flight, the
// head and tail loaded).  Thread 0 must have run row_init before, and a
// block barrier must follow before row_stream or row_drain.
__device__ __forceinline__ void row_begin(const RowStage& st,
                                          const RowPlan& p, unsigned uses) {
  if (threadIdx.x == 0) {
    for (int c = 0; c < p.chunks && c < st.stages; ++c)
      row_issue(st, p, c, uses + c);
  }
  const int t = threadIdx.x;
  if (t < 4) {
    if (t < p.head) st.edge[t] = p.row[t];
  } else if (t < 8) {
    const int f = p.head + p.body + (t - 4);
    if (f < p.n) st.edge[t] = p.row[f];
  }
}

// All threads: call fn(buf, f0, f1) for the head, each chunk and the tail
// of a pass that row_begin started, in ascending order of the flat index
// (buf[f - f0] holds entry f for f0 <= f < f1).  A block barrier follows
// each chunk, whose buffer is then refilled; none follows the tail.
template <class Fn>
__device__ __forceinline__ void row_stream(const RowStage& st,
                                           const RowPlan& p, unsigned& uses,
                                           Fn&& fn) {
  if (p.head > 0) fn(st.edge, 0, p.head);
  for (int c = 0; c < p.chunks; ++c) {
    const unsigned use = uses + c;
    const int slot = use % st.stages;
    mbar_wait(&st.bar[slot], (use / st.stages) & 1u);
    const int f0 = p.head + c * kRowChunk;
    fn(st.buf + (size_t)slot * kRowChunk, f0,
       f0 + min(kRowChunk, p.head + p.body - f0));
    __syncthreads();  // the buffer is read: it may be refilled
    if (threadIdx.x == 0 && c + st.stages < p.chunks)
      row_issue(st, p, c + st.stages, use + st.stages);
  }
  const int tail0 = p.head + p.body;
  if (tail0 < p.n) fn(st.edge + 4, tail0, p.n);
  uses += p.chunks;
}

// All threads: wait for the chunks row_begin issued, for a block that
// does not stream the row after all (no copy may still be landing when
// the block exits or reuses the ring).
__device__ __forceinline__ void row_drain(const RowStage& st,
                                          const RowPlan& p, unsigned& uses) {
  const int issued = min(p.chunks, st.stages);
  for (int c = 0; c < issued; ++c) {
    const unsigned use = uses + c;
    mbar_wait(&st.bar[use % st.stages], (use / st.stages) & 1u);
  }
  uses += issued;
}
