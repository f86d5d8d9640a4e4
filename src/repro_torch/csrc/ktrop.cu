// k-distinct tropical (min-plus) relaxation for Hopper (sm_90a), CUDA cores.
//
// Replaces the Pallas TPU kernel `ktrop_relax` (src/repro/kernels/ktrop.py,
// `_ktrop_kernel`) and the `lax.while_loop` that iterates it to a fixed point
// (`ktrop_solve`, src/repro/engine/dense.py).  Two kernels share one scan:
//
//   ktrop_relax_step_kernel  one relaxation with the Pallas contract: for each
//                            v, the k smallest DISTINCT values among D[s,:,v]
//                            and D[s,j,u] + adj[s,u,v], INF padded.  Any z
//                            whose D[s] fits in shared memory; k <= 16 (the
//                            TPU kernel's own VMEM plan).
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
// Layout.  Each thread owns a column v and keeps the sorted list of the k
// smallest distinct values seen so far in registers (K is a template
// parameter, so the list is unrolled).  The step kernel's block owns slab
// row s: it loads D[s] into shared memory as D lies ([K][z]) and checks
// D >= 0 over it, under which skipping the entries adj >= INF keeps every
// byte (in_edges.cuh).  Where it holds, the row streams through shared
// memory in 4 KiB chunks, 3-8 in flight per block (row_stage.cuh; the
// copies start before D loads), each thread appends the finite entries
// of its columns to an in-edge list as they land, and then folds its
// columns' in-edges only: one 2.15 GB read at the levels shape, where one
// dependent load per (u, v) and thread kept the read latency-bound.  A row
// that fails the check, or has a column over the list's budget, scans
// every u of the row from device memory instead (the same fold; one add
// and one compare per non-edge).  The launcher's `path` output says which.
// As for bf_relax_step, blocks per SM set its pace on the H100, so the
// launcher trades list slots above 8 and stages above 3 for blocks
// (scripts/sweep_step_layouts.py times the alternatives).
//
// The fused solve reads its adjacency row from device memory once and keeps
// the finite entries as a compact in-edge list in shared memory
// (in_edges.cuh): about 4.75 entries per vertex on a road subgraph instead
// of z = 256 scanned sources, and one 2.15 GB read at the levels shape
// instead of iterations x 2.15 GB of rereads.  With the list, neighbouring
// threads read D at different u, so D is kept double-buffered as [K][z]
// (2*K*z*4 bytes, 20 KiB at the levels shape): level j of u is word j*z+u,
// the copy of v's own levels and the final store are consecutive in v, and
// the list slots are consecutive in v too.  Each vertex's k-list starts as
// a copy of its own levels, which is what folding them would give: D is
// distinct and ascending below INF throughout the solve.  A block whose row
// has a column over the list's budget, or a negative weight (which could
// take D below zero mid-solve, where a skipped entry's candidate D + INF
// falls below INF: in_edges.cuh), scans every u of the dense row from
// device memory instead (the same fold; one add and one compare per
// non-edge).
//
// What bounds it.  The least time is the single read of the adjacency:
// S*z*z*4 bytes (2.15 GB at S=8192, z=256), 0.64 ms at 3.35 TB/s, against
// at most S*k*nnz add+compare pairs per iteration on road subgraphs, whose
// rows hold nnz ~ 2% finite entries.  What the solve spends beyond it is
// instruction issue in the k-list insertions, each a duplicate test and a
// shift over K registers, at every iteration.  The TPU kernel's k passes of
// strict-greater masked minima are not carried over: they do k times the
// work.  Instead each candidate costs one add and one compare against the
// list's k-th value; only a smaller candidate is inserted.  Since D[j,u] is
// ascending in j, the first candidate of u that is not smaller ends the
// j loop (f32 add is monotone), so a vertex u with no edge into v (adj INF)
// costs one add and one compare where it is scanned at all.
//
// Exactness.  The set of the k smallest distinct values does not depend on
// the order candidates are visited, and f32 add is the only arithmetic, so
// the result is bitwise equal to the reference's sort, dedupe, sort: its
// first k entries are the k smallest distinct values below INF followed by
// INF (the overflowing +inf can never be among them).  Candidates >= INF
// are never inserted, and the list starts as INF (the step) or as the own
// levels, which are such a list already (the solve).  Stopping each row on its
// own change test gives the global loop's bytes: a relaxation keeps D's own
// levels, so for a distinct ascending D no value grows, "nothing decreased"
// means the row maps to itself, and it does so from then on.  Skipping the
// entries with adj >= INF changes nothing: their candidates are >= INF and
// never inserted (in_edges.cuh).

#include <cuda_runtime.h>
#include <stdint.h>

#include "in_edges.cuh"
#include "row_stage.cuh"

#define KT_INF 3.0e38f

namespace {

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

// Fold the candidates du[j*stride] + a (the levels of one source u) into T.
template <int K>
__device__ __forceinline__ void fold_source(float (&T)[K], const float* du,
                                            int stride, float a) {
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const float c = __fadd_rn(du[j * stride], a);
    if (!(c < T[K - 1])) break;  // D ascending: the rest of u is no smaller
    insert_distinct<K>(T, c);
  }
}

// At most 256 threads a block; its shared memory sets the blocks per SM
// (five at the levels shape).
template <int K>
__global__ void __launch_bounds__(256) ktrop_relax_step_kernel(
    const float* __restrict__ D, const float* __restrict__ adj,
    float* __restrict__ out, int32_t* __restrict__ path_out, int z,
    int slots, int stages) {
  extern __shared__ __align__(16) float smem[];
  const RowStage st = row_stage_at(smem, stages);
  float* d_sh = smem + row_stage_smem(stages) / 4;  // [K][z]
  int* next_u = reinterpret_cast<int*>(d_sh + K * z);  // [z]
  const InEdgeList list(next_u + z, z, slots);
  const int s = blockIdx.x;
  const float* D_s = D + (size_t)s * K * z;
  const float* adj_s = adj + (size_t)s * z * z;
  const RowPlan plan = row_plan(adj_s, z * z);
  unsigned uses = 0;
  if (slots > 0) {  // the row streams in while D loads
    row_init(st);
    row_begin(st, plan, uses);
  }

  // D[s] in shared memory as D lies ([K][z]; each thread its columns, the
  // K levels unrolled: coalesced, independent loads), and the check under
  // which the list keeps every byte: D >= 0 (no NaN) over the tile
  int ok = 1;
  for (int v = threadIdx.x; v < z; v += blockDim.x) {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const float d = D_s[(size_t)j * z + v];
      d_sh[j * z + v] = d;
      ok &= d >= 0.0f;
    }
    next_u[v] = 0;
    if (slots > 0) list.deg[v] = 0;
  }
  bool sparse = __syncthreads_and(ok) && slots > 0;
  if (sparse) {  // one staged pass: the finite entries into the list
    if (z <= (int)blockDim.x) {  // a column a thread: its count in registers
      const int v = threadIdx.x;
      int u = 0, n = 0;
      row_stream(st, plan, uses, [&](const float* buf, int f0, int f1) {
        if (v < z) append_column(buf, f0, f1, z, slots, 1, list, v, u, n);
      });
      if (v < z) list.deg[v] = n;
    } else {
      row_stream(st, plan, uses, [&](const float* buf, int f0, int f1) {
        append_in_edges(buf, f0, f1, z, slots, 1, list, next_u);
      });
    }
    int over = 0;
    for (int v = threadIdx.x; v < z; v += blockDim.x)
      over |= list.deg[v] > slots;
    sparse = !__syncthreads_or(over);
  } else if (slots > 0) {
    row_drain(st, plan, uses);  // the copies begun above must land first
  }

  for (int v = threadIdx.x; v < z; v += blockDim.x) {
    float T[K];
#pragma unroll
    for (int i = 0; i < K; ++i) T[i] = KT_INF;
    fold_own<K>(T, d_sh + v, z);
    if (sparse) {
      const int n = list.deg[v];
      for (int i = 0; i < n; ++i) {
        const InEdge e = list.e[i * z + v];
        fold_source<K>(T, d_sh + e.at, z, e.w);
      }
    } else {  // every u, adj[s,u,v] read coalesced across the warp
      for (int u = 0; u < z; ++u)
        fold_source<K>(T, d_sh + u, z, __ldg(adj_s + (size_t)u * z + v));
    }
#pragma unroll
    for (int j = 0; j < K; ++j) out[(size_t)s * K * z + (size_t)j * z + v] = T[j];
  }
  if (threadIdx.x == 0) path_out[s] = sparse;
}

template <int K>
__global__ void ktrop_solve_kernel(const float* __restrict__ adj,
                                   const int32_t* __restrict__ src,
                                   float* __restrict__ D_out,
                                   int32_t* __restrict__ iters_out,
                                   int32_t* __restrict__ list_out, int z,
                                   int max_iters, int slots) {
  extern __shared__ __align__(16) float smem[];
  float* cur = smem;          // [K][z]
  float* nxt = smem + K * z;  // [K][z]
  const InEdgeList list(nxt + K * z, z, slots);
  const int s = blockIdx.x;
  const float* adj_s = adj + (size_t)s * z * z;

  // D0: level 0 is 0 at the source, all else INF
  const int sv = src[s];
  for (int i = threadIdx.x; i < z * K; i += blockDim.x)
    cur[i] = (sv >= 0 && sv < z && i == sv) ? 0.0f : KT_INF;
  // the one read of the row (which also checks every kept weight >= 0);
  // its closing barrier also publishes D0
  const bool use_list = build_in_edges(adj_s, z, slots, 1, list);

  int it = 0;
  while (it < max_iters) {
    int changed = 0;
    for (int v = threadIdx.x; v < z; v += blockDim.x) {
      // v's own levels are distinct and ascending below INF (D0 and every
      // relaxation's output are), so folding them into an empty list gives
      // the levels themselves: the list starts as their copy
      float T[K];
#pragma unroll
      for (int j = 0; j < K; ++j) T[j] = cur[j * z + v];
      if (use_list) {
        const int n = list.deg[v];
        for (int i = 0; i < n; ++i) {
          const InEdge e = list.e[i * z + v];
          fold_source<K>(T, cur + e.at, z, e.w);
        }
      } else {
        for (int u = 0; u < z; ++u)
          fold_source<K>(T, cur + u, z, __ldg(adj_s + (size_t)u * z + v));
      }
#pragma unroll
      for (int j = 0; j < K; ++j) {
        changed |= T[j] < cur[j * z + v];
        nxt[j * z + v] = T[j];
      }
    }
    ++it;
    const int any = __syncthreads_or(changed);
    float* t = cur;
    cur = nxt;
    nxt = t;
    if (!any) break;
  }

  for (int i = threadIdx.x; i < z * K; i += blockDim.x)
    D_out[(size_t)s * K * z + i] = cur[i];  // [K][z], as D_out
  if (threadIdx.x == 0) {
    iters_out[s] = it;
    list_out[s] = use_list;
  }
}

int block_threads(int z) {
  const int t = ((z + 31) / 32) * 32;
  return t < 256 ? t : 256;
}

// The step kernel's shared memory: the staging ring, D[s] [K][z], next
// sources [z] and the in-edge list.
size_t step_smem(int k, int z, int slots, int stages) {
  return row_stage_smem(stages) + (size_t)k * z * 4 + (size_t)z * 4 +
         in_edges_smem(z, slots);
}

template <int K>
cudaError_t set_step_smem(size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(
      ktrop_relax_step_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(ktrop_relax_step_kernel<K>,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

template <int K>
int step_blocks_per_sm(int z, int slots, int stages) {
  const size_t smem = step_smem(K, z, slots, stages);
  int blocks = 0;
  if (set_step_smem<K>(smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, ktrop_relax_step_kernel<K>, block_threads(z), smem) !=
          cudaSuccess)
    return -1;
  return blocks;
}

template <int K>
cudaError_t launch_step(const float* D, const float* adj, float* out,
                        int32_t* path, int S, int z, int slots, int stages,
                        cudaStream_t stream) {
  const size_t smem = step_smem(K, z, slots, stages);
  cudaError_t err = set_step_smem<K>(smem);
  if (err != cudaSuccess) return err;
  ktrop_relax_step_kernel<K><<<S, block_threads(z), smem, stream>>>(
      D, adj, out, path, z, slots, stages);
  return cudaGetLastError();
}

size_t solve_smem(int k, int z, int slots) {
  return 2 * (size_t)k * z * 4 + in_edges_smem(z, slots);
}

// Opt the fused solve into `smem` bytes per block and the largest
// shared-memory carveout, so that as many blocks share an SM as fit.
template <int K>
cudaError_t set_solve_smem(size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(
      ktrop_solve_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(ktrop_solve_kernel<K>,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

template <int K>
int solve_blocks_per_sm(int z, int slots) {
  const size_t smem = solve_smem(K, z, slots);
  int blocks = 0;
  if (set_solve_smem<K>(smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, ktrop_solve_kernel<K>, block_threads(z), smem) !=
          cudaSuccess)
    return -1;
  return blocks;
}

template <int K>
cudaError_t launch_solve(const float* adj, const int32_t* src, float* D,
                         int32_t* iters, int32_t* list, int S, int z,
                         int max_iters, int slots, cudaStream_t stream) {
  const size_t smem = solve_smem(K, z, slots);
  cudaError_t err = set_solve_smem<K>(smem);
  if (err != cudaSuccess) return err;
  ktrop_solve_kernel<K><<<S, block_threads(z), smem, stream>>>(
      adj, src, D, iters, list, z, max_iters, slots);
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
// adj [S,z,z] f32 (any 4-byte aligned start), path [S] int32 (1 where the
// row folded its in-edge list, 0 where it scanned every u).  `slots` is the
// list's slots per vertex (0: every row dense, the row not staged),
// `stages` the chunks in flight (4 to kRowMaxStages); z*z < 2^31.  Returns
// cudaGetLastError() after the launch (0 = launched).
int ktrop_relax_step(const void* D, const void* adj, void* out, void* path,
                     int S, int k, int z, int slots, int stages,
                     void* stream) {
  if (stages < 1 || stages > kRowMaxStages) return (int)cudaErrorInvalidValue;
#define KT_STEP(K_)                                                         \
  (int)launch_step<K_>((const float*)D, (const float*)adj, (float*)out,     \
                       (int32_t*)path, S, z, slots, stages,                 \
                       (cudaStream_t)stream)
  KT_DISPATCH_K(k, KT_STEP)
#undef KT_STEP
}

// Blocks of ktrop_relax_step that one SM holds at once for this k, z and
// list size (-1 if the query failed).
int ktrop_step_blocks_per_sm(int k, int z, int slots, int stages) {
#define KT_SOCC(K_) step_blocks_per_sm<K_>(z, slots, stages)
  KT_DISPATCH_K(k, KT_SOCC)
#undef KT_SOCC
}

// The staged row read's layout (row_stage.cuh): 0 -> most stages, 1 ->
// floats per chunk, 2 -> bytes of the staging area at one stage; the
// launcher checks it.
int ktrop_row_stage(int what) {
  return what == 0 ? kRowMaxStages
                   : what == 1 ? kRowChunk : (int)row_stage_smem(1);
}

// adj [S,z,z] f32; src [S] int32; outputs D [S,k,z] f32, iters [S] int32
// (the relaxations each row ran, at most max_iters) and list [S] int32 (1
// where the row ran from its in-edge list, 0 where it ran the dense loop).
// `slots` is the list's slots per vertex (0: no list).
int ktrop_solve(const void* adj, const void* src, void* D, void* iters,
                void* list, int S, int k, int z, int max_iters, int slots,
                void* stream) {
#define KT_SOLVE(K_)                                                      \
  (int)launch_solve<K_>((const float*)adj, (const int32_t*)src, (float*)D, \
                        (int32_t*)iters, (int32_t*)list, S, z, max_iters,  \
                        slots, (cudaStream_t)stream)
  KT_DISPATCH_K(k, KT_SOLVE)
#undef KT_SOLVE
}

// Blocks of ktrop_solve that one SM holds at once for this k, z and list
// size (-1 if the query failed).
int ktrop_solve_blocks_per_sm(int k, int z, int slots) {
#define KT_OCC(K_) solve_blocks_per_sm<K_>(z, slots)
  KT_DISPATCH_K(k, KT_OCC)
#undef KT_OCC
}

}  // extern "C"
