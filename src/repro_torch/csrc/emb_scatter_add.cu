// emb_scatter_add: duplicate-safe batched row update of a sharded embedding
// table, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/sparse_gather/kernel.py:81
// (emb_scatter_add, pallas_call at :92).  For every table row (c, r):
//   out[c,r,:] = table[c,r,:] + sum over b with ids[c,r] == idx[b] of upd[b,:]
// into a new table; the input is never written.  The reference computes
// table + dot(onehot, upd): the duplicates of a row are summed first and the
// table is added once.  Here each id's update rows are summed in batch order
// into an accumulator that starts at zero, then added to the row, so int32
// is exact (uint32_t arithmetic wraps as XLA's int32 dot does) and a row hit
// at most twice is bit-identical in float32 too.  A float32 row hit three or
// more times may differ from the reference in the last bits, where XLA's dot
// groups the batch axis otherwise.  No atomics: every output element is
// written once, by one thread, so the result does not depend on the
// schedule.  Unmatched float32 rows come out as table + 0.0f, as in the
// reference (a -0.0 entry becomes +0.0).
//
// Inputs: table [C*R, D] (int32 Q(f) or float32, the cores' shards back to
// back), ids int32 [C*R], idx int32 [B], upd [B, D] of the table's type, and
// scratch for B sorted ids and B x D batch sums.  Output: out [C*R, D].
//
// Bound on the H100: bytes.  The table is read and written once (2 x 30.8 MB
// for the EMB user table, 2048 x 235 x 16 float32) beside the ids (1.9 MB)
// and the batch: 19.0 us at 3.35 TB/s.
//
// Design, two kernels in order on the stream:
//  1. batch_plan, once per call: the batch's ids sorted ascending (a stable
//     rank sort: each thread counts the ids that go before its own, over
//     tiles of the batch and its update rows staged in shared memory), and
//     at the sorted position of each id's first occurrence the sum of its
//     update rows, in batch order from zero, read from shared memory.  One
//     thread per (batch id, 16-byte column chunk).
//  2. the stream, launched as a programmatic dependent of the plan, so that
//     its blocks start, and issue their table loads, while the plan runs.
//     Each thread takes four 16-byte chunks of the table (4-byte words where
//     D % 4 != 0 or a pointer is not 16-byte aligned), a block's 1,024
//     consecutive, neighbouring threads on neighbouring chunks: their table
//     loads and their rows' ids first, then four binary searches of the
//     sorted batch ids in lockstep, then out = table + (the row's batch sum,
//     or +0).  A block sorts a batch of up to 256 ids itself in shared
//     memory, in the plan's order, and waits for the plan
//     (griddepcontrol.wait) only before its first chunk that matches and
//     needs its sum.  Besides, one thread of the last block waits before it
//     exits, so that the stream grid never ends before the plan, and what
//     runs next on the stream (and may be handed the scratch) runs after
//     both.  (Every block waiting made the users-table scatter ~25% slower
//     on the H100.)  With a larger batch a block waits first and takes the
//     plan's sorted ids (staged in shared memory when B <= 12288, else
//     searched in global memory).  Every output element is read once and
//     written once; a row that matches reads one chunk of its sum more, and
//     no thread keeps an accumulator.  (A grid sized to the SMs, each
//     thread looping, ran slower on the H100.)
#include <cstdint>
#include <cuda_runtime.h>

#include "emb_rows.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;              // table chunks in flight per thread
constexpr int kPlanTile = 512;          // batch rows staged per plan tile
constexpr int kPlanSmem = 48 * 1024;    // the plan's tile budget
constexpr int kMaxStagedIds = 12288;    // sorted ids: 48 KB
constexpr int kBlockSortIds = 256;      // a stream block sorts these itself

template <bool kFloat, typename V>
__global__ void __launch_bounds__(kThreads)
    batch_plan_kernel(const int32_t* __restrict__ idx,
                      const V* __restrict__ upd, int n_idx, int n_vec,
                      int tile, int32_t* __restrict__ sorted,
                      V* __restrict__ sums) {
  // let the stream kernel launch now; it waits for this grid's writes
  asm volatile("griddepcontrol.launch_dependents;");
  extern __shared__ int4 smem_raw[];
  auto* ids_s = reinterpret_cast<int32_t*>(smem_raw);
  auto* upd_s = reinterpret_cast<V*>(ids_s + tile + (-tile & 3));
  const long long t =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const bool live = t < static_cast<long long>(n_idx) * n_vec;
  const int j = live ? static_cast<int>(t / n_vec) : 0;
  const int c =
      live ? static_cast<int>(t - static_cast<long long>(j) * n_vec) : 0;
  const int32_t key = live ? __ldg(idx + j) : 0;
  int rank = 0;
  bool first = true;  // no earlier batch position holds this id (a thread
                      // past the batch stands in for position 0's column 0)
  V acc{};            // +0.0f / 0
  for (int t0 = 0; t0 < n_idx; t0 += tile) {
    const int n_t = n_idx - t0 < tile ? n_idx - t0 : tile;
    __syncthreads();  // the previous tile is consumed
    for (int k = threadIdx.x; k < n_t; k += kThreads) ids_s[k] = idx[t0 + k];
    const V* src = upd + static_cast<long long>(t0) * n_vec;
    for (int k = threadIdx.x; k < n_t * n_vec; k += kThreads)
      upd_s[k] = __ldg(src + k);
    __syncthreads();
    for (int k = 0; k < n_t; ++k) {
      const int32_t v = ids_s[k];
      const bool before = t0 + k < j;
      rank += (v < key) | ((v == key) & before);
      if (v == key) {
        if (before)
          first = false;
        else if (first)
          acc = emb::vadd<kFloat>(acc, upd_s[k * n_vec + c]);
      }
    }
  }
  if (!live) return;
  if (c == 0) sorted[rank] = key;
  if (first) sums[static_cast<long long>(rank) * n_vec + c] = acc;
}

template <bool kFloat, typename V>
__global__ void __launch_bounds__(kThreads)
    emb_scatter_add_kernel(const V* __restrict__ table,
                           const int32_t* __restrict__ ids,
                           const int32_t* __restrict__ idx,
                           const int32_t* sorted, const V* sums,
                           V* __restrict__ out, long long n, int n_vec,
                           int n_idx, int top, int staged) {
  // sorted and sums are the plan's, written while this grid runs: they are
  // read only after griddepcontrol.wait, with plain coherent loads (not
  // __restrict__, so not through the non-coherent cache, and not hoisted
  // above the wait)
  extern __shared__ int32_t smem[];
  // chunk i is column chunk i % n_vec of table row i / n_vec; a thread's
  // chunks are kThreads apart, so (row, col) advance by (s_row, s_col)
  const long long i0 =
      static_cast<long long>(blockIdx.x) * kThreads * kUnroll + threadIdx.x;
  long long row = i0 / n_vec;
  int col = static_cast<int>(i0 - row * n_vec);
  const int s_row = kThreads / n_vec;
  const int s_col = kThreads - s_row * n_vec;
  V v[kUnroll];
  int32_t key[kUnroll];
  int cc[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {  // in flight while the plan runs
    cc[u] = col;
    key[u] = 0;
    if (i0 + u * kThreads < n) {
      v[u] = __ldg(table + i0 + u * kThreads);
      key[u] = __ldg(ids + row);
    }
    row += s_row;
    col += s_col;
    if (col >= n_vec) {
      col -= n_vec;
      ++row;
    }
  }
  const int32_t* keys = sorted;
  bool planned = false;
  if (n_idx <= kBlockSortIds) {  // the plan's rank sort, in this block
    int32_t* raw = smem + n_idx;
    for (int j = threadIdx.x; j < n_idx; j += kThreads)
      raw[j] = __ldg(idx + j);
    __syncthreads();
    for (int j = threadIdx.x; j < n_idx; j += kThreads) {
      const int32_t key_j = raw[j];
      int rank = 0;
      for (int k = 0; k < n_idx; ++k) {
        const int32_t v_k = raw[k];
        rank += (v_k < key_j) | ((v_k == key_j) & (k < j));
      }
      smem[rank] = key_j;
    }
    __syncthreads();
    keys = smem;
  } else {
    asm volatile("griddepcontrol.wait;" ::: "memory");
    planned = true;
    if (staged) {
      for (int k = threadIdx.x; k < n_idx; k += kThreads) smem[k] = sorted[k];
      __syncthreads();
      keys = smem;
    }
  }
  int pos[kUnroll];
  emb::lower_bounds<kUnroll>(keys, n_idx, top, key, pos);
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long i = i0 + u * kThreads;
    if (i >= n) continue;
    V sum{};  // +0.0f / 0 for a row the batch does not touch
    if (pos[u] < n_idx && keys[pos[u]] == key[u]) {
      if (!planned) {
        asm volatile("griddepcontrol.wait;" ::: "memory");
        planned = true;
      }
      sum = sums[static_cast<long long>(pos[u]) * n_vec + cc[u]];
    }
    out[i] = emb::vadd<kFloat>(v[u], sum);
  }
  // the grid ends only after its primary: one waiting thread holds it, in
  // the block scheduled last, when the plan is long done
  if (!planned && threadIdx.x == 0 && blockIdx.x == gridDim.x - 1)
    asm volatile("griddepcontrol.wait;" ::: "memory");
}

template <bool kFloat, typename V>
int launch(const void* table, const int32_t* ids, const int32_t* idx,
           const void* upd, void* out, void* scratch, long long n_rows,
           int n_vec, int n_idx, cudaStream_t s) {
  auto* sorted = static_cast<int32_t*>(scratch);
  // the sums start at the first 16-byte boundary past the sorted ids
  V* sums = reinterpret_cast<V*>(sorted + n_idx + (-n_idx & 3));
  int tile = (kPlanSmem - 16) / static_cast<int>(4 + n_vec * sizeof(V));
  tile = tile < kPlanTile ? tile : kPlanTile;
  const size_t plan_shm = (tile + 3) / 4 * 16 + tile * n_vec * sizeof(V);
  const long long plan_threads = static_cast<long long>(n_idx) * n_vec;
  batch_plan_kernel<kFloat, V>
      <<<static_cast<unsigned>((plan_threads + kThreads - 1) / kThreads),
         kThreads, plan_shm, s>>>(idx, static_cast<const V*>(upd), n_idx,
                                  n_vec, tile, sorted, sums);
  cudaError_t err = cudaGetLastError();
  if (err) return static_cast<int>(err);

  const int staged = n_idx <= kMaxStagedIds;
  // a block that sorts its batch itself stages it beside the sorted ids
  const size_t shm = static_cast<size_t>(n_idx) * 4 *
                     (n_idx <= kBlockSortIds ? 2 : staged);
  const long long n = n_rows * n_vec;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(
      (n + kThreads * kUnroll - 1) / (kThreads * kUnroll)));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = shm;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, emb_scatter_add_kernel<kFloat, V>,
                           static_cast<const V*>(table), ids, idx,
                           static_cast<const int32_t*>(sorted),
                           static_cast<const V*>(sums), static_cast<V*>(out),
                           n, n_vec, n_idx, emb::pow2_floor(n_idx), staged);
  if (err) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <bool kFloat>
int launch_dtype(const void* table, const int32_t* ids, const int32_t* idx,
                 const void* upd, void* out, void* scratch, long long n_rows,
                 int dim, int n_idx, cudaStream_t s) {
  const void* ptrs[] = {table, upd, out, scratch};
  if (emb::vec4(dim, ptrs, 4))
    return launch<kFloat, uint4>(table, ids, idx, upd, out, scratch, n_rows,
                                 dim / 4, n_idx, s);
  return launch<kFloat, uint32_t>(table, ids, idx, upd, out, scratch, n_rows,
                                  dim, n_idx, s);
}

}  // namespace

// C entry point bound with ctypes.  Launches both kernels on `stream`;
// returns the first CUDA error (0 = launched).  The caller checks types,
// shapes and contiguity, that C*R >= 1, B >= 1 and D <= 8192, and passes a
// 16-byte aligned scratch of 4 * (B + 3 + B * D) bytes; is_float picks
// float32 over int32.
extern "C" int emb_scatter_add_launch(const void* table, const void* ids,
                                      const void* idx, const void* upd,
                                      void* out, void* scratch,
                                      long long n_rows, int dim, int n_idx,
                                      int is_float, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* ip = static_cast<const int32_t*>(ids);
  const auto* xp = static_cast<const int32_t*>(idx);
  if (is_float)
    return launch_dtype<true>(table, ip, xp, upd, out, scratch, n_rows, dim,
                              n_idx, s);
  return launch_dtype<false>(table, ip, xp, upd, out, scratch, n_rows, dim,
                             n_idx, s);
}
