// emb_gather: shard-local embedding row lookup, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/sparse_gather/kernel.py:48
// (emb_gather, pallas_call at :56).  Per simulated core c and lookup b:
//   out[c,b,:] = sum over the rows r with ids[c,r] == idx[b] of table[c,r,:]
// summed from zero in ascending r.  A shard owns each id at most once, so
// this is a copy of the row (0.0f + row in float32: a -0.0 entry comes back
// as +0.0, as from the reference's one-hot dot) when core c owns idx[b] and
// exact zeros when it does not (ROW_PAD_ID = -1 pad slots and IDX_PAD = -2
// lookups never match a real id); summing the cores' partials, the fabric
// reduce, rebuilds the looked-up rows.  Equal to
// repro/kernels/sparse_gather/ref.py and to the plain version in
// repro_torch/kernels/sparse_gather.py on finite tables: the reference's
// one-hot dot multiplies every row by 0 or 1, so a NaN or an infinity
// anywhere in a shard reaches every lookup of that shard there; this kernel
// reads only the matching rows.  Integer sums wrap in uint32_t, as XLA's
// int32 dot does.
//
// Inputs: table [C, R, D] (int32 Q(f) or float32), the table's gather index
// (per core its ids sorted ascending, sorted_ids [C, R], and the row each
// came from, rows [C, R]; equal ids in ascending row order), idx int32 [B].
// The index is built once per placement (kernels/sparse_gather.py,
// gather_index).  Output: out [C, B, D]: every element is written, the
// pairs that hit twice (zeros, then the row).
//
// Bound on the H100: bytes.  The function moves the [C, B, D] partials
// (8.4 MB at the EMB main shape C=2048, B=64, D=16), the B rows it looks up
// and idx: ~2.5 us at 3.35 TB/s.  The kernel also reads the sorted ids (1.9
// MB), and its time is set by latency: each output chunk waits on a chain
// of loads (ids, search, row), so the design keeps many chains in flight.
//
// Design: every (core, lookup, 16-byte column chunk) pair is independent.
// A block of 128 threads takes 256 pairs of one core, two a thread (at the
// main shape one block per core, and the 2048 blocks fit the card at once).
// A thread loads its lookups' ids and stores zeros to both of its pairs at
// once (16-byte streaming stores, 4-byte words where D % 4 != 0 or a
// pointer is not 16-byte aligned; neighbouring threads on neighbouring
// chunks), since almost every pair misses.  The block then stages the
// core's sorted ids in shared memory, four loads in flight a thread (R <=
// 12288; a longer shard is searched where it lies in global memory), and
// binary-searches both of a thread's keys in lockstep, ceil(log2 R) probes.
// A hit reads its row number and its row chunk from global memory and
// stores the chunk over its zeros (the same thread, so in order); a miss
// reads nothing more.
#include <cstdint>
#include <cuda_runtime.h>

#include "emb_rows.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kPerThread = 2;
constexpr int kPairsPerBlock = kThreads * kPerThread;
constexpr int kStageUnroll = 4;
constexpr int kMaxStagedRows = 12288;  // sorted ids: 48 KB

template <bool kFloat, typename V>
__global__ void __launch_bounds__(kThreads)
    emb_gather_kernel(const V* __restrict__ table,
                      const int32_t* __restrict__ sorted_ids,
                      const int32_t* __restrict__ sorted_rows,
                      const int32_t* __restrict__ idx, V* __restrict__ out,
                      int n_rows, int top, int n_vec, int n_idx, int staged) {
  extern __shared__ int32_t smem[];
  const long long core = blockIdx.y;
  const int pairs = n_idx * n_vec;
  const int p0 = blockIdx.x * kPairsPerBlock + threadIdx.x;
  int32_t key[kPerThread];
#pragma unroll
  for (int u = 0; u < kPerThread; ++u) {  // in flight while ids stage
    const int p = p0 + u * kThreads;
    key[u] = 0;
    if (p >= pairs) continue;
    key[u] = __ldg(idx + p / n_vec);
    // zeros first: almost every pair misses, so the output streams out
    // while the index stages; a hit overwrites its zeros below
    const int b = p / n_vec;
    __stcs(out + (core * n_idx + b) * n_vec + (p - b * n_vec), V{});
  }
  const int32_t* keys = sorted_ids + core * n_rows;
  const int32_t* rows = sorted_rows + core * n_rows;
  if (staged) {  // kStageUnroll loads in flight per thread
    for (int i0 = threadIdx.x; i0 < n_rows; i0 += kStageUnroll * kThreads) {
      int32_t k[kStageUnroll];
#pragma unroll
      for (int u = 0; u < kStageUnroll; ++u) {
        const int i = i0 + u * kThreads;
        k[u] = i < n_rows ? __ldg(keys + i) : 0;
      }
#pragma unroll
      for (int u = 0; u < kStageUnroll; ++u)
        if (i0 + u * kThreads < n_rows) smem[i0 + u * kThreads] = k[u];
    }
    __syncthreads();
    keys = smem;
  }
  int pos[kPerThread];
  emb::lower_bounds<kPerThread>(keys, n_rows, top, key, pos);
  const V* tab_c = table + core * n_rows * n_vec;
#pragma unroll
  for (int u = 0; u < kPerThread; ++u) {
    const int p = p0 + u * kThreads;
    if (p >= pairs || pos[u] >= n_rows || keys[pos[u]] != key[u]) continue;
    const int b = p / n_vec;
    const int v = p - b * n_vec;
    V acc{};  // 0.0f + row: a -0.0 entry comes back as +0.0
    for (int r = pos[u]; r < n_rows && keys[r] == key[u]; ++r)
      acc = emb::vadd<kFloat>(
          acc, __ldg(tab_c + static_cast<long long>(__ldg(rows + r)) * n_vec +
                     v));
    out[(core * n_idx + b) * n_vec + v] = acc;  // after its zero, in order
  }
}

template <bool kFloat, typename V>
int launch(const void* table, const void* sorted_ids, const void* rows,
           const void* idx, void* out, int n_cores, int n_rows, int n_vec,
           int n_idx, cudaStream_t s) {
  const int staged = n_rows <= kMaxStagedRows;
  const size_t shm = staged ? static_cast<size_t>(n_rows) * 4 : 0;
  const dim3 grid(static_cast<unsigned>(
                      (n_idx * n_vec + kPairsPerBlock - 1) / kPairsPerBlock),
                  static_cast<unsigned>(n_cores));
  emb_gather_kernel<kFloat, V><<<grid, kThreads, shm, s>>>(
      static_cast<const V*>(table), static_cast<const int32_t*>(sorted_ids),
      static_cast<const int32_t*>(rows), static_cast<const int32_t*>(idx),
      static_cast<V*>(out), n_rows, emb::pow2_floor(n_rows), n_vec, n_idx,
      staged);
  return static_cast<int>(cudaGetLastError());
}

template <bool kFloat>
int launch_dtype(const void* table, const void* sorted_ids, const void* rows,
                 const void* idx, void* out, int n_cores, int n_rows, int dim,
                 int n_idx, cudaStream_t s) {
  const void* ptrs[] = {table, out};
  if (emb::vec4(dim, ptrs, 2))
    return launch<kFloat, uint4>(table, sorted_ids, rows, idx, out, n_cores,
                                 n_rows, dim / 4, n_idx, s);
  return launch<kFloat, uint32_t>(table, sorted_ids, rows, idx, out, n_cores,
                                  n_rows, dim, n_idx, s);
}

}  // namespace

// C entry point bound with ctypes.  Launches on `stream`; returns
// cudaGetLastError() (0 = launched).  The caller checks types, shapes,
// contiguity, 1 <= C <= 65535, R >= 1, B >= 1 and B * D < 2^31; is_float
// picks float32 over int32.
extern "C" int emb_gather_launch(const void* table, const void* sorted_ids,
                                 const void* rows, const void* idx, void* out,
                                 int n_cores, int n_rows, int dim, int n_idx,
                                 int is_float, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_float)
    return launch_dtype<true>(table, sorted_ids, rows, idx, out, n_cores,
                              n_rows, dim, n_idx, s);
  return launch_dtype<false>(table, sorted_ids, rows, idx, out, n_cores,
                             n_rows, dim, n_idx, s);
}
