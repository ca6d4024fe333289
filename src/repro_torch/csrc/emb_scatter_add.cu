// emb_scatter_add: duplicate-safe batched row update of a sharded embedding
// table, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/sparse_gather/kernel.py:81
// (emb_scatter_add, pallas_call at :92).  For every table row (c, r):
//   out[c,r,:] = table[c,r,:] + sum over b with ids[c,r] == idx[b] of upd[b,:]
// into a new table; the input is never written.  The reference computes
// table + dot(onehot, upd): the duplicates of a row are summed first and the
// table is added once.  Here each row's matches are summed in batch order
// into an accumulator that starts at zero, then added to the row, so
// int32 is exact (uint32_t arithmetic wraps as XLA's int32 dot does) and a
// row hit at most twice is bit-identical in float32 too.  A float32 row hit
// three or more times may differ from the reference in the last bits, where
// XLA's dot groups the batch axis otherwise.  No atomics: every output
// element is written by one thread, so the result does not depend on the
// schedule.  Unmatched float32 rows come out as table + 0.0f, as in the
// reference (a -0.0 entry becomes +0.0).
//
// Inputs: table [C*R, D] (int32 Q(f) or float32, the cores' shards back to
// back), ids int32 [C*R], idx int32 [B], upd [B, D] of the table's type.
// Output: out [C*R, D].
//
// Bound on the H100: bytes.  The table is read and written once (2 x 30.8 MB
// for the EMB user table, 2048 x 235 x 16 float32) beside the ids (1.9 MB)
// and the batch; the C*R*B id compares (30.8M at B = 64, up to ~250M for a
// padded deferred flush) take less at the CUDA cores' int32 rate.
//
// Design: a block owns 256 consecutive rows.  It stages the batch's ids in
// shared memory (1024 at a time) and copies its rows' slab of the table to
// the output, fully coalesced, with four 16-byte loads in flight per thread
// where the width allows, so the copy runs at memory rate rather than at
// one load's latency.  Then each thread takes one row and compares its id
// with every staged id (a broadcast read).  A thread whose row matched adds
// the matching update rows (read through L1; a batch row matches one row of
// one core) into 16 register accumulators and, past the barrier after the
// copy, rewrites its row as table + sum.  Widths over 16 columns take one
// pass per 16 columns.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 1024;
constexpr int kCols = 16;
constexpr int kUnroll = 4;  // loads in flight per thread in the copy

template <typename T>
struct Sum;  // accumulator of one column: float, or uint32_t (wrapping)

template <>
struct Sum<float> {
  using Acc = float;
  __device__ static Acc add(Acc a, float v) { return a + v; }
  __device__ static float done(float t, Acc a) { return t + a; }
  __device__ static uint32_t copy(uint32_t bits) {  // table + 0.0f
    return __float_as_uint(__uint_as_float(bits) + 0.0f);
  }
};

template <>
struct Sum<int32_t> {
  using Acc = uint32_t;
  __device__ static Acc add(Acc a, int32_t v) {
    return a + static_cast<uint32_t>(v);
  }
  __device__ static int32_t done(int32_t t, Acc a) {
    return static_cast<int32_t>(static_cast<uint32_t>(t) + a);
  }
  __device__ static uint32_t copy(uint32_t bits) { return bits; }
};

template <typename T>
__device__ uint32_t copy_bits(uint32_t bits) {
  return Sum<T>::copy(bits);
}

template <typename T>
__device__ uint4 copy_bits(uint4 v) {
  return make_uint4(Sum<T>::copy(v.x), Sum<T>::copy(v.y), Sum<T>::copy(v.z),
                    Sum<T>::copy(v.w));
}

// dst[i] = copy_bits(src[i]) for i < n over the block's threads, kUnroll
// loads issued before their stores
template <typename T, typename V>
__device__ void copy_slab(const V* __restrict__ src, V* __restrict__ dst,
                          long long n) {
  for (long long i0 = threadIdx.x; i0 < n; i0 += kUnroll * kThreads) {
    V v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (i0 + u * kThreads < n) v[u] = __ldg(src + i0 + u * kThreads);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (i0 + u * kThreads < n) dst[i0 + u * kThreads] = copy_bits<T>(v[u]);
  }
}

template <typename T>
__global__ void emb_scatter_add_kernel(const T* __restrict__ table,
                                       const int32_t* __restrict__ ids,
                                       const int32_t* __restrict__ idx,
                                       const T* __restrict__ upd,
                                       T* __restrict__ out, long long n_rows,
                                       int dim, int n_idx, int vec) {
  __shared__ int32_t idx_s[kTile];
  const long long row0 = static_cast<long long>(blockIdx.x) * kThreads;
  const long long left = n_rows - row0;
  const long long rows = left < kThreads ? left : kThreads;

  // 1. stage the batch's ids (all of them when they fit one tile), and
  //    out = table (+ 0.0f) over the block's rows
  const bool one_tile = n_idx <= kTile;
  if (one_tile)
    for (int j = threadIdx.x; j < n_idx; j += kThreads) idx_s[j] = idx[j];
  const long long e0 = row0 * dim;
  if (vec)  // dim % 4 == 0 and 16-byte aligned bases: 4 elements a load
    copy_slab<T>(reinterpret_cast<const uint4*>(table + e0),
                 reinterpret_cast<uint4*>(out + e0), rows * dim / 4);
  else
    copy_slab<T>(reinterpret_cast<const uint32_t*>(table + e0),
                 reinterpret_cast<uint32_t*>(out + e0), rows * dim);
  __syncthreads();  // the copy is done and the first tile staged

  // 2. one thread per row: sum its matches in batch order, then rewrite it
  const bool live = threadIdx.x < rows;
  const long long row = row0 + threadIdx.x;
  const int32_t key = live ? __ldg(ids + row) : 0;
  for (int d0 = 0; d0 < dim; d0 += kCols) {
    typename Sum<T>::Acc acc[kCols];
#pragma unroll
    for (int k = 0; k < kCols; ++k) acc[k] = 0;
    bool hit = false;
    for (int t0 = 0; t0 < n_idx; t0 += kTile) {
      const int n_t = n_idx - t0 < kTile ? n_idx - t0 : kTile;
      if (!one_tile) {
        __syncthreads();  // the previous tile is consumed
        for (int j = threadIdx.x; j < n_t; j += kThreads)
          idx_s[j] = idx[t0 + j];
        __syncthreads();
      }
      if (!live) continue;
      for (int j = 0; j < n_t; ++j) {
        if (idx_s[j] != key) continue;
        hit = true;
        const T* u = upd + static_cast<long long>(t0 + j) * dim + d0;
#pragma unroll
        for (int k = 0; k < kCols; ++k)
          if (d0 + k < dim) acc[k] = Sum<T>::add(acc[k], __ldg(u + k));
      }
    }
    if (hit) {
      const T* t = table + row * dim + d0;
      T* o = out + row * dim + d0;
#pragma unroll
      for (int k = 0; k < kCols; ++k)
        if (d0 + k < dim) o[k] = Sum<T>::done(__ldg(t + k), acc[k]);
    }
  }
}

}  // namespace

// C entry point bound with ctypes.  Launches on `stream`; returns
// cudaGetLastError() (0 = launched).  The caller checks types, shapes and
// contiguity, and that C*R >= 1 and B >= 1; is_float picks float32 over
// int32.
extern "C" int emb_scatter_add_launch(const void* table, const void* ids,
                                      const void* idx, const void* upd,
                                      void* out, long long n_rows, int dim,
                                      int n_idx, int is_float, void* stream) {
  const unsigned blocks =
      static_cast<unsigned>((n_rows + kThreads - 1) / kThreads);
  const int vec = dim % 4 == 0 &&
                  reinterpret_cast<uintptr_t>(table) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(out) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* ip = static_cast<const int32_t*>(ids);
  const auto* xp = static_cast<const int32_t*>(idx);
  if (is_float)
    emb_scatter_add_kernel<float><<<blocks, kThreads, 0, s>>>(
        static_cast<const float*>(table), ip, xp,
        static_cast<const float*>(upd), static_cast<float*>(out), n_rows, dim,
        n_idx, vec);
  else
    emb_scatter_add_kernel<int32_t><<<blocks, kThreads, 0, s>>>(
        static_cast<const int32_t*>(table), ip, xp,
        static_cast<const int32_t*>(upd), static_cast<int32_t*>(out), n_rows,
        dim, n_idx, vec);
  return static_cast<int>(cudaGetLastError());
}
