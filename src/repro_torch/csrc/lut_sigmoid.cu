// lut_sigmoid: the paper's LUT sigmoid (Fig. 4), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/lut_activation/kernel.py:37
// (lut_sigmoid_vmem, pallas_call at :48).  For int32 Q(f) input x and an
// int16 Q0.15 table of n entries: idx = clamp(|x|, 0, n-1), v = table[idx],
// out = x < 0 ? 2^value_frac - v : v, as int32 — identical to
// repro.kernels.lut_activation.ref.lut_sigmoid_ref and to the plain version
// in repro_torch/kernels/lut_activation.py.
//
// Two placements of the table, the paper's WRAM and MRAM variants:
//   kShared = true   each block stages the table (40 KB for 20*1024 entries)
//                    in shared memory, then gathers from there — the WRAM
//                    scratchpad placement (LOG-INT32-LUT (WRAM));
//   kShared = false  every gather reads the table from global memory through
//                    the read-only path, where it stays L1/L2-resident — the
//                    MRAM bank placement (LOG-INT32-LUT (MRAM)).
// Both give the same values.
//
// Bound on the H100: memory.  One call must read 4 bytes and write 4 bytes
// per element, plus the table once (0.0150 ms at [2048, 3072]).  So the
// design is a stream that keeps bytes in flight:
//  - a persistent grid (lut_sigmoid_plan in kernels/lut_activation.py:
//    SMs x blocks per SM) grid-strides over 16-byte vectors of 4 elements;
//    each thread issues all kUnroll loads of a round before its first
//    lookup, so 64 bytes a thread are in flight;
//  - the elements before the first 16-byte boundary of x (the head, at most
//    3) and after the last whole vector (the tail, at most 3) go one at a
//    time; the wrapper allocates out as far past a boundary as x, so the
//    two stream as vectors together whatever x's offset;
//  - WRAM: the table is copied into shared memory with 16-byte cp.async
//    after the block's first round of loads is issued, so those loads are in
//    flight while the copies run; the block waits for its copies and syncs
//    once, before its first lookup.  Two 512-thread blocks an SM stage
//    10.8 MB from L2 in all (264 tables of 40 KB), half of what a grid
//    capped at 4 blocks an SM read.
//
// Edge: at x = INT32_MIN, |x| wraps to a negative number; the reference's
// table[idx] normalizes and then clamps that index to 0.  The kernel tests
// for INT32_MIN explicitly and takes |x| only where -x cannot overflow.  (A
// first version took |x| as 0u - (uint32_t)x and clamped the signed result
// at 0: the compiler treated that as a non-negative abs, dropped the lower
// clamp, and the global-memory placement read 4 GB before the table.)
#include <cstdint>
#include <cuda_runtime.h>

#include "sm90.cuh"

namespace {

// The 16-byte vectors a thread loads before its first lookup of a round
// (lut_activation.py's UNROLL).
constexpr int kUnroll = 4;
constexpr int kMaxThreads = 1024;

template <bool kShared>
__device__ __forceinline__ int32_t sigmoid_of(int32_t xv,
                                              const int16_t* table,
                                              int n_table, int32_t one) {
  int32_t idx = 0;  // INT32_MIN: the reference clamps its wrapped |x| to 0
  if (xv != INT32_MIN) {
    const int32_t mag = xv < 0 ? -xv : xv;  // no overflow without INT32_MIN
    idx = mag < n_table - 1 ? mag : n_table - 1;
  }
  int32_t v;
  if constexpr (kShared)
    v = table[idx];
  else
    v = __ldg(table + idx);
  return xv < 0 ? one - v : v;
}

// Copies the table into shared memory: 16-byte cp.async for the whole
// chunks, plain loads for the last n_table % 8 entries; then waits for the
// block's copies and syncs.
__device__ __forceinline__ void stage_table(int16_t* table_s,
                                            const int16_t* __restrict__ table,
                                            int n_table) {
  const int chunks = n_table / 8;
  const uint32_t dst = sm90::smem_u32(table_s);
  for (int c = threadIdx.x; c < chunks; c += blockDim.x)
    sm90::cp_async16(dst + 16 * c, table + 8 * c);
  sm90::cp_async_commit();
  for (int i = 8 * chunks + threadIdx.x; i < n_table; i += blockDim.x)
    table_s[i] = table[i];
  sm90::cp_async_wait<0>();
  __syncthreads();
}

template <bool kShared>
__global__ void __launch_bounds__(kMaxThreads)
    lut_sigmoid_kernel(const int32_t* __restrict__ x,
                       const int16_t* __restrict__ table,
                       int32_t* __restrict__ out, long long head,
                       long long vectors, long long tail, int n_table,
                       int value_frac) {
  extern __shared__ __align__(16) int16_t table_s[];
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long threads = static_cast<long long>(gridDim.x) * blockDim.x;
  const int4* __restrict__ xv = reinterpret_cast<const int4*>(x + head);
  int4* __restrict__ ov = reinterpret_cast<int4*>(out + head);
  // round r of thread tid covers vectors r * threads * kUnroll + j * threads
  // + tid: each of its kUnroll loads is one coalesced pass of the grid
  int4 r[kUnroll];
#pragma unroll
  for (int j = 0; j < kUnroll; ++j)
    if (tid + j * threads < vectors) r[j] = __ldg(xv + tid + j * threads);
  if constexpr (kShared)
    stage_table(table_s, table, n_table);  // under the first round's loads
  const int16_t* t = kShared ? table_s : table;
  const int32_t one = 1 << value_frac;
  for (long long v = tid; v < vectors; v += threads * kUnroll) {
    if (v != tid) {
#pragma unroll
      for (int j = 0; j < kUnroll; ++j)
        if (v + j * threads < vectors) r[j] = __ldg(xv + v + j * threads);
    }
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      if (v + j * threads < vectors) {
        int4 o;
        o.x = sigmoid_of<kShared>(r[j].x, t, n_table, one);
        o.y = sigmoid_of<kShared>(r[j].y, t, n_table, one);
        o.z = sigmoid_of<kShared>(r[j].z, t, n_table, one);
        o.w = sigmoid_of<kShared>(r[j].w, t, n_table, one);
        ov[v + j * threads] = o;
      }
    }
  }
  for (long long i = tid; i < head; i += threads)
    out[i] = sigmoid_of<kShared>(__ldg(x + i), t, n_table, one);
  const long long t0 = head + 4 * vectors;
  for (long long i = tid; i < tail; i += threads)
    out[t0 + i] = sigmoid_of<kShared>(__ldg(x + t0 + i), t, n_table, one);
}

}  // namespace

// C entry point bound with ctypes.  The launch is lut_sigmoid_plan's: `head`
// elements, then `vectors` 16-byte vectors from x + head and out + head (both
// 16-byte aligned when vectors > 0), then `tail` elements; `grid` blocks of
// `block` threads, `smem` bytes of shared memory (the table, 16-byte
// aligned, for the shared placement).  `shared` selects the placement.
// Launches on `stream`; returns the first CUDA error (0 = launched).  The
// caller checks types, contiguity, and for the shared placement a 16-byte
// aligned table of at most 48 KB.
extern "C" int lut_sigmoid_launch(const void* x, const void* table, void* out,
                                  long long head, long long vectors,
                                  long long tail, int n_table, int value_frac,
                                  int shared, int grid, int block, int smem,
                                  void* stream) {
  if (grid < 1 || block < 1 || block > kMaxThreads)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const int32_t*>(x);
  const auto* tp = static_cast<const int16_t*>(table);
  auto* op = static_cast<int32_t*>(out);
  if (shared)
    lut_sigmoid_kernel<true><<<grid, block, smem, s>>>(
        xp, tp, op, head, vectors, tail, n_table, value_frac);
  else
    lut_sigmoid_kernel<false><<<grid, block, 0, s>>>(
        xp, tp, op, head, vectors, tail, n_table, value_frac);
  return static_cast<int>(cudaGetLastError());
}
