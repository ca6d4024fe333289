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
//   kShared = true   the block stages the table (40 KB for 20*1024 entries)
//                    in shared memory, then gathers from there — the WRAM
//                    scratchpad placement (LOG-INT32-LUT (WRAM));
//   kShared = false  every gather reads the table from global memory, where
//                    it stays L2/L1-resident — the MRAM bank placement
//                    (LOG-INT32-LUT (MRAM)).
// Both give the same values.
//
// Bound on the H100: memory.  One call must read 4 bytes and write 4 bytes
// per element, plus the table once.  The shared-memory variant re-reads the
// table from L2 once per block, so its grid is capped at a few resident
// blocks per SM that grid-stride over the input.
//
// Edge: at x = INT32_MIN, |x| wraps to a negative number; the reference's
// table[idx] normalizes and then clamps that index to 0.  The kernel tests
// for INT32_MIN explicitly and takes |x| only where -x cannot overflow.  (A
// first version took |x| as 0u - (uint32_t)x and clamped the signed result
// at 0: the compiler treated that as a non-negative abs, dropped the lower
// clamp, and the global-memory placement read 4 GB before the table.)
#include <cstdint>
#include <cuda_runtime.h>

namespace {

template <bool kShared>
__global__ void lut_sigmoid_kernel(const int32_t* __restrict__ x,
                                   const int16_t* __restrict__ table,
                                   int32_t* __restrict__ out, long long n,
                                   int n_table, int value_frac) {
  extern __shared__ int16_t table_s[];
  const int16_t* t = table;
  if (kShared) {
    for (int i = threadIdx.x; i < n_table; i += blockDim.x)
      table_s[i] = table[i];
    __syncthreads();
    t = table_s;
  }
  const int32_t one = 1 << value_frac;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    const int32_t xv = __ldg(x + i);
    int32_t idx = 0;  // INT32_MIN: the reference clamps its wrapped |x| to 0
    if (xv != INT32_MIN) {
      const int32_t mag = xv < 0 ? -xv : xv;  // no overflow without INT32_MIN
      idx = mag < n_table - 1 ? mag : n_table - 1;
    }
    int32_t v;
    if constexpr (kShared)
      v = t[idx];
    else
      v = __ldg(t + idx);
    out[i] = xv < 0 ? one - v : v;
  }
}

constexpr int kThreads = 512;
constexpr int kSharedBlocksPerSm = 4;   // 4 * 40 KB of the SM's 227 KB
constexpr long long kMaxBlocks = 1 << 20;

}  // namespace

// C entry point bound with ctypes.  `shared` selects the placement.
// Launches on `stream`; returns the first CUDA error (0 = launched).  The
// caller checks shapes, types, contiguity and n_table * 2 <= 48 KB for the
// shared placement.
extern "C" int lut_sigmoid_launch(const void* x, const void* table, void* out,
                                  long long n, int n_table, int value_frac,
                                  int shared, void* stream) {
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const int32_t*>(x);
  const auto* tp = static_cast<const int16_t*>(table);
  auto* op = static_cast<int32_t*>(out);
  if (shared) {
    int device = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                   device);
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long cap = static_cast<long long>(sms) * kSharedBlocksPerSm;
    if (blocks > cap) blocks = cap;
    const size_t smem = static_cast<size_t>(n_table) * sizeof(int16_t);
    lut_sigmoid_kernel<true><<<static_cast<unsigned>(blocks), kThreads, smem,
                               s>>>(xp, tp, op, n, n_table, value_frac);
  } else {
    lut_sigmoid_kernel<false><<<static_cast<unsigned>(blocks), kThreads, 0,
                                s>>>(xp, tp, op, n, n_table, value_frac);
  }
  return static_cast<int>(cudaGetLastError());
}
