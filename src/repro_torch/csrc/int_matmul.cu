// int_matmul: int8 x int8 -> int32 matrix product, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/quant_matmul/kernel.py:43
// (int_matmul, pallas_call at :56).
//   c[m,n] = sum_k a[m,k] * b[k,n]    (a int8 [M,K], b int8 [K,N], row-major)
// accumulated in int32: exact, since |c| <= K * 128^2 < 2^31 for
// K <= 131,072 (the wrapper checks), so the order of the sum does not
// matter.  Equal to repro/kernels/quant_matmul/ref.py::int_matmul_ref and to
// the plain version in repro_torch/kernels/quant_matmul.py.  M, N and K need
// not be multiples of the tile: the kernel masks its ragged edges itself (the
// TPU kernel asserts divisibility).
//
// Bound on the H100: at prefill (M = prompt length) the 2*M*K*N operations,
// against int8 tensor cores at 1,979 TOP/s; at decode (M = 1) the K*N bytes
// of b, against 3.35 TB/s.  This first design runs on the CUDA cores
// (__dp4a, 4 int8 products a lane per instruction), not on the tensor cores:
// a wgmma/TMA design is later work.
//
// Design: 256 threads per block compute one BM x 64 tile of c, BM = 64 (each
// thread a 4 x 4 grid) or, for M <= 16, BM = 16 (each thread 1 x 4).  Along
// K the block steps 64 bytes at a time.  It stages a's tile and b's tile in
// shared memory as 32-bit words that each pack four consecutive k of one row
// of a or of one column of b, the operands of __dp4a: a's words load as they
// lie, b's are transposed in registers from four 4-byte row loads with
// __byte_perm.  Threads read b's words at consecutive columns and a's as
// broadcasts, so neither read has bank conflicts, and write c at consecutive
// columns.  When the tiles cannot fill the card (few rows, as at decode) the
// grid splits K over up to 64 slices (blockIdx.z) and each slice adds its
// partial sums into c, zeroed first, with integer atomics: exact and
// independent of order.  The vector loads need K % 4 == 0, N % 4 == 0 and
// 4-byte aligned a and b; otherwise the tiles load byte by byte.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBN = 64;             // columns of c per block
constexpr int kBK = 64;             // k per step, in bytes
constexpr int kKW = kBK / 4;        // packed words per step
constexpr int kTX = 16;             // threads along n; each owns 4 columns
constexpr int kTN = kBN / kTX;
constexpr int kTargetBlocks = 4 * 132;  // enough blocks to fill the H100
constexpr int kMaxSplits = 64;

// the bytes a[m, k..k+3] (zero past the edges) as one little-endian word
template <bool kVec>
__device__ __forceinline__ int32_t load_a(const int8_t* __restrict__ a,
                                          int m, int k, int M, int K) {
  if (m >= M) return 0;
  const int8_t* p = a + static_cast<long long>(m) * K + k;
  if constexpr (kVec) {
    return k < K ? *reinterpret_cast<const int32_t*>(p) : 0;
  } else {
    uint32_t w = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (k + j < K) w |= static_cast<uint32_t>(static_cast<uint8_t>(p[j]))
                          << (8 * j);
    return static_cast<int32_t>(w);
  }
}

// the bytes b[k..k+3, n] (zero past the edges) packed as one word
__device__ __forceinline__ int32_t load_b_col(const int8_t* __restrict__ b,
                                              int k, int n, int K, int N) {
  if (n >= N) return 0;
  uint32_t w = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (k + j < K)
      w |= static_cast<uint32_t>(static_cast<uint8_t>(
               b[static_cast<long long>(k + j) * N + n]))
           << (8 * j);
  return static_cast<int32_t>(w);
}

template <int BM, int TM, bool kVec>
__global__ void __launch_bounds__(kThreads)
    int_matmul_kernel(const int8_t* __restrict__ a,
                      const int8_t* __restrict__ b, int32_t* __restrict__ c,
                      int M, int N, int K, int steps_per_split, int atomic) {
  constexpr int kTY = BM / TM;
  static_assert(kTY * kTX == kThreads, "one thread per TM x 4 outputs");
  __shared__ int32_t as[kKW][BM + 1];  // + 1: conflict-free tile stores
  __shared__ int32_t bs[kKW][kBN];

  const int tid = threadIdx.x;
  const int tx = tid % kTX, ty = tid / kTX;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * kBN;
  const int k_begin = blockIdx.z * steps_per_split * kBK;
  int k_end = k_begin + steps_per_split * kBK;
  if (k_end > K) k_end = K;

  int32_t acc[TM][kTN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0;

  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    // a's tile: BM rows x 16 words
    for (int u = tid; u < BM * kKW; u += kThreads) {
      const int m = u / kKW, kw = u % kKW;
      as[kw][m] = load_a<kVec>(a, m0 + m, k0 + 4 * kw, M, K);
    }
    // b's tile: 16 words of 4 k x 64 columns; one thread per 4 x 4 bytes
    {
      const int kw = tid / kTX, cg = tid % kTX;
      const int k = k0 + 4 * kw, n = n0 + 4 * cg;
      int32_t col[4];
      if (kVec && n < N) {
        uint32_t r[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          r[j] = k + j < K ? *reinterpret_cast<const uint32_t*>(
                                 b + static_cast<long long>(k + j) * N + n)
                           : 0u;
        // transpose the 4 x 4 bytes: col[j] = bytes j of r[0..3]
        const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140);
        const uint32_t t1 = __byte_perm(r[2], r[3], 0x5140);
        const uint32_t t2 = __byte_perm(r[0], r[1], 0x7362);
        const uint32_t t3 = __byte_perm(r[2], r[3], 0x7362);
        col[0] = static_cast<int32_t>(__byte_perm(t0, t1, 0x5410));
        col[1] = static_cast<int32_t>(__byte_perm(t0, t1, 0x7632));
        col[2] = static_cast<int32_t>(__byte_perm(t2, t3, 0x5410));
        col[3] = static_cast<int32_t>(__byte_perm(t2, t3, 0x7632));
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) col[j] = load_b_col(b, k, n + j, K, N);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) bs[kw][4 * cg + j] = col[j];
    }
    __syncthreads();
#pragma unroll
    for (int kw = 0; kw < kKW; ++kw) {
      int32_t av[TM], bv[kTN];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = as[kw][ty + i * kTY];
#pragma unroll
      for (int j = 0; j < kTN; ++j) bv[j] = bs[kw][tx + j * kTX];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = __dp4a(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty + i * kTY;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int n = n0 + tx + j * kTX;
      if (n >= N) continue;
      int32_t* dst = c + static_cast<long long>(m) * N + n;
      if (atomic)
        atomicAdd(dst, acc[i][j]);
      else
        *dst = acc[i][j];
    }
  }
}

template <int BM, int TM>
int launch(const int8_t* a, const int8_t* b, int32_t* c, int M, int N, int K,
           bool vec, cudaStream_t s) {
  const long long tiles =
      static_cast<long long>((N + kBN - 1) / kBN) * ((M + BM - 1) / BM);
  const int steps = (K + kBK - 1) / kBK;
  long long want = (kTargetBlocks + tiles - 1) / tiles;
  if (want > kMaxSplits) want = kMaxSplits;
  if (want > steps) want = steps;
  const int per_split = (steps + static_cast<int>(want) - 1) /
                        static_cast<int>(want);
  const int splits = (steps + per_split - 1) / per_split;
  const int atomic = splits > 1;
  if (atomic) {
    const cudaError_t err = cudaMemsetAsync(
        c, 0, static_cast<size_t>(M) * N * sizeof(int32_t), s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((N + kBN - 1) / kBN, (M + BM - 1) / BM, splits);
  if (vec)
    int_matmul_kernel<BM, TM, true>
        <<<grid, kThreads, 0, s>>>(a, b, c, M, N, K, per_split, atomic);
  else
    int_matmul_kernel<BM, TM, false>
        <<<grid, kThreads, 0, s>>>(a, b, c, M, N, K, per_split, atomic);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry point bound with ctypes.  Launches on `stream`; returns
// cudaGetLastError() (0 = launched).  The caller checks types, shapes,
// contiguity, 1 <= M <= 65535 * 64, N >= 1 and 1 <= K <= 131072.
extern "C" int int_matmul_launch(const void* a, const void* b, void* c, int m,
                                 int n, int k, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* ap = static_cast<const int8_t*>(a);
  const auto* bp = static_cast<const int8_t*>(b);
  auto* cp = static_cast<int32_t*>(c);
  const bool vec = k % 4 == 0 && n % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(a) % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(b) % 4 == 0;
  if (m <= 16) return launch<16, 1>(ap, bp, cp, m, n, k, vec, s);
  return launch<64, 4>(ap, bp, cp, m, n, k, vec, s);
}
