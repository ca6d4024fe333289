// fx_matvec: Q-format row dot with per-product rounding, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/quant_matmul/kernel.py:82
// (fx_matvec, pallas_call at :94).
//   out[r] = sum_j ((x[r,j] * w[j] + 2^(f-1)) >> f),
// each product rounded back to Q(f) BEFORE the int32 sum — bit-identical to
// repro.core.fixed_point.fx_dot and to the plain version in
// repro_torch/kernels/quant_matmul.py.
//
// Input: x int32 [N, F] (the simulated cores' shards [C, n_pc, F] are one
// contiguous [C*n_pc, F] matrix, so one launch covers every core), w int32
// [F] (the broadcast model, the same for every core).  Output: int32 [N].
//
// Lanes: with w int32 [K, F] (K models over the same data: a fused
// learning-rate sweep, where the reference vmaps the Pallas kernel over a
// lane grid axis) the output is int32 [N, K] row-major,
//   out[r, k] = sum_j ((x[r,j] * w[k,j] + 2^(f-1)) >> f),
// each lane the same wrapping Q(f) sum as above.  K = 1 runs the kernel
// above.
//
// Bound on the H100: memory.  One call must read N*F*4 bytes of x and write
// N*4 bytes; it does ~4 integer operations per element of x, far below the
// integer ALU rate.  The per-product shift rules out a tensor-core MMA.
//
// Design: w is staged once per block in shared memory.  One thread owns one
// row; with F % 4 == 0 and a 16-byte aligned x it reads the row with 16-byte
// vector loads (a warp's 32 rows are one contiguous 32*F*4-byte span, so
// every byte of every sector it touches is used), with a scalar tail
// otherwise.  A grid-stride loop bounds the grid.
//
// Exactness: the reference wraps int32 in two's complement, while signed
// overflow is undefined in C++.  So the multiply, the + 2^(f-1) and the sum
// run in uint32_t (wrapping by definition) and are cast back; the >> f runs
// on the signed value, an arithmetic shift.  The modular sum is independent
// of order, so the result is bit-exact whatever the thread layout.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ uint32_t rounded_product(int32_t x, int32_t w,
                                                    uint32_t half,
                                                    int frac_bits) {
  const uint32_t p = static_cast<uint32_t>(x) * static_cast<uint32_t>(w);
  return static_cast<uint32_t>(static_cast<int32_t>(p + half) >> frac_bits);
}

template <bool kVec>
__global__ void fx_matvec_kernel(const int32_t* __restrict__ x,
                                 const int32_t* __restrict__ w,
                                 int32_t* __restrict__ out, long long n,
                                 int f_dim, int frac_bits) {
  extern __shared__ int32_t w_s[];
  for (int j = threadIdx.x; j < f_dim; j += blockDim.x) w_s[j] = w[j];
  __syncthreads();

  const uint32_t half = frac_bits ? (1u << (frac_bits - 1)) : 0u;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long row = static_cast<long long>(blockIdx.x) * blockDim.x +
                       threadIdx.x;
       row < n; row += stride) {
    const int32_t* xr = x + row * f_dim;
    uint32_t acc = 0;
    int j = 0;
    if (kVec) {
      for (; j + 4 <= f_dim; j += 4) {
        const int4 v = __ldg(reinterpret_cast<const int4*>(xr + j));
        acc += rounded_product(v.x, w_s[j], half, frac_bits);
        acc += rounded_product(v.y, w_s[j + 1], half, frac_bits);
        acc += rounded_product(v.z, w_s[j + 2], half, frac_bits);
        acc += rounded_product(v.w, w_s[j + 3], half, frac_bits);
      }
    }
    for (; j < f_dim; ++j)
      acc += rounded_product(__ldg(xr + j), w_s[j], half, frac_bits);
    out[row] = static_cast<int32_t>(acc);
  }
}

// The lane kernel reads each row of x once from device memory for all K
// lanes: the bytes are x's (N*F*4) and the output's (N*K*4), and the
// operations grow with K (~4 per element of x per lane), so at K = 8, F =
// 16 the bytes still bound it on the H100.  W [K, F] is staged once per
// block in shared memory (K*F*4 <= 48 KB).  A thread owns one row and keeps
// a tile of up to kTile lane sums in registers; a row with more lanes than
// one tile is read again for each further tile, from L1.  Every thread of a
// warp reads the same w_s word, a broadcast.  The tile width is a template
// parameter, so the sums stay in registers; the last, narrower tile picks
// its width in a switch that is uniform across the grid.  The output is
// [N, K] row-major: a thread stores its K sums contiguously (16-byte stores
// when K % 4 == 0), a warp 32*K contiguous ints.
constexpr int kTile = 8;

template <int KT, bool kVec>
__device__ __forceinline__ void lane_tile(const int32_t* __restrict__ xr,
                                          const int32_t* ws, int f_dim,
                                          uint32_t half, int frac_bits,
                                          int32_t* o, bool vec_out) {
  uint32_t acc[KT];
#pragma unroll
  for (int k = 0; k < KT; ++k) acc[k] = 0;
  int j = 0;
  if (kVec) {
    for (; j + 4 <= f_dim; j += 4) {
      const int4 v = __ldg(reinterpret_cast<const int4*>(xr + j));
#pragma unroll
      for (int k = 0; k < KT; ++k) {
        const int4 wv = *reinterpret_cast<const int4*>(ws + k * f_dim + j);
        acc[k] += rounded_product(v.x, wv.x, half, frac_bits);
        acc[k] += rounded_product(v.y, wv.y, half, frac_bits);
        acc[k] += rounded_product(v.z, wv.z, half, frac_bits);
        acc[k] += rounded_product(v.w, wv.w, half, frac_bits);
      }
    }
  }
  for (; j < f_dim; ++j) {
    const int32_t xv = __ldg(xr + j);
#pragma unroll
    for (int k = 0; k < KT; ++k)
      acc[k] += rounded_product(xv, ws[k * f_dim + j], half, frac_bits);
  }
  if (KT % 4 == 0 && vec_out) {
#pragma unroll
    for (int k = 0; k < KT; k += 4)
      *reinterpret_cast<int4*>(o + k) =
          make_int4(static_cast<int32_t>(acc[k]),
                    static_cast<int32_t>(acc[k + 1]),
                    static_cast<int32_t>(acc[k + 2]),
                    static_cast<int32_t>(acc[k + 3]));
  } else {
#pragma unroll
    for (int k = 0; k < KT; ++k) o[k] = static_cast<int32_t>(acc[k]);
  }
}

template <bool kVec>
__global__ void fx_matvec_lanes_kernel(const int32_t* __restrict__ x,
                                       const int32_t* __restrict__ w,
                                       int32_t* __restrict__ out,
                                       long long n, int f_dim, int lanes,
                                       int frac_bits) {
  extern __shared__ __align__(16) int32_t lane_w_s[];
  for (int j = threadIdx.x; j < lanes * f_dim; j += blockDim.x)
    lane_w_s[j] = w[j];
  __syncthreads();

  const uint32_t half = frac_bits ? (1u << (frac_bits - 1)) : 0u;
  // out rows start 16-byte aligned when K % 4 == 0 (out is allocated
  // aligned), and every tile but the last starts at a multiple of kTile
  const bool vec_out = (lanes & 3) == 0;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long row = static_cast<long long>(blockIdx.x) * blockDim.x +
                       threadIdx.x;
       row < n; row += stride) {
    const int32_t* xr = x + row * f_dim;
    int32_t* o = out + row * lanes;
    int k0 = 0;
    for (; k0 + kTile <= lanes; k0 += kTile)
      lane_tile<kTile, kVec>(xr, lane_w_s + k0 * f_dim, f_dim, half,
                             frac_bits, o + k0, vec_out);
    const int32_t* ws = lane_w_s + k0 * f_dim;
    switch (lanes - k0) {
      case 1: lane_tile<1, kVec>(xr, ws, f_dim, half, frac_bits, o + k0,
                                 vec_out); break;
      case 2: lane_tile<2, kVec>(xr, ws, f_dim, half, frac_bits, o + k0,
                                 vec_out); break;
      case 3: lane_tile<3, kVec>(xr, ws, f_dim, half, frac_bits, o + k0,
                                 vec_out); break;
      case 4: lane_tile<4, kVec>(xr, ws, f_dim, half, frac_bits, o + k0,
                                 vec_out); break;
      case 5: lane_tile<5, kVec>(xr, ws, f_dim, half, frac_bits, o + k0,
                                 vec_out); break;
      case 6: lane_tile<6, kVec>(xr, ws, f_dim, half, frac_bits, o + k0,
                                 vec_out); break;
      case 7: lane_tile<7, kVec>(xr, ws, f_dim, half, frac_bits, o + k0,
                                 vec_out); break;
      default: break;
    }
  }
}

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 1 << 20;

}  // namespace

// C entry point bound with ctypes.  Launches on `stream`; returns
// cudaGetLastError() (0 = launched).  The caller checks shapes, types,
// contiguity, 0 <= frac_bits < 32 and F * 4 <= 48 KB.
extern "C" int fx_matvec_launch(const void* x, const void* w, void* out,
                                long long n, int f_dim, int frac_bits,
                                int vec, void* stream) {
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const size_t smem = static_cast<size_t>(f_dim) * sizeof(int32_t);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const int32_t*>(x);
  const auto* wp = static_cast<const int32_t*>(w);
  auto* op = static_cast<int32_t*>(out);
  if (vec)
    fx_matvec_kernel<true><<<static_cast<unsigned>(blocks), kThreads, smem,
                             s>>>(xp, wp, op, n, f_dim, frac_bits);
  else
    fx_matvec_kernel<false><<<static_cast<unsigned>(blocks), kThreads, smem,
                              s>>>(xp, wp, op, n, f_dim, frac_bits);
  return static_cast<int>(cudaGetLastError());
}

// The lane kernel's entry point: x [n, F], w [lanes, F], out [n, lanes],
// lanes >= 2.  The caller checks shapes, types, contiguity,
// 0 <= frac_bits < 32 and lanes * F * 4 <= 48 KB.
extern "C" int fx_matvec_lanes_launch(const void* x, const void* w,
                                      void* out, long long n, int f_dim,
                                      int lanes, int frac_bits, int vec,
                                      void* stream) {
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const size_t smem = static_cast<size_t>(lanes) * f_dim * sizeof(int32_t);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const int32_t*>(x);
  const auto* wp = static_cast<const int32_t*>(w);
  auto* op = static_cast<int32_t*>(out);
  if (vec)
    fx_matvec_lanes_kernel<true><<<static_cast<unsigned>(blocks), kThreads,
                                   smem, s>>>(xp, wp, op, n, f_dim, lanes,
                                              frac_bits);
  else
    fx_matvec_lanes_kernel<false><<<static_cast<unsigned>(blocks), kThreads,
                                    smem, s>>>(xp, wp, op, n, f_dim, lanes,
                                               frac_bits);
  return static_cast<int>(cudaGetLastError());
}
