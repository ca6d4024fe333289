// kmeans_assign: K-Means assign-and-accumulate over int16 points, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/kmeans_assign/kernel.py:51
// (kmeans_assign, pallas_call at :61).  Per simulated core c and row r:
//   label[c,r] = first argmin_k (||C_k||^2 - 2 x[c,r].C_k)   (int32, wrapping)
//   sums[c,k,:] += x[c,r,:]  and  counts[c,k] += 1  for k = label[c,r]
// bit-identical to repro/kernels/kmeans_assign/ref.py and to the plain
// version in repro_torch/kernels/kmeans_assign.py.  Every row counts (pad
// rows included): the trainer subtracts the pad rows itself, so unlike the
// reference's ops.py there is no second pad correction here.
//
// Input: x int16 [C, n_pc, F] (the cores' resident shards, one launch for all
// cores), centroids int16 [K, F] (the broadcast model).  Outputs: labels
// int32 [C, n_pc], per-core partial sums int32 [C, K, F] and counts int32
// [C, K], which the caller zeroes and map_reduce reduces over the cores.
//
// Bound on the H100: operations.  A row is 2F bytes in and 4 bytes out, but
// K*F multiply-adds on the CUDA cores (there is no int16 tensor-core MMA); at
// K = F = 16 that is 256 multiply-adds per 36 bytes, above the card's
// int32-operations-per-byte ridge (33.5e12 op/s over 3.35e12 B/s).
//
// Design: a block owns a run of one core's rows (grid.y = core).  It stages
// the centroids as int32 and their squared norms in shared memory; one thread
// owns one row, holds it in registers (F = 16 is a compile-time case; other
// F re-read the row from L1 for each centroid), and scans the centroids
// upward with a strict `<`, so the first minimum wins as in jnp.argmin.  The
// block accumulates sums and counts with shared-memory atomics, then adds
// each non-zero entry to its core's partial with one global atomicAdd.
//
// Exactness: the reference wraps int32 in two's complement, while signed
// overflow is undefined in C++.  So the products, the norms and the
// distance run in uint32_t and are cast back before the signed compare.
// Integer adds do not depend on order, so sums and counts are exact under
// any schedule of the atomics.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerThread = 8;
constexpr int kRowsPerBlock = kThreads * kRowsPerThread;

template <int kF, bool kVec>
__global__ void kmeans_assign_kernel(const int16_t* __restrict__ x,
                                     const int16_t* __restrict__ cents,
                                     int32_t* __restrict__ labels,
                                     int32_t* __restrict__ sums,
                                     int32_t* __restrict__ counts,
                                     long long n_pc, int f_dim, int k) {
  extern __shared__ int32_t smem[];
  const int kf = k * f_dim;
  int32_t* c_s = smem;           // [K, F] centroids as int32
  int32_t* cn_s = c_s + kf;      // [K] squared norms
  int32_t* sum_s = cn_s + k;     // [K, F] block sums
  int32_t* cnt_s = sum_s + kf;   // [K] block counts

  for (int i = threadIdx.x; i < kf; i += blockDim.x) {
    c_s[i] = cents[i];
    sum_s[i] = 0;
  }
  for (int i = threadIdx.x; i < k; i += blockDim.x) cnt_s[i] = 0;
  __syncthreads();
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    uint32_t acc = 0;
    for (int f = 0; f < f_dim; ++f) {
      const uint32_t v = static_cast<uint32_t>(c_s[j * f_dim + f]);
      acc += v * v;
    }
    cn_s[j] = static_cast<int32_t>(acc);
  }
  __syncthreads();

  const long long core = blockIdx.y;
  const long long row0 = static_cast<long long>(blockIdx.x) * kRowsPerBlock;
  long long row_end = row0 + kRowsPerBlock;
  if (row_end > n_pc) row_end = n_pc;
  const int16_t* xc = x + core * n_pc * f_dim;
  int32_t* lc = labels + core * n_pc;

  for (long long r = row0 + threadIdx.x; r < row_end; r += blockDim.x) {
    const int16_t* xr = xc + r * f_dim;
    int best_k = 0;
    int32_t best = 0;
    if constexpr (kF > 0) {
      int32_t xv[kF];
      if constexpr (kVec) {
#pragma unroll
        for (int j = 0; j < kF; j += 8) {
          const int4 v = __ldg(reinterpret_cast<const int4*>(xr + j));
          const int16_t* h = reinterpret_cast<const int16_t*>(&v);
#pragma unroll
          for (int t = 0; t < 8; ++t) xv[j + t] = h[t];
        }
      } else {
#pragma unroll
        for (int f = 0; f < kF; ++f) xv[f] = __ldg(xr + f);
      }
      for (int j = 0; j < k; ++j) {
        const int32_t* cj = c_s + j * kF;
        uint32_t acc = 0;
#pragma unroll
        for (int f = 0; f < kF; ++f)
          acc += static_cast<uint32_t>(xv[f]) * static_cast<uint32_t>(cj[f]);
        const int32_t d = static_cast<int32_t>(
            static_cast<uint32_t>(cn_s[j]) - 2u * acc);
        if (j == 0 || d < best) {
          best = d;
          best_k = j;
        }
      }
      lc[r] = best_k;
      atomicAdd(&cnt_s[best_k], 1);
#pragma unroll
      for (int f = 0; f < kF; ++f)
        if (xv[f]) atomicAdd(&sum_s[best_k * kF + f], xv[f]);
    } else {
      for (int j = 0; j < k; ++j) {
        const int32_t* cj = c_s + j * f_dim;
        uint32_t acc = 0;
        for (int f = 0; f < f_dim; ++f)
          acc += static_cast<uint32_t>(static_cast<int32_t>(__ldg(xr + f))) *
                 static_cast<uint32_t>(cj[f]);
        const int32_t d = static_cast<int32_t>(
            static_cast<uint32_t>(cn_s[j]) - 2u * acc);
        if (j == 0 || d < best) {
          best = d;
          best_k = j;
        }
      }
      lc[r] = best_k;
      atomicAdd(&cnt_s[best_k], 1);
      for (int f = 0; f < f_dim; ++f) {
        const int32_t v = __ldg(xr + f);
        if (v) atomicAdd(&sum_s[best_k * f_dim + f], v);
      }
    }
  }
  __syncthreads();

  int32_t* sc = sums + core * kf;
  int32_t* cc = counts + core * k;
  for (int i = threadIdx.x; i < kf; i += blockDim.x)
    if (sum_s[i]) atomicAdd(&sc[i], sum_s[i]);
  for (int i = threadIdx.x; i < k; i += blockDim.x)
    if (cnt_s[i]) atomicAdd(&cc[i], cnt_s[i]);
}

}  // namespace

// C entry point bound with ctypes.  Launches on `stream`; returns
// cudaGetLastError() (0 = launched).  The caller checks types, shapes,
// contiguity, 1 <= C <= 65535 and that 4*(2*K*F + 2*K) bytes fit 48 KB; it
// zeroes sums and counts.  vec = 1 asks for 16-byte row loads (F % 8 == 0
// and a 16-byte aligned x).
extern "C" int kmeans_assign_launch(const void* x, const void* cents,
                                    void* labels, void* sums, void* counts,
                                    int n_cores, long long n_pc, int f_dim,
                                    int k, int vec, void* stream) {
  const long long blocks_x = (n_pc + kRowsPerBlock - 1) / kRowsPerBlock;
  const dim3 grid(static_cast<unsigned>(blocks_x),
                  static_cast<unsigned>(n_cores));
  const size_t smem = static_cast<size_t>(2 * k * f_dim + 2 * k) *
                      sizeof(int32_t);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const int16_t*>(x);
  const auto* cp = static_cast<const int16_t*>(cents);
  auto* lp = static_cast<int32_t*>(labels);
  auto* sp = static_cast<int32_t*>(sums);
  auto* np = static_cast<int32_t*>(counts);
  if (f_dim == 16 && vec)
    kmeans_assign_kernel<16, true><<<grid, kThreads, smem, s>>>(
        xp, cp, lp, sp, np, n_pc, f_dim, k);
  else if (f_dim == 16)
    kmeans_assign_kernel<16, false><<<grid, kThreads, smem, s>>>(
        xp, cp, lp, sp, np, n_pc, f_dim, k);
  else
    kmeans_assign_kernel<0, false><<<grid, kThreads, smem, s>>>(
        xp, cp, lp, sp, np, n_pc, f_dim, k);
  return static_cast<int>(cudaGetLastError());
}
