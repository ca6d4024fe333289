// flash_attention: blocked attention forward with an online softmax, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention/kernel.py:81 (flash_attention,
// pallas_call at :99) together with the GQA repeat of ops.py:11
// (_gqa_repeat).  For q [B, Hq, Sq, D] and k, v [B, Hkv, Skv, D], query head h
// reads kv head h / (Hq / Hkv) (the values jnp.repeat would give, without
// materialising them), and with qpos = q_offset + i, kpos = j:
//   out[b,h,i] = sum_j p_ij v[b,h',j] / sum_j p_ij,
//   p_ij = exp(s_ij - max_j s_ij), s_ij = (q_i . k_j) / sqrt(D) where
//   (causal: qpos >= kpos) and (window > 0: qpos - kpos < window), else -1e30.
// All arithmetic is float32 (the inputs are float32 or bf16, the output has
// q's dtype), in the order of _flash_kernel (kernel.py:25-75): a running max
// m, sum l and accumulator per query row, rescaled by exp(m_old - m_new) at
// every key tile, NEG_INF = -1e30 for masked keys, l clamped at 1e-30 at the
// end.  Whole key tiles above the causal diagonal or before the window are
// skipped.  Keys past Skv (the ragged last tile) count as exp(-inf) = 0.  A
// row with no unmasked key is outside the contract, as in the reference.
// Equal to repro/kernels/flash_attention/ref.py::attention_ref and the plain
// version in repro_torch/kernels/flash_attention.py within float32 rounding.
//
// Bound on the H100: for serving prefill (Sq = Skv = prompt length, causal)
// the 4 * D operations per unmasked (query, key) pair, against the bf16 tensor
// cores at 989 TFLOP/s; at the smallest prompts the bytes of q, k, v and out.
// This first design runs on the CUDA cores in float32, not on the tensor
// cores: a wgmma/TMA design is later work.
//
// Design: one block of 8 warps per (batch * head, tile of 64 query rows).
// The query tile is staged once in shared memory as float32; key and value
// tiles of 32 rows follow it through shared memory.  Each warp owns 8 query
// rows and each lane one key of the tile: a lane computes its key's 8 scores
// from 16-byte shared-memory reads (the query rows are broadcasts, the key
// rows are padded by 4 floats so the lanes' reads hit distinct banks), the
// warp reduces the row max and sum with shuffles, and each lane then owns
// D / 32 columns of the 8 accumulators, taking p from the key's lane by
// shuffle.  Inputs are read through their [B, H, S, D] strides (D contiguous),
// as _project_qkv's transposed views lie; the output is contiguous.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 8;
constexpr int kBQ = kWarps * kRowsPerWarp;  // query rows per block
constexpr int kBKV = 32;                    // keys per tile: one per lane
constexpr float kNegInf = -1e30f;           // NEG_INF of kernel.py

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

struct Strides {
  long long b, h, s;  // in elements; the D stride is 1
};

// DP: D rounded up to a multiple of 32 (zero-padded in shared memory)
template <int DP, typename T>
__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ out,
                           int hq, int group, int sq, int skv, int d,
                           Strides qs, Strides ks, Strides vs, float scale,
                           int causal, int q_offset, int window) {
  constexpr int kCols = DP / 32;   // accumulator columns per lane
  constexpr int kKStride = DP + 4; // padded key rows
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);
  float* k_s = q_s + kBQ * DP;
  float* v_s = k_s + kBKV * kKStride;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bh = blockIdx.y, b = bh / hq, h = bh % hq, hk = h / group;
  const int q0 = blockIdx.x * kBQ;
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;

  for (int u = tid; u < kBQ * DP; u += kThreads) {
    const int r = u / DP, c = u % DP;
    q_s[u] = (q0 + r < sq && c < d) ? to_float(qb[(q0 + r) * qs.s + c]) : 0.f;
  }

  // the key range any row of this tile may attend; whole tiles outside it
  // are skipped
  const int q_lo = q_offset + q0;
  const int q_hi = q_offset + min(q0 + kBQ, sq) - 1;
  const int kv_end = causal ? min(skv, q_hi + 1) : skv;
  const int kv_begin = window > 0 ? max(0, q_lo - window + 1) : 0;
  const int t_begin = kv_begin / kBKV;
  const int t_end = kv_end > kv_begin ? (kv_end + kBKV - 1) / kBKV : t_begin;

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kCols];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }
  const int row0 = warp * kRowsPerWarp;  // this warp's first row in the tile

  for (int t = t_begin; t < t_end; ++t) {
    const int kv0 = t * kBKV;
    __syncthreads();  // the previous tile is consumed (and q_s is written)
    for (int u = tid; u < kBKV * DP; u += kThreads) {
      const int j = u / DP, c = u % DP;
      const bool ok = kv0 + j < skv && c < d;
      k_s[j * kKStride + c] = ok ? to_float(kb[(kv0 + j) * ks.s + c]) : 0.f;
      v_s[j * DP + c] = ok ? to_float(vb[(kv0 + j) * vs.s + c]) : 0.f;
    }
    __syncthreads();

    // scores of this lane's key against the warp's 8 rows
    float s[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) s[i] = 0.f;
    const float* krow = k_s + lane * kKStride;
#pragma unroll 4
    for (int c = 0; c < DP; c += 4) {
      const float4 kk = *reinterpret_cast<const float4*>(krow + c);
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float4 qq =
            *reinterpret_cast<const float4*>(q_s + (row0 + i) * DP + c);
        s[i] = fmaf(qq.x, kk.x, s[i]);
        s[i] = fmaf(qq.y, kk.y, s[i]);
        s[i] = fmaf(qq.z, kk.z, s[i]);
        s[i] = fmaf(qq.w, kk.w, s[i]);
      }
    }

    // masks and the online softmax, one row at a time across the warp
    const int kpos = kv0 + lane;
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int qpos = q_lo + row0 + i;
      const bool allowed = (!causal || qpos >= kpos) &&
                           (window <= 0 || qpos - kpos < window);
      const float sc = kpos >= skv ? -INFINITY
                                   : (allowed ? s[i] * scale : kNegInf);
      const float m_new = fmaxf(m[i], warp_max(sc));
      const float corr = expf(m[i] - m_new);
      const float p = expf(sc - m_new);
      l[i] = l[i] * corr + warp_sum(p);
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= corr;
      m[i] = m_new;
      s[i] = p;
    }

    // acc += p @ v: lane owns columns lane + 32 c
#pragma unroll 4
    for (int j = 0; j < kBKV; ++j) {
      float vv[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) vv[c] = v_s[j * DP + lane + 32 * c];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float p = __shfl_sync(0xffffffffu, s[i], j);
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = q0 + row0 + i;
    if (r >= sq) continue;
    const float li = fmaxf(l[i], 1e-30f);
    T* o = out + (static_cast<long long>(bh) * sq + r) * d;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = lane + 32 * c;
      if (col < d) o[col] = from_float<T>(acc[i][c] / li);
    }
  }
}

template <int DP, typename T>
int launch_typed(const void* q, const void* k, const void* v, void* out,
                 int batch, int hq, int group, int sq, int skv, int d,
                 Strides qs, Strides ks, Strides vs, float scale, int causal,
                 int q_offset, int window, cudaStream_t s) {
  constexpr size_t kSmem =
      sizeof(float) * (kBQ * DP + kBKV * (DP + 4) + kBKV * DP);
  auto kernel = flash_attention_kernel<DP, T>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sq + kBQ - 1) / kBQ, batch * hq);
  kernel<<<grid, kThreads, kSmem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), hq, group, sq, skv, d,
      qs, ks, vs, scale, causal, q_offset, window);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int batch,
           int hq, int group, int sq, int skv, int d, Strides qs, Strides ks,
           Strides vs, float scale, int causal, int q_offset, int window,
           cudaStream_t s) {
  if (d <= 32)
    return launch_typed<32, T>(q, k, v, out, batch, hq, group, sq, skv, d, qs,
                               ks, vs, scale, causal, q_offset, window, s);
  if (d <= 64)
    return launch_typed<64, T>(q, k, v, out, batch, hq, group, sq, skv, d, qs,
                               ks, vs, scale, causal, q_offset, window, s);
  if (d <= 96)
    return launch_typed<96, T>(q, k, v, out, batch, hq, group, sq, skv, d, qs,
                               ks, vs, scale, causal, q_offset, window, s);
  return launch_typed<128, T>(q, k, v, out, batch, hq, group, sq, skv, d, qs,
                              ks, vs, scale, causal, q_offset, window, s);
}

}  // namespace

// C entry point bound with ctypes.  Launches on `stream`; returns the first
// CUDA error (0 = launched).  The caller checks types, shapes, that D is
// contiguous, 1 <= D <= 128, Hq % Hkv == 0, B * Hq <= 65535, q_offset >= 0
// and window >= 0; is_bf16 picks bf16 over float32.  Strides are in
// elements, in the order b, h, s.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* out, int batch, int hq,
    int hkv, int sq, int skv, int d, long long q_sb, long long q_sh,
    long long q_ss, long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss, float scale, int causal,
    int q_offset, int window, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Strides qs{q_sb, q_sh, q_ss}, ks{k_sb, k_sh, k_ss},
      vs{v_sb, v_sh, v_ss};
  const int group = hq / hkv;
  if (is_bf16)
    return launch<__nv_bfloat16>(q, k, v, out, batch, hq, group, sq, skv, d,
                                 qs, ks, vs, scale, causal, q_offset, window,
                                 s);
  return launch<float>(q, k, v, out, batch, hq, group, sq, skv, d, qs, ks, vs,
                       scale, causal, q_offset, window, s);
}
