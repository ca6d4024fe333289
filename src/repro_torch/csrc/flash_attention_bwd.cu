// flash_attention_bwd: the gradient of flash_attention's forward
// (flash_attention.cu), for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package has no Pallas backward.  Its
// training step differentiates the XLA attention path
// (src/repro/models/attention.py:151-186) with jax.grad; the port's forward
// on the card is a hand-written kernel with no autograd formula, so its
// gradient is this kernel (FlashAttention-2's backward, recomputing the
// softmax from the forward's log-sum-exp).  For q [B, Hq, Sq, D], k, v
// [B, Hkv, Skv, D] (query head h reads kv head h / (Hq / Hkv)), the forward's
// out and lse and the output gradient dout, with s_ij = q_i . k_j * scale
// and the forward's masks (qpos = q_offset + i; causal: qpos >= kpos; window
// > 0: qpos - kpos < window):
//   delta_i = sum_d dout_id out_id
//   P_ij    = exp(s_ij - lse_i) where unmasked, else 0
//   dV_j    = sum_i P_ij dout_i
//   dS_ij   = P_ij (dout_i . v_j - delta_i)
//   dQ_i    = scale sum_j dS_ij k_j
//   dK_j    = scale sum_i dS_ij q_i
// with dK and dV summed over the Hq / Hkv query heads of their kv head.
//
// Three launches on one stream:
//   mha_bwd_delta  one warp per query row: delta (float32 [B, Hq, Sq])
//   mha_bwd_dkdv   one block per (batch x kv head, tile of 64 keys); it
//                  keeps its K and V tile in shared memory and dK, dV in
//                  float32 registers, and walks the query tiles of each
//                  query head of its group that can see the tile (within
//                  the causal and window bounds), so the group sum happens
//                  in registers before the one cast and store
//   mha_bwd_dq     one block per (batch x query head, tile of 64 queries);
//                  it keeps Q and dO in shared memory and dQ in registers
//                  and walks the key tiles the rows can see, recomputing S,
//                  P and dS
// No atomics: every output element has one writer and is summed in a fixed
// order, so the gradient is bitwise reproducible (a training run resumed
// from a checkpoint retraces an uninterrupted one).  The price is S and
// dO . V^T computed twice (7 tile products where dQ by atomics takes 5).
//
// Design: float32 on the CUDA cores for both input types (a bf16 input is
// widened as it is staged in shared memory; outputs are rounded once).  A
// block has 256 threads; each tile product gives every thread a 4 x 4 (S,
// dP) or 4 x D/16 (dK, dV, dQ) micro-tile, read from shared-memory rows
// padded by 4 floats, so the 16-byte reads of 16 distinct rows fall in
// distinct banks.  Shared memory: about 170 KB (D = 128), one block an SM.
//
// Bound on the H100: 5 products of 2 * D operations per unmasked (query,
// key) pair (the work of the math above; this kernel does 7), against the
// bf16 tensor cores at 989e12 flop/s for bf16 inputs and the CUDA cores'
// 67e12 for float32 (kernels/flash_attention.py mha_bwd_cost).  On the
// CUDA cores it stays far from the bf16 bound: mma.sync or wgmma products
// are later work (PERF.md).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBR = 64;           // query rows per tile
constexpr int kBC = 64;           // keys per tile
constexpr int kPS = kBC + 4;      // row stride of the P and dS tiles
constexpr float kLog2e = 1.4426950408889634f;

struct Strides {
  long long b, h, s;  // in elements; the D stride is 1
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// delta[row] = sum_d out[row, d] * dout[row, d], one warp a row
template <typename T>
__global__ void __launch_bounds__(kThreads)
    mha_bwd_delta(const T* __restrict__ out, const T* __restrict__ dout,
                  float* __restrict__ delta, int hq, int sq, int d,
                  Strides os, Strides gs, long long rows) {
  const long long row = static_cast<long long>(blockIdx.x) * (kThreads / 32) +
                        (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // whole warps leave together
  const long long bh = row / sq;
  const int r = static_cast<int>(row % sq);
  const long long b = bh / hq, h = bh % hq;
  const T* o = out + b * os.b + h * os.h + r * os.s;
  const T* g = dout + b * gs.b + h * gs.h + r * gs.s;
  float acc = 0.f;
  for (int c = lane; c < d; c += 32) acc = fmaf(to_f(o[c]), to_f(g[c]), acc);
  acc = warp_sum(acc);
  if (lane == 0) delta[row] = acc;
}

// rows row0 .. row0 + 63 of one head's [S, D] slab into a float32 tile of
// DP + 4 floats a row; rows past `rows` and columns past d are zero
template <int DP, typename T>
__device__ __forceinline__ void stage(float* dst, const T* src,
                                      long long stride, int row0, int rows,
                                      int d) {
  for (int u = threadIdx.x; u < 64 * DP; u += kThreads) {
    const int r = u / DP, c = u % DP;
    const int gr = row0 + r;
    dst[r * (DP + 4) + c] =
        (gr < rows && c < d) ? to_f(src[gr * stride + c]) : 0.f;
  }
}

// acc[i][j] = a_s[4 ty + i] . b_s[tx + 16 j] over DP columns: a 4 x 4 block
// of A B^T for two 64-row tiles of DP + 4 floats a row
template <int DP>
__device__ __forceinline__ void tile_abt(const float* a_s, const float* b_s,
                                         float (&acc)[4][4], int ty, int tx) {
  constexpr int kS = DP + 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int c = 0; c < DP; c += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = *reinterpret_cast<const float4*>(a_s + (4 * ty + i) * kS + c);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      b[j] = *reinterpret_cast<const float4*>(b_s + (tx + 16 * j) * kS + c);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[i][j] = fmaf(a[i].x, b[j].x, acc[i][j]);
        acc[i][j] = fmaf(a[i].y, b[j].y, acc[i][j]);
        acc[i][j] = fmaf(a[i].z, b[j].z, acc[i][j]);
        acc[i][j] = fmaf(a[i].w, b[j].w, acc[i][j]);
      }
  }
}

// P and dS of one (query tile, key tile) pair into p_s / ds_s ([r][c], kPS
// floats a row; p_s may be null): S and dP = dO V^T from the staged tiles,
// P = exp(S scale - lse) where the forward kept the pair, else 0
template <int DP>
__device__ __forceinline__ void softmax_grad(
    const float* q_s, const float* g_s, const float* k_s, const float* v_s,
    const float* lse_s, const float* delta_s, float* p_s, float* ds_s,
    int ty, int tx, int q0, int k0, int sq, int skv, float scale, int causal,
    int q_offset, int window) {
  float s[4][4], dp[4][4];
  tile_abt<DP>(q_s, k_s, s, ty, tx);
  tile_abt<DP>(g_s, v_s, dp, ty, tx);
  const float scale_l2 = scale * kLog2e;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * ty + i;
    const int qi = q0 + r;
    const long long qpos = static_cast<long long>(q_offset) + qi;
    const float lse_l2 = lse_s[r] * kLog2e, dl = delta_s[r];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      const int kpos = k0 + c;
      const bool keep = qi < sq && kpos < skv && (!causal || qpos >= kpos) &&
                        (window <= 0 || qpos - kpos < window);
      const float p = keep ? exp2f(fmaf(s[i][j], scale_l2, -lse_l2)) : 0.f;
      if (p_s != nullptr) p_s[r * kPS + c] = p;
      ds_s[r * kPS + c] = p * (dp[i][j] - dl);
    }
  }
}

// the shared-memory layout of both main kernels (floats): four 64-row
// tiles of DP + 4, the P and dS tiles, lse and delta of the query tile
template <int DP>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (4 * 64 * (DP + 4) + 2 * kBR * kPS + 2 * kBR);
}

template <int DP, typename T>
__global__ void __launch_bounds__(kThreads, 1)
    mha_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, T* __restrict__ dk,
                 T* __restrict__ dv, int hq, int hkv, int sq, int skv, int d,
                 Strides qs, Strides ks, Strides vs, Strides gs, float scale,
                 int causal, int q_offset, int window) {
  constexpr int kS = DP + 4;
  constexpr int kCols = DP / 16;  // accumulator columns a thread
  extern __shared__ float4 smem4[];
  float* k_s = reinterpret_cast<float*>(smem4);
  float* v_s = k_s + kBC * kS;
  float* q_s = v_s + kBC * kS;
  float* g_s = q_s + kBR * kS;
  float* p_s = g_s + kBR * kS;
  float* ds_s = p_s + kBR * kPS;
  float* lse_s = ds_s + kBR * kPS;
  float* delta_s = lse_s + kBR;

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int bkv = blockIdx.y, b = bkv / hkv, hk = bkv % hkv;
  const int group = hq / hkv;
  const int k0 = blockIdx.x * kBC;
  stage<DP>(k_s, k + b * ks.b + hk * ks.h, ks.s, k0, skv, d);
  stage<DP>(v_s, v + b * vs.b + hk * vs.h, vs.s, k0, skv, d);

  // the query rows that can see a key of this tile
  const long long k_last = min(k0 + kBC, skv) - 1;
  const long long i_begin = causal ? max(0ll, k0 - (long long)q_offset) : 0;
  const long long i_end =
      window > 0 ? min((long long)sq, k_last + window - q_offset) : sq;
  const int t_begin = static_cast<int>(i_begin / kBR);
  const int t_end =
      i_end > i_begin ? static_cast<int>((i_end + kBR - 1) / kBR) : t_begin;

  float dk_acc[4][kCols], dv_acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    const T* qb = q + b * qs.b + h * qs.h;
    const T* gb = dout + b * gs.b + h * gs.h;
    const long long row_base = (static_cast<long long>(b) * hq + h) * sq;
    for (int t = t_begin; t < t_end; ++t) {
      const int q0 = t * kBR;
      __syncthreads();  // the previous tile is consumed (K, V staged)
      stage<DP>(q_s, qb, qs.s, q0, sq, d);
      stage<DP>(g_s, gb, gs.s, q0, sq, d);
      if (tid < kBR) {
        const bool ok = q0 + tid < sq;
        lse_s[tid] = ok ? lse[row_base + q0 + tid] : 0.f;
        delta_s[tid] = ok ? delta[row_base + q0 + tid] : 0.f;
      }
      __syncthreads();
      softmax_grad<DP>(q_s, g_s, k_s, v_s, lse_s, delta_s, p_s, ds_s, ty, tx,
                       q0, k0, sq, skv, scale, causal, q_offset, window);
      __syncthreads();
      // dV[c] += sum_r P[r][c] dO[r], dK[c] += sum_r dS[r][c] Q[r] for this
      // thread's keys c = 4 ty + i and columns tx + 16 j
#pragma unroll 2
      for (int r = 0; r < kBR; ++r) {
        const float4 pv =
            *reinterpret_cast<const float4*>(p_s + r * kPS + 4 * ty);
        const float4 sv =
            *reinterpret_cast<const float4*>(ds_s + r * kPS + 4 * ty);
        const float pa[4] = {pv.x, pv.y, pv.z, pv.w};
        const float sa[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          const float go = g_s[r * kS + tx + 16 * j];
          const float qq = q_s[r * kS + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            dv_acc[i][j] = fmaf(pa[i], go, dv_acc[i][j]);
            dk_acc[i][j] = fmaf(sa[i], qq, dk_acc[i][j]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kc = k0 + 4 * ty + i;
    if (kc >= skv) continue;
    const long long o = (static_cast<long long>(bkv) * skv + kc) * d;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int col = tx + 16 * j;
      if (col < d) {
        dk[o + col] = from_f<T>(dk_acc[i][j] * scale);
        dv[o + col] = from_f<T>(dv_acc[i][j]);
      }
    }
  }
}

template <int DP, typename T>
__global__ void __launch_bounds__(kThreads, 1)
    mha_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               T* __restrict__ dq, int hq, int hkv, int sq, int skv, int d,
               Strides qs, Strides ks, Strides vs, Strides gs, float scale,
               int causal, int q_offset, int window) {
  constexpr int kS = DP + 4;
  constexpr int kCols = DP / 16;
  extern __shared__ float4 smem4[];
  float* k_s = reinterpret_cast<float*>(smem4);
  float* v_s = k_s + kBC * kS;
  float* q_s = v_s + kBC * kS;
  float* g_s = q_s + kBR * kS;
  float* ds_s = g_s + kBR * kS + kBR * kPS;  // the P tile's room is unused
  float* lse_s = ds_s + kBR * kPS;
  float* delta_s = lse_s + kBR;

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int bh = blockIdx.y, b = bh / hq, h = bh % hq;
  const int hk = h / (hq / hkv);
  const int q0 = blockIdx.x * kBR;
  const long long row_base = static_cast<long long>(bh) * sq;
  stage<DP>(q_s, q + b * qs.b + h * qs.h, qs.s, q0, sq, d);
  stage<DP>(g_s, dout + b * gs.b + h * gs.h, gs.s, q0, sq, d);
  if (tid < kBR) {
    const bool ok = q0 + tid < sq;
    lse_s[tid] = ok ? lse[row_base + q0 + tid] : 0.f;
    delta_s[tid] = ok ? delta[row_base + q0 + tid] : 0.f;
  }
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;

  // the key tiles any row of this tile may attend (as the forward's)
  const long long q_lo = static_cast<long long>(q_offset) + q0;
  const long long q_hi = static_cast<long long>(q_offset) + min(q0 + kBR, sq)
                         - 1;
  const long long kv_end = causal ? min((long long)skv, q_hi + 1) : skv;
  const long long kv_begin = window > 0 ? max(0ll, q_lo - window + 1) : 0;
  const int t_begin = static_cast<int>(kv_begin / kBC);
  const int t_end = kv_end > kv_begin
                        ? static_cast<int>((kv_end + kBC - 1) / kBC)
                        : t_begin;

  float dq_acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) dq_acc[i][j] = 0.f;

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * kBC;
    __syncthreads();  // the previous tile is consumed (Q, dO staged)
    stage<DP>(k_s, kb, ks.s, k0, skv, d);
    stage<DP>(v_s, vb, vs.s, k0, skv, d);
    __syncthreads();
    softmax_grad<DP>(q_s, g_s, k_s, v_s, lse_s, delta_s, nullptr, ds_s, ty,
                     tx, q0, k0, sq, skv, scale, causal, q_offset, window);
    __syncthreads();
    // dQ[r] += sum_c dS[r][c] K[c] for rows r = 4 ty + i, columns tx + 16 j
#pragma unroll 2
    for (int c = 0; c < kBC; c += 4) {
      float4 sv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        sv[i] = *reinterpret_cast<const float4*>(ds_s + (4 * ty + i) * kPS +
                                                 c);
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int col = tx + 16 * j;
        const float k0v = k_s[c * kS + col], k1v = k_s[(c + 1) * kS + col];
        const float k2v = k_s[(c + 2) * kS + col];
        const float k3v = k_s[(c + 3) * kS + col];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          dq_acc[i][j] = fmaf(sv[i].x, k0v, dq_acc[i][j]);
          dq_acc[i][j] = fmaf(sv[i].y, k1v, dq_acc[i][j]);
          dq_acc[i][j] = fmaf(sv[i].z, k2v, dq_acc[i][j]);
          dq_acc[i][j] = fmaf(sv[i].w, k3v, dq_acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + 4 * ty + i;
    if (r >= sq) continue;
    const long long o = (row_base + r) * d;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int col = tx + 16 * j;
      if (col < d) dq[o + col] = from_f<T>(dq_acc[i][j] * scale);
    }
  }
}

template <int DP, typename T>
int launch_main(const void* q, const void* k, const void* v,
                const void* dout, const float* lse, const float* delta,
                void* dq, void* dk, void* dv, int batch, int hq, int hkv,
                int sq, int skv, int d, Strides qs, Strides ks, Strides vs,
                Strides gs, float scale, int causal, int q_offset,
                int window, cudaStream_t s) {
  constexpr size_t kSmem = smem_bytes<DP>();
  auto dkdv = mha_bwd_dkdv<DP, T>;
  auto dqk = mha_bwd_dq<DP, T>;
  cudaError_t err = cudaFuncSetAttribute(
      dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmem));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(dqk,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* gt = static_cast<const T*>(dout);
  dkdv<<<dim3((skv + kBC - 1) / kBC, batch * hkv), kThreads, kSmem, s>>>(
      qt, kt, vt, gt, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      hq, hkv, sq, skv, d, qs, ks, vs, gs, scale, causal, q_offset, window);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dqk<<<dim3((sq + kBR - 1) / kBR, batch * hq), kThreads, kSmem, s>>>(
      qt, kt, vt, gt, lse, delta, static_cast<T*>(dq), hq, hkv, sq, skv, d,
      qs, ks, vs, gs, scale, causal, q_offset, window);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* out,
           const void* dout, const float* lse, float* delta, void* dq,
           void* dk, void* dv, int batch, int hq, int hkv, int sq, int skv,
           int d, Strides qs, Strides ks, Strides vs, Strides os, Strides gs,
           float scale, int causal, int q_offset, int window,
           cudaStream_t s) {
  const long long rows = static_cast<long long>(batch) * hq * sq;
  const long long blocks = (rows + kThreads / 32 - 1) / (kThreads / 32);
  mha_bwd_delta<T><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      static_cast<const T*>(out), static_cast<const T*>(dout), delta, hq, sq,
      d, os, gs, rows);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
#define MHA_BWD_MAIN(DP)                                                   \
  return launch_main<DP, T>(q, k, v, dout, lse, delta, dq, dk, dv, batch,  \
                            hq, hkv, sq, skv, d, qs, ks, vs, gs, scale,     \
                            causal, q_offset, window, s)
  if (d <= 32) MHA_BWD_MAIN(32);
  if (d <= 64) MHA_BWD_MAIN(64);
  if (d <= 96) MHA_BWD_MAIN(96);
  MHA_BWD_MAIN(128);
#undef MHA_BWD_MAIN
}

}  // namespace

// The C entry point bound with ctypes: launches the three kernels on
// `stream` and returns the first CUDA error (0 = launched).  bf16 != 0:
// q, k, v, out, dout, dq, dk, dv are bf16, else float32.  lse is the
// forward's float32 [B, Hq, Sq] log-sum-exp (natural-log units), delta a
// float32 scratch of B * Hq * Sq; dq [B, Hq, Sq, D] and dk, dv [B, Hkv, Skv,
// D] are contiguous and written whole.  The caller checks types, shapes,
// that D is contiguous in every input, 1 <= D <= 128, Hq % Hkv == 0,
// B * Hq <= 65535, Sq, Skv >= 1, q_offset >= 0 and window >= 0.  Strides are
// in elements, in the order b, h, s.
extern "C" int flash_attention_bwd_launch(
    int bf16, const void* q, const void* k, const void* v, const void* out,
    const void* dout, const float* lse, float* delta, void* dq, void* dk,
    void* dv, int batch, int hq, int hkv, int sq, int skv, int d,
    long long q_sb, long long q_sh, long long q_ss, long long k_sb,
    long long k_sh, long long k_ss, long long v_sb, long long v_sh,
    long long v_ss, long long o_sb, long long o_sh, long long o_ss,
    long long g_sb, long long g_sh, long long g_ss, float scale, int causal,
    int q_offset, int window, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Strides qs{q_sb, q_sh, q_ss}, ks{k_sb, k_sh, k_ss},
      vs{v_sb, v_sh, v_ss}, os{o_sb, o_sh, o_ss}, gs{g_sb, g_sh, g_ss};
  if (bf16)
    return launch<__nv_bfloat16>(q, k, v, out, dout, lse, delta, dq, dk, dv,
                                 batch, hq, hkv, sq, skv, d, qs, ks, vs, os,
                                 gs, scale, causal, q_offset, window, s);
  return launch<float>(q, k, v, out, dout, lse, delta, dq, dk, dv, batch, hq,
                       hkv, sq, skv, d, qs, ks, vs, os, gs, scale, causal,
                       q_offset, window, s);
}
