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
// Three launches on one stream: mha_bwd_delta (one warp a query row:
// delta, float32 [B, Hq, Sq]), then a dK/dV kernel and a dQ kernel, chosen
// by dtype.  Both main kernels recompute S and dP = dO V^T: dK/dV walks the
// query tiles that can see its keys (within the causal and window bounds)
// over every query head of its group, summing the group in registers, and
// dQ walks the key tiles its rows can see.  No atomics: every output
// element has one writer and is summed in a fixed order, so the gradient is
// bitwise reproducible (a training run resumed from a checkpoint retraces
// an uninterrupted one).  The price is S and dP computed twice (7 tile
// products where dQ by atomics takes 5).
//
// bf16 (the training path): mha_bwd_dkdv_bf16 and mha_bwd_dq_bf16, on the
// tensor cores, the forward's design turned to the gradient (the float32
// kernels below, run on bf16 widened by scalar loads, stalled on every
// tile's staging and reached 1.5% of the bound).  Each CTA has two
// consumer warpgroups of 64 rows and a producer (a warp for dQ, a
// warpgroup for dK/dV) whose first warp keeps a ring of kStages tiles of
// 64 rows in flight by TMA (attention.cuh: 4-D
// tensor maps over the strided views, 128-byte swizzle, rows past S and D
// columns past the view zero-filled, so D of 32 or 96 pads to 64 or 128),
// each stage completing on one mbarrier and released on another once the
// eight consumer warps are done with it.
//  - dK/dV: a CTA per (batch x kv head, 128 keys), CTAs started in index
//    order with key tile 0 of every head first (under a causal mask, the
//    keys that most queries see).  K and V are loaded once; the ring holds
//    Q and dO tiles of 64 queries with their lse (in log2 units; +inf past
//    Sq, so those rows get P = 0) and delta, written to shared memory by
//    the producer's lanes.  A consumer computes S^T = K Q^T and dP^T =
//    V dO^T with wgmma.m64n64k16 (K, V as A, Q, dO as B, all K-major),
//    masks only tiles that cross the diagonal or the window's edge (keys
//    past Skv need no mask: their rows are not stored), forms P^T =
//    exp2(S^T scale log2e - lse2) and dS^T = P^T (dP^T - delta) per column,
//    packs both to bf16 A fragments and adds dV += P^T dO and dK += dS^T Q
//    with wgmma.m64n{64,128}k16 from registers, Q and dO read MN-major with
//    the transpose bit (as the forward reads V).  dK (x scale) and dV stay
//    in float32 registers over the whole group and are cast once.
//  - dQ: a CTA per (batch x query head, 128 queries), the last query tile
//    of every head first.  Q, dO, lse and delta are loaded once; the ring
//    holds K and V tiles of 64 keys.  S = Q K^T and dP = dO V^T (_ss), dS
//    in registers (keys past Skv masked too: their zero rows of K would
//    add nothing, but P there is not 0), dQ += dS K (_rs_tb, K MN-major).
// P and dS are rounded to bf16 for their products, as the forward rounds
// P: within BWD_BF16_RTOL of the plain version.  Tile sizes are the
// forward's (a wgmma is 64 rows; 128 rows a CTA share each ring tile
// between two warpgroups).  Registers: a dK/dV consumer holds dK and dV
// (2 x DP / 2 floats) and S^T, dP^T (64 more).  With 288 threads each of
// the SM's four sub-partitions holds three warps of one CTA, which caps a
// thread at 168 registers: built so, dK/dV spilled 1,484 bytes and the
// pair ran 1.66 ms at the main shape (0.74 without).  So dK/dV has a full
// producer warpgroup (384 threads, 168 a thread at launch) whose
// setmaxnreg.dec to 24 lets the consumers' setmaxnreg.inc take 240; the
// roles never reconverge.  dQ (64 + 64 + 16 live floats) fits 168 with
// a producer warp.
//
// float32: mha_bwd_dkdv and mha_bwd_dq on the CUDA cores, in float32
// throughout: a block of 256 threads per 64 keys (or 64 queries); each
// tile product gives every thread a 4 x 4 (S, dP) or 4 x D/16 (dK, dV, dQ)
// micro-tile, read from shared-memory rows padded by 4 floats, so the
// 16-byte reads of 16 distinct rows fall in distinct banks.  About 170 KB
// of shared memory (D = 128), one block an SM.
//
// Bound on the H100: 5 products of 2 * D operations per unmasked (query,
// key) pair (the work of the math above; these kernels do 7), against the
// bf16 tensor cores at 989e12 flop/s for bf16 inputs and the CUDA cores'
// 67e12 for float32 (kernels/flash_attention.py mha_bwd_cost).
//
// ptxas -v (sm_90a, the chip machine's nvcc): mha_bwd_dkdv_bf16 168
// registers at launch (D padded to 128 and 64; the consumers then take
// 240), no spills; mha_bwd_dq_bf16 166 / 142 registers, no spills; both
// 166,456 / 84,536 bytes of dynamic shared memory (bf16_smem_bytes);
// float32 mha_bwd_dkdv 228 / 226 / 198 / 168 and mha_bwd_dq 162 / 168 /
// 168 / 150 registers (D <= 128 / 96 / 64 / 32), no spills; the delta
// pass 30.
#include <cuda_runtime.h>

#include "attention.cuh"

namespace {

constexpr int kThreads = 256;  // the delta pass and the float32 kernels
constexpr int kBR = 64;        // float32: query rows per tile
constexpr int kBC = 64;        // float32: keys per tile
constexpr int kPS = kBC + 4;   // float32: row stride of the P and dS tiles
constexpr float kLog2e = 1.4426950408889634f;

struct Strides {
  long long b, h, s;  // in elements; the D stride is 1
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
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

// ---- float32: the CUDA cores ------------------------------------------------

// rows row0 .. row0 + 63 of one head's [S, D] slab into a float32 tile of
// DP + 4 floats a row; rows past `rows` and columns past d are zero
template <int DP>
__device__ __forceinline__ void stage(float* dst, const float* src,
                                      long long stride, int row0, int rows,
                                      int d) {
  for (int u = threadIdx.x; u < 64 * DP; u += kThreads) {
    const int r = u / DP, c = u % DP;
    const int gr = row0 + r;
    dst[r * (DP + 4) + c] =
        (gr < rows && c < d) ? src[gr * stride + c] : 0.f;
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

template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
    mha_bwd_dkdv(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, float* __restrict__ dk,
                 float* __restrict__ dv, int hq, int hkv, int sq, int skv,
                 int d, Strides qs, Strides ks, Strides vs, Strides gs,
                 float scale, int causal, int q_offset, int window) {
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
    const float* qb = q + b * qs.b + h * qs.h;
    const float* gb = dout + b * gs.b + h * gs.h;
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
        dk[o + col] = dk_acc[i][j] * scale;
        dv[o + col] = dv_acc[i][j];
      }
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
    mha_bwd_dq(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               float* __restrict__ dq, int hq, int hkv, int sq, int skv, int d,
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
  const float* kb = k + b * ks.b + hk * ks.h;
  const float* vb = v + b * vs.b + hk * vs.h;

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
      if (col < d) dq[o + col] = dq_acc[i][j] * scale;
    }
  }
}

template <int DP>
int launch_f32(const void* q, const void* k, const void* v,
               const void* dout, const float* lse, const float* delta,
               void* dq, void* dk, void* dv, int batch, int hq, int hkv,
               int sq, int skv, int d, Strides qs, Strides ks, Strides vs,
               Strides gs, float scale, int causal, int q_offset, int window,
               cudaStream_t s) {
  constexpr size_t kSmem = smem_bytes<DP>();
  auto dkdv = mha_bwd_dkdv<DP>;
  auto dqk = mha_bwd_dq<DP>;
  cudaError_t err = cudaFuncSetAttribute(
      dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmem));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(dqk,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const float* qt = static_cast<const float*>(q);
  const float* kt = static_cast<const float*>(k);
  const float* vt = static_cast<const float*>(v);
  const float* gt = static_cast<const float*>(dout);
  dkdv<<<dim3((skv + kBC - 1) / kBC, batch * hkv), kThreads, kSmem, s>>>(
      qt, kt, vt, gt, lse, delta, static_cast<float*>(dk),
      static_cast<float*>(dv), hq, hkv, sq, skv, d, qs, ks, vs, gs, scale,
      causal, q_offset, window);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dqk<<<dim3((sq + kBR - 1) / kBR, batch * hq), kThreads, kSmem, s>>>(
      qt, kt, vt, gt, lse, delta, static_cast<float*>(dq), hq, hkv, sq, skv,
      d, qs, ks, vs, gs, scale, causal, q_offset, window);
  return static_cast<int>(cudaGetLastError());
}

// ---- bf16: the tensor cores -------------------------------------------------

constexpr int kTile = 64;            // rows of a TMA box, a wgmma, a ring tile
constexpr int kCtaRows = 2 * kTile;  // keys (dK/dV) or queries (dQ) a CTA
constexpr int kStages = 3;           // the ring
constexpr int kDqThreads = 288;      // two consumer warpgroups + a producer
constexpr int kDkdvThreads = 384;    // ... + a producer warpgroup

// dynamic shared memory of both bf16 kernels: the CTA's own two tiles of
// two tensors (K, V or Q, dO), the ring's tiles of two tensors, lse and
// delta of the ring's query tiles (dK/dV), the barriers, and room to align
// the tiles on 1024 bytes.  DP * 128 bytes a 64-row tile.
template <int DP>
constexpr int bf16_smem_bytes() {
  return (4 + 2 * kStages) * DP * 128 + 2 * kStages * kTile * 4 +
         (1 + 2 * kStages) * 8 + 1024;
}

// acc = A B^T over DP columns for two 64-row tiles in shared memory, both
// K-major (D contiguous) in 64-column chunks of 64 x 128 bytes; issued, not
// committed.  The first product overwrites acc.
template <int DP>
__device__ __forceinline__ void issue_abt(float (&acc)[kTile / 2],
                                          const uint8_t* a,
                                          const uint8_t* b) {
  using namespace sm90;
#pragma unroll
  for (int c = 0; c < DP / 64; ++c)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_m64n64k16_bf16_ss(
          acc, sw128_desc(a + c * kTile * 128 + 32 * kk, 16, 1024),
          sw128_desc(b + c * kTile * 128 + 32 * kk, 16, 1024),
          (c | kk) != 0);
}

// DP: 64 or 128, the tensor maps' padded D (one or two 128-byte chunks)
template <int DP>
__global__ void __launch_bounds__(kDkdvThreads, 1)
    mha_bwd_dkdv_bf16(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap tg,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      __nv_bfloat16* __restrict__ dk,
                      __nv_bfloat16* __restrict__ dv, int batch, int hq,
                      int hkv, int sq, int skv, int d, sm90::MapDims qd,
                      sm90::MapDims kd, sm90::MapDims vd, sm90::MapDims gd,
                      float scale, int causal, int q_offset, int window) {
  using namespace sm90;
  constexpr int kChunk = kTile * 128;  // bytes of 64 rows of 64 columns
  constexpr int kTileB = DP * 128;     // bytes of a 64-row tile
  constexpr int kOut = DP / 2;         // dK (and dV) floats a thread
  extern __shared__ uint8_t smem_raw[];
  uint8_t* k_s = align1024(smem_raw);  // the CTA's keys: two tiles
  uint8_t* v_s = k_s + 2 * kTileB;
  uint8_t* q_s = v_s + 2 * kTileB;     // the ring of query tiles
  uint8_t* g_s = q_s + kStages * kTileB;
  float* lse_s = reinterpret_cast<float*>(g_s + kStages * kTileB);
  float* delta_s = lse_s + kStages * kTile;
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(delta_s + kStages * kTile);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kStages;

  const int tid = threadIdx.x, lane = tid & 31;
  // CTAs start in the order of their index: key tile 0 of every (batch, kv
  // head) first (under a causal mask, the keys most queries see), then 1
  const int nbh = batch * hkv;
  const int bkv = blockIdx.x % nbh, b = bkv / hkv, hk = bkv % hkv;
  const int k0 = blockIdx.x / nbh * kCtaRows;
  const int group = hq / hkv;
  // the query rows that can see a key of this CTA, in tiles of 64
  const long long k_last = min(k0 + kCtaRows, skv) - 1;
  const long long i_begin =
      causal ? max(0ll, static_cast<long long>(k0) - q_offset) : 0;
  const long long i_end =
      window > 0 ? min(static_cast<long long>(sq), k_last + window - q_offset)
                 : sq;
  const int t_begin = static_cast<int>(i_begin / kTile);
  const int n_t =
      i_end > i_begin
          ? static_cast<int>((i_end + kTile - 1) / kTile) - t_begin
          : 0;
  const int ntiles = group * n_t;  // (query head, query tile) pairs

  if (tid == 0) {
    mbar_init(kv_full, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 32);  // the producer's lanes, lane 0 with the bytes
      mbar_init(&empty[s], 8);  // each consumer warp, once per tile
    }
    fence_mbar_init();
  }
  __syncthreads();

  // the roles never reconverge, so setmaxnreg moves registers from the
  // producer warpgroup to the consumers (3 x 168 at launch: a sub-partition
  // of the SM holds one warp of each warpgroup)
  if (tid >= 256) {  // the producer warpgroup: its first warp loads
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (tid >= 288) return;
    if (lane == 0) {
      const int n_kt = k0 + kTile < skv ? 2 : 1;  // tiles holding a key
      mbar_expect_tx(kv_full, 2 * n_kt * kTileB);
      for (int t = 0; t < n_kt; ++t)
#pragma unroll
        for (int c = 0; c < DP / 64; ++c) {
          tma_bhsd(k_s + t * kTileB + c * kChunk, &tk, kv_full, kd, 64 * c,
                   k0 + kTile * t, hk, b);
          tma_bhsd(v_s + t * kTileB + c * kChunk, &tv, kv_full, vd, 64 * c,
                   k0 + kTile * t, hk, b);
        }
    }
    for (int i = 0; i < ntiles; ++i) {
      const int s = i % kStages;
      const int h = hk * group + i / n_t, q0 = (t_begin + i % n_t) * kTile;
      if (i >= kStages) mbar_wait(&empty[s], (i / kStages - 1) & 1);
      // lse in log2 units and delta of the tile's rows; rows past Sq get
      // lse = +inf, so their P is exp2(-inf) = 0 and they add nothing
      const long long row0 = (static_cast<long long>(b) * hq + h) * sq + q0;
      for (int r = lane; r < kTile; r += 32) {
        const bool ok = q0 + r < sq;
        lse_s[s * kTile + r] = ok ? lse[row0 + r] * kLog2e : INFINITY;
        delta_s[s * kTile + r] = ok ? delta[row0 + r] : 0.f;
      }
      if (lane == 0) {
        mbar_expect_tx(&full[s], 2 * kTileB);
#pragma unroll
        for (int c = 0; c < DP / 64; ++c) {
          tma_bhsd(q_s + s * kTileB + c * kChunk, &tq, &full[s], qd, 64 * c,
                   q0, h, b);
          tma_bhsd(g_s + s * kTileB + c * kChunk, &tg, &full[s], gd, 64 * c,
                   q0, h, b);
        }
      } else {
        mbar_arrive(&full[s]);  // releases this lane's lse and delta
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    // consumer warpgroup wg: keys kw0 .. kw0 + 63 of the CTA's; this thread
    // holds keys key_a and key_a + 8 (rows of S^T) and, in each 8-column
    // block j, queries 8 j + 2 (lane % 4) + {0, 1} of the tile
    const int wg = tid >> 7, warp = (tid >> 5) & 3;
    const int kw0 = k0 + kTile * wg;
    const int key_a = kw0 + 16 * warp + (lane >> 2);
    const uint8_t* k_t = k_s + wg * kTileB;
    const uint8_t* v_t = v_s + wg * kTileB;
    const float scale_log2 = scale * kLog2e;
    float dk_acc[kOut], dv_acc[kOut];
#pragma unroll
    for (int i = 0; i < kOut; ++i) dk_acc[i] = dv_acc[i] = 0.f;
    mbar_wait(kv_full, 0);
    for (int i = 0; i < ntiles; ++i) {
      const int s = i % kStages, q0 = (t_begin + i % n_t) * kTile;
      mbar_wait(&full[s], (i / kStages) & 1);
      const long long q_lo = static_cast<long long>(q_offset) + q0;
      const long long q_hi =
          static_cast<long long>(q_offset) + min(q0 + kTile, sq) - 1;
      // tiles wholly masked for this warpgroup's keys change nothing
      const bool active = kw0 < skv && !(causal && q_hi < kw0) &&
                          !(window > 0 && q_lo - (kw0 + kTile - 1) >= window);
      if (active) {
        const uint8_t* q_t = q_s + s * kTileB;
        const uint8_t* g_t = g_s + s * kTileB;
        float st[kTile / 2], dpt[kTile / 2];  // S^T and dP^T: keys x queries
        fence_operand(st);
        fence_operand(dpt);
        wgmma_fence();
        issue_abt<DP>(st, k_t, q_t);
        issue_abt<DP>(dpt, v_t, g_t);
        wgmma_commit();
        wgmma_wait<0>();
        fence_operand(st);
        fence_operand(dpt);
        // tiles that cross the diagonal or the window's edge are masked, by
        // selects; keys past Skv need none (their rows are not stored)
        const bool edge = (causal && q_lo < kw0 + kTile - 1) ||
                          (window > 0 && q_lo + kTile - 1 - kw0 >= window);
        const float* lse_t = lse_s + s * kTile;
        const float* delta_t = delta_s + s * kTile;
#pragma unroll
        for (int j = 0; j < kTile / 8; ++j) {
          const int col = 8 * j + 2 * (lane & 3);
          const float2 l2 = *reinterpret_cast<const float2*>(lse_t + col);
          const float2 dl = *reinterpret_cast<const float2*>(delta_t + col);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float p = fexp2(
                fmaf(st[4 * j + e], scale_log2, -((e & 1) ? l2.y : l2.x)));
            if (edge) {
              const long long qpos = q_lo + col + (e & 1);
              const int kpos = key_a + 8 * (e >> 1);
              const bool out = (causal && qpos < kpos) ||
                               (window > 0 && qpos - kpos >= window);
              p = out ? 0.f : p;
            }
            st[4 * j + e] = p;
            dpt[4 * j + e] = p * (dpt[4 * j + e] - ((e & 1) ? dl.y : dl.x));
          }
        }
        uint32_t pa[kTile / 16][4], sa[kTile / 16][4];
        pack_a(pa, st);
        pack_a(sa, dpt);
        // dV += P^T dO, dK += dS^T Q
        fence_operand(dv_acc);
        fence_operand(dk_acc);
        wgmma_fence();
        issue_ab<DP>(dv_acc, pa, g_t);
        issue_ab<DP>(dk_acc, sa, q_t);
        wgmma_commit();
        wgmma_wait<0>();
        fence_operand(dv_acc);
        fence_operand(dk_acc);
      }
      __syncwarp();  // the warp's lanes are done with the stage
      if (lane == 0) mbar_arrive(&empty[s]);
    }

#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int key = key_a + 8 * hf;
      if (key >= skv) continue;
      const long long o = (static_cast<long long>(bkv) * skv + key) * d;
#pragma unroll
      for (int j = 0; j < kOut / 4; ++j) {
        const int col = 8 * j + 2 * (lane & 3);
        store_pair(dk + o, col, d, dk_acc[4 * j + 2 * hf] * scale,
                   dk_acc[4 * j + 2 * hf + 1] * scale);
        store_pair(dv + o, col, d, dv_acc[4 * j + 2 * hf],
                   dv_acc[4 * j + 2 * hf + 1]);
      }
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(kDqThreads, 1)
    mha_bwd_dq_bf16(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap tg,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    __nv_bfloat16* __restrict__ dq, int batch, int hq,
                    int hkv, int sq, int skv, int d, sm90::MapDims qd,
                    sm90::MapDims kd, sm90::MapDims vd, sm90::MapDims gd,
                    float scale, int causal, int q_offset, int window) {
  using namespace sm90;
  constexpr int kChunk = kTile * 128;
  constexpr int kTileB = DP * 128;
  constexpr int kOut = DP / 2;         // dQ floats a thread
  extern __shared__ uint8_t smem_raw[];
  uint8_t* q_s = align1024(smem_raw);  // the CTA's queries: two tiles
  uint8_t* g_s = q_s + 2 * kTileB;
  uint8_t* k_s = g_s + 2 * kTileB;     // the ring of key tiles
  uint8_t* v_s = k_s + kStages * kTileB;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(v_s + kStages * kTileB);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kStages;

  const int tid = threadIdx.x, lane = tid & 31;
  // CTAs start in the order of their index: the last (under a causal mask,
  // heaviest) query tile of every (batch, head) first, then the next
  const int nbh = batch * hq;
  const int bh = blockIdx.x % nbh, b = bh / hq, h = bh % hq;
  const int hk = h / (hq / hkv);
  const int q0 = (gridDim.x / nbh - 1 - blockIdx.x / nbh) * kCtaRows;
  // the key tiles any row of this CTA may attend
  const long long q_lo = static_cast<long long>(q_offset) + q0;
  const long long q_hi =
      static_cast<long long>(q_offset) + min(q0 + kCtaRows, sq) - 1;
  const long long kv_end =
      causal ? min(static_cast<long long>(skv), q_hi + 1) : skv;
  const long long kv_begin = window > 0 ? max(0ll, q_lo - window + 1) : 0;
  const int t_begin = static_cast<int>(kv_begin / kTile);
  const int ntiles =
      kv_end > kv_begin
          ? static_cast<int>((kv_end + kTile - 1) / kTile) - t_begin
          : 0;

  if (tid == 0) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // each consumer warp, once per tile
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (tid >= 256) {  // the producer warp
    if (lane == 0) {
      const int n_qt = q0 + kTile < sq ? 2 : 1;  // tiles holding a row
      mbar_expect_tx(q_full, 2 * n_qt * kTileB);
      for (int t = 0; t < n_qt; ++t)
#pragma unroll
        for (int c = 0; c < DP / 64; ++c) {
          tma_bhsd(q_s + t * kTileB + c * kChunk, &tq, q_full, qd, 64 * c,
                   q0 + kTile * t, h, b);
          tma_bhsd(g_s + t * kTileB + c * kChunk, &tg, q_full, gd, 64 * c,
                   q0 + kTile * t, h, b);
        }
      for (int i = 0; i < ntiles; ++i) {
        const int s = i % kStages, kv0 = (t_begin + i) * kTile;
        if (i >= kStages) mbar_wait(&empty[s], (i / kStages - 1) & 1);
        mbar_expect_tx(&full[s], 2 * kTileB);
#pragma unroll
        for (int c = 0; c < DP / 64; ++c) {
          tma_bhsd(k_s + s * kTileB + c * kChunk, &tk, &full[s], kd, 64 * c,
                   kv0, hk, b);
          tma_bhsd(v_s + s * kTileB + c * kChunk, &tv, &full[s], vd, 64 * c,
                   kv0, hk, b);
        }
      }
    }
    return;
  }

  // consumer warpgroup wg: query rows r_lo .. r_lo + 63 of the CTA's tile;
  // this thread holds rows row_a and row_a + 8 of them
  const int wg = tid >> 7, warp = (tid >> 5) & 3;
  const int r_lo = q0 + kTile * wg;
  const bool has_rows = r_lo < sq;
  const long long wq_lo = static_cast<long long>(q_offset) + r_lo;
  const long long wq_hi =
      static_cast<long long>(q_offset) + min(r_lo + kTile, sq) - 1;
  const int row_a = r_lo + 16 * warp + (lane >> 2);
  const float scale_log2 = scale * kLog2e;
  // lse in log2 units and delta of this thread's rows; rows past Sq get
  // lse = +inf (P = 0)
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = row_a + 8 * hf;
    const long long at = static_cast<long long>(bh) * sq + row;
    lse_r[hf] = row < sq ? lse[at] * kLog2e : INFINITY;
    delta_r[hf] = row < sq ? delta[at] : 0.f;
  }
  const uint8_t* q_t = q_s + wg * kTileB;
  const uint8_t* g_t = g_s + wg * kTileB;
  float dq_acc[kOut];
#pragma unroll
  for (int i = 0; i < kOut; ++i) dq_acc[i] = 0.f;
  mbar_wait(q_full, 0);
  for (int i = 0; i < ntiles; ++i) {
    const int s = i % kStages, kv0 = (t_begin + i) * kTile;
    mbar_wait(&full[s], (i / kStages) & 1);
    // tiles wholly masked for this warpgroup's rows change nothing
    const bool active =
        has_rows && !(causal && kv0 > wq_hi) &&
        !(window > 0 && kv0 + kTile - 1 < wq_lo - window + 1);
    if (active) {
      const uint8_t* k_t = k_s + s * kTileB;
      const uint8_t* v_t = v_s + s * kTileB;
      float sc[kTile / 2], dp[kTile / 2];  // S and dP: queries x keys
      fence_operand(sc);
      fence_operand(dp);
      wgmma_fence();
      issue_abt<DP>(sc, q_t, k_t);
      issue_abt<DP>(dp, g_t, v_t);
      wgmma_commit();
      wgmma_wait<0>();
      fence_operand(sc);
      fence_operand(dp);
      const bool edge = kv0 + kTile > skv ||
                        (causal && kv0 + kTile - 1 > wq_lo) ||
                        (window > 0 && wq_hi - kv0 >= window);
#pragma unroll
      for (int j = 0; j < kTile / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = fexp2(fmaf(sc[4 * j + e], scale_log2, -lse_r[e >> 1]));
          if (edge) {
            const int kpos = kv0 + 8 * j + 2 * (lane & 3) + (e & 1);
            const long long qpos = wq_lo + (row_a - r_lo) + 8 * (e >> 1);
            const bool out = kpos >= skv || (causal && qpos < kpos) ||
                             (window > 0 && qpos - kpos >= window);
            p = out ? 0.f : p;
          }
          dp[4 * j + e] = p * (dp[4 * j + e] - delta_r[e >> 1]);
        }
      uint32_t sa[kTile / 16][4];
      pack_a(sa, dp);
      // dQ += dS K
      fence_operand(dq_acc);
      wgmma_fence();
      issue_ab<DP>(dq_acc, sa, k_t);
      wgmma_commit();
      wgmma_wait<0>();
      fence_operand(dq_acc);
    }
    __syncwarp();  // the warp's lanes are done with the stage
    if (lane == 0) mbar_arrive(&empty[s]);
  }
  if (!has_rows) return;

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = row_a + 8 * hf;
    if (row >= sq) continue;
    const long long o = (static_cast<long long>(bh) * sq + row) * d;
#pragma unroll
    for (int j = 0; j < kOut / 4; ++j)
      store_pair(dq + o, 8 * j + 2 * (lane & 3), d,
                 dq_acc[4 * j + 2 * hf] * scale,
                 dq_acc[4 * j + 2 * hf + 1] * scale);
  }
}

template <int DP>
int launch_bf16(const void* q, const void* k, const void* v,
                const void* dout, const float* lse, const float* delta,
                void* dq, void* dk, void* dv, int batch, int hq, int hkv,
                int sq, int skv, int d, Strides qs, Strides ks, Strides vs,
                Strides gs, float scale, int causal, int q_offset,
                int window, cudaStream_t s) {
  constexpr int kSmem = bf16_smem_bytes<DP>();
  CUtensorMap tq, tk, tv, tg;
  sm90::MapDims qd{}, kd{}, vd{}, gd{};
  int err = sm90::map_bhsd(&tq, &qd, q, batch, hq, sq, d, qs.b, qs.h, qs.s,
                           kTile);
  if (!err)
    err = sm90::map_bhsd(&tk, &kd, k, batch, hkv, skv, d, ks.b, ks.h, ks.s,
                         kTile);
  if (!err)
    err = sm90::map_bhsd(&tv, &vd, v, batch, hkv, skv, d, vs.b, vs.h, vs.s,
                         kTile);
  if (!err)
    err = sm90::map_bhsd(&tg, &gd, dout, batch, hq, sq, d, gs.b, gs.h, gs.s,
                         kTile);
  if (err) return err;
  auto dkdv = mha_bwd_dkdv_bf16<DP>;
  auto dqk = mha_bwd_dq_bf16<DP>;
  cudaError_t e = cudaFuncSetAttribute(
      dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(
        dqk, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned n_k = (skv + kCtaRows - 1) / kCtaRows;
  const unsigned n_q = (sq + kCtaRows - 1) / kCtaRows;
  dkdv<<<n_k * batch * hkv, kDkdvThreads, kSmem, s>>>(
      tq, tk, tv, tg, lse, delta, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), batch, hq, hkv, sq, skv, d, qd, kd,
      vd, gd, scale, causal, q_offset, window);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  dqk<<<n_q * batch * hq, kDqThreads, kSmem, s>>>(
      tq, tk, tv, tg, lse, delta, static_cast<__nv_bfloat16*>(dq), batch,
      hq, hkv, sq, skv, d, qd, kd, vd, gd, scale, causal, q_offset, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The C entry point bound with ctypes: launches the three kernels on
// `stream` and returns the first CUDA error (0 = launched), or
// sm90::kErrNoEncoder / sm90::kErrEncode (-1 / -2) when a TMA tensor map
// cannot be made.  bf16 != 0: q, k, v, out, dout, dq, dk, dv are bf16 (on
// the tensor cores: q, k, v and dout 16-byte aligned, every stride of a
// dim longer than 1 a multiple of 8 elements), else float32.  lse is the
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
  const long long rows = static_cast<long long>(batch) * hq * sq;
  const unsigned blocks =
      static_cast<unsigned>((rows + kThreads / 32 - 1) / (kThreads / 32));
  if (bf16)
    mha_bwd_delta<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(out),
        static_cast<const __nv_bfloat16*>(dout), delta, hq, sq, d, os, gs,
        rows);
  else
    mha_bwd_delta<float><<<blocks, kThreads, 0, s>>>(
        static_cast<const float*>(out), static_cast<const float*>(dout),
        delta, hq, sq, d, os, gs, rows);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (bf16) {
    if (d <= 64)
      return launch_bf16<64>(q, k, v, dout, lse, delta, dq, dk, dv, batch,
                             hq, hkv, sq, skv, d, qs, ks, vs, gs, scale,
                             causal, q_offset, window, s);
    return launch_bf16<128>(q, k, v, dout, lse, delta, dq, dk, dv, batch, hq,
                            hkv, sq, skv, d, qs, ks, vs, gs, scale, causal,
                            q_offset, window, s);
  }
#define MHA_BWD_F32(DP)                                                    \
  return launch_f32<DP>(q, k, v, dout, lse, delta, dq, dk, dv, batch, hq,  \
                        hkv, sq, skv, d, qs, ks, vs, gs, scale, causal,    \
                        q_offset, window, s)
  if (d <= 32) MHA_BWD_F32(32);
  if (d <= 64) MHA_BWD_F32(64);
  if (d <= 96) MHA_BWD_F32(96);
  MHA_BWD_F32(128);
#undef MHA_BWD_F32
}
