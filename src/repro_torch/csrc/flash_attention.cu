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
// The softmax runs in float32 in the order of _flash_kernel
// (kernel.py:25-75): a running max m, sum l and accumulator per query row,
// rescaled by exp(m_old - m_new) at every key tile, NEG_INF = -1e30 for
// masked keys, l clamped at 1e-30 at the end.  Whole key tiles above the
// causal diagonal or before the window are skipped.  Keys past Skv (the
// ragged last tile) count as exp(-inf) = 0.  A row with no unmasked key is
// outside the contract, as in the reference.  Inputs are read through their
// [B, H, S, D] strides (D contiguous), as _project_qkv's transposed views
// lie; the output is contiguous.
//
// Bound on the H100: for serving prefill (Sq = Skv = prompt length, causal)
// the 4 * D operations per unmasked (query, key) pair against the bf16
// tensor cores at 989 TFLOP/s; at the smallest prompts the bytes of q, k, v
// and out.  Two designs, chosen by dtype in the wrapper:
//
// bf16 (the serving path): flash_attention_bf16, on the tensor cores, at
// 1.2% of the bound before this design (float32 FMAs, issue-bound).  One
// CTA per (batch x query head, 128 query rows); CTAs start in the order
// of their linear index, which runs over the heads of the last (for a
// causal mask, heaviest) query tile first.  Three roles: a producer warp
// whose first lane loads the q tile once and keeps K and V tiles of 64
// keys in flight in a ring of three stages, by TMA (4-D tensor maps over
// the strided views, 128-byte swizzle, out-of-range rows and D columns
// zero-filled: attention.cuh, shared with the backward; a stage completes
// on one mbarrier and is released on another once both consumers are done
// with it), and two consumer warpgroups of 64 query rows each.  A
// consumer computes S = Q K^T with
// wgmma.m64n64k16.f32.bf16.bf16 from shared memory (q and k are both
// D-contiguous: K-major), scales and masks the float32 accumulator
// fragments in registers (masks by selects, only on tiles that cross the
// diagonal, the window's edge or Skv: a branch per element cost a
// reconvergence barrier per element), reduces row max and sum across the
// 4 lanes of a row by shuffles, takes exp2 on the special-function unit
// (ex2.approx; scale and log2(e) in one FFMA with the max), packs P to
// bf16 in registers as wgmma's A operand and adds P V with
// wgmma.m64n{64,128}k16, whose B, V as [keys, D] (MN-major), is read with
// the transpose bit.  Each consumer warp releases a stage once.  D is
// padded to 64 or 128 by the tensor maps' zero fill.  A CTA serves one
// query head: the CTAs of the heads that share a KV head read its tiles
// from L2.  P is rounded to bf16 before P V (the reference keeps it
// float32): within MHA_BF16_ATOL of the plain version.  Ping-pong
// ordering of the two consumers' products (named barriers) and
// overlapping a tile's softmax with the previous tile's P V were measured
// and did not help here (PERF.md, PR 15).
//
// float32: flash_attention_kernel, on the CUDA cores, in float32
// throughout.  One block of 8 warps per (batch * head, tile of 64 query
// rows).  The query tile is staged once in shared memory; key and value
// tiles of 32 rows follow it through shared memory.  Each warp owns 8 query
// rows and each lane one key of the tile: a lane computes its key's 8 scores
// from 16-byte shared-memory reads (the query rows are broadcasts, the key
// rows are padded by 4 floats so the lanes' reads hit distinct banks), the
// warp reduces the row max and sum with shuffles, and each lane then owns
// D / 32 columns of the 8 accumulators, taking p from the key's lane by
// shuffle.  Equal to ref.py::attention_ref within float32 rounding.
//
// Both kernels can also write each row's log-sum-exp (the backward's
// input; see the entry points below).
//
// ptxas -v (sm_90a, nvcc 12.9): flash_attention_bf16 138 registers (D
// padded to 128) / 107 (64), no spills, 132,152 / 66,616 bytes of dynamic
// shared memory; flash_attention_kernel (float32) 80-128 registers, 8
// bytes of spill at D <= 32.
#include "attention.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 8;
constexpr int kBQ = kWarps * kRowsPerWarp;  // query rows per block
constexpr int kBKV = 32;                    // keys per tile: one per lane
constexpr float kNegInf = -1e30f;           // NEG_INF of kernel.py

__device__ __forceinline__ float to_float(float x) { return x; }
template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }

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
                           float* __restrict__ lse, int hq, int group,
                           int sq, int skv, int d, Strides qs, Strides ks,
                           Strides vs, float scale, int causal, int q_offset,
                           int window) {
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
    if (lse != nullptr && lane == 0)
      lse[static_cast<long long>(bh) * sq + r] = m[i] + logf(li);
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
                 float* lse, int batch, int hq, int group, int sq, int skv,
                 int d,
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
      static_cast<const T*>(v), static_cast<T*>(out), lse, hq, group, sq,
      skv, d, qs, ks, vs, scale, causal, q_offset, window);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, float* lse,
           int batch, int hq, int group, int sq, int skv, int d, Strides qs,
           Strides ks, Strides vs, float scale, int causal, int q_offset,
           int window, cudaStream_t s) {
  if (d <= 32)
    return launch_typed<32, T>(q, k, v, out, lse, batch, hq, group, sq, skv,
                               d, qs, ks, vs, scale, causal, q_offset, window,
                               s);
  if (d <= 64)
    return launch_typed<64, T>(q, k, v, out, lse, batch, hq, group, sq, skv,
                               d, qs, ks, vs, scale, causal, q_offset, window,
                               s);
  if (d <= 96)
    return launch_typed<96, T>(q, k, v, out, lse, batch, hq, group, sq, skv,
                               d, qs, ks, vs, scale, causal, q_offset, window,
                               s);
  return launch_typed<128, T>(q, k, v, out, lse, batch, hq, group, sq, skv,
                              d, qs, ks, vs, scale, causal, q_offset, window,
                              s);
}

// ---- bf16: the tensor cores ------------------------------------------------

constexpr int kFaBM = 128;      // query rows per CTA: 64 per consumer warpgroup
constexpr int kFaBN = 64;       // keys per K / V tile
constexpr int kFaStages = 3;    // K / V ring
constexpr int kFaThreads = 288; // two consumer warpgroups + the producer warp
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kNegInfL2 = kNegInf * kLog2e;  // NEG_INF in exp2's domain

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// O *= corr (per row), then O += P V for one tile: P (bf16, registers) as
// wgmma's A, V [keys, D] from shared memory as its B (issue_ab).  Issued
// and committed, not waited.
template <int DP>
__device__ __forceinline__ void issue_pv(float (&o)[DP / 2],
                                         const uint32_t (&pa)[kFaBN / 16][4],
                                         const uint8_t* v_t, float corr_a,
                                         float corr_b) {
  using namespace sm90;
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
    o[4 * j] *= corr_a;
    o[4 * j + 1] *= corr_a;
    o[4 * j + 2] *= corr_b;
    o[4 * j + 3] *= corr_b;
  }
  fence_operand(o);
  wgmma_fence();
  issue_ab<DP>(o, pa, v_t);
  wgmma_commit();
}

// DP: 64 or 128, the tensor maps' padded D (one or two 128-byte chunks)
template <int DP>
__global__ void __launch_bounds__(kFaThreads, 1)
    flash_attention_bf16(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         __nv_bfloat16* __restrict__ out,
                         float* __restrict__ lse, int hq, int group,
                         int sq, int skv, int d, sm90::MapDims qd,
                         sm90::MapDims kd, sm90::MapDims vd,
                         float scale_log2, int causal,
                         int q_offset, int window) {
  using namespace sm90;
  constexpr int kChunks = DP / 64;
  constexpr int kQChunk = kFaBM * 128;   // bytes of one 64-column q chunk
  constexpr int kKVChunk = kFaBN * 128;
  constexpr int kKVTile = kChunks * kKVChunk;
  constexpr int kOut = DP / 2;           // O floats per thread
  extern __shared__ uint8_t smem_raw[];
  uint8_t* q_s = align1024(smem_raw);
  uint8_t* k_s = q_s + kChunks * kQChunk;
  uint8_t* v_s = k_s + kFaStages * kKVTile;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(v_s + kFaStages * kKVTile);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kFaStages;

  const int tid = threadIdx.x;
  // CTAs start in the order of their linear index: the last (for a causal
  // mask, heaviest) query tile of every head first, then the next
  const int lin = blockIdx.y * gridDim.x + blockIdx.x;
  const int q0 = (gridDim.x - 1 - lin / gridDim.y) * kFaBM;
  const int bh = lin % gridDim.y, b = bh / hq, h = bh % hq, hk = h / group;
  // the key tiles any row of this CTA may attend
  const int q_lo = q_offset + q0;
  const int q_hi = q_offset + min(q0 + kFaBM, sq) - 1;
  const int kv_end = causal ? min(skv, q_hi + 1) : skv;
  const int kv_begin = window > 0 ? max(0, q_lo - window + 1) : 0;
  const int t_begin = kv_begin / kFaBN;
  const int t_end =
      kv_end > kv_begin ? (kv_end + kFaBN - 1) / kFaBN : t_begin;
  const int ntiles = t_end - t_begin;

  if (tid == 0) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int s = 0; s < kFaStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // each consumer warp, once per tile
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (tid >= 256) {  // the producer warp
    if (tid == 256) {
      mbar_expect_tx(q_full, kChunks * kQChunk);
#pragma unroll
      for (int c = 0; c < kChunks; ++c)
        tma_bhsd(q_s + c * kQChunk, &tq, q_full, qd, 64 * c, q0, h, b);
      for (int i = 0; i < ntiles; ++i) {
        const int s = i % kFaStages, kv0 = (t_begin + i) * kFaBN;
        if (i >= kFaStages) mbar_wait(&empty[s], (i / kFaStages - 1) & 1);
        mbar_expect_tx(&full[s], 2 * kKVTile);
#pragma unroll
        for (int c = 0; c < kChunks; ++c) {
          tma_bhsd(k_s + s * kKVTile + c * kKVChunk, &tk, &full[s], kd,
                   64 * c, kv0, hk, b);
          tma_bhsd(v_s + s * kKVTile + c * kKVChunk, &tv, &full[s], vd,
                   64 * c, kv0, hk, b);
        }
      }
    }
    return;
  }

  // consumer warpgroup wg: query rows r_lo .. r_lo + 63 of the CTA's tile;
  // this thread holds rows row_a and row_a + 8 of them
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int r_lo = q0 + 64 * wg;
  const bool has_rows = r_lo < sq;
  const int wq_lo = q_offset + r_lo;
  const int wq_hi = q_offset + min(r_lo + 64, sq) - 1;
  const int row_a = r_lo + 16 * warp + (lane >> 2);
  const int qpos_a = q_offset + row_a;

  float o[kOut];
#pragma unroll
  for (int i = 0; i < kOut; ++i) o[i] = 0.f;
  float m_a = kNegInfL2, m_b = kNegInfL2, l_a = 0.f, l_b = 0.f;
  mbar_wait(q_full, 0);
  for (int i = 0; i < ntiles; ++i) {
    const int s = i % kFaStages, kv0 = (t_begin + i) * kFaBN;
    mbar_wait(&full[s], (i / kFaStages) & 1);
    // tiles wholly masked for this warpgroup's rows change nothing
    const bool active =
        has_rows && !(causal && kv0 > wq_hi) &&
        !(window > 0 && kv0 + kFaBN - 1 < wq_lo - window + 1);
    float sc[kFaBN / 2];
    if (active) {
      const uint8_t* q_t = q_s + wg * 64 * 128;
      const uint8_t* k_t = k_s + s * kKVTile;
      fence_operand(sc);
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < kChunks; ++c)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_m64n64k16_bf16_ss(
              sc, sw128_desc(q_t + c * kQChunk + 32 * kk, 16, 1024),
              sw128_desc(k_t + c * kKVChunk + 32 * kk, 16, 1024),
              (c | kk) != 0);  // the first product overwrites S
      wgmma_commit();
      wgmma_wait<0>();
      fence_operand(sc);
      // tiles that cross the diagonal, the window's edge or Skv are scaled
      // and masked here, by selects (a branch per element cost a
      // reconvergence barrier per element); the others keep raw scores
      // and take the scale inside exp2's argument
      const bool edge = kv0 + kFaBN > skv ||
                        (causal && kv0 + kFaBN - 1 > wq_lo) ||
                        (window > 0 && wq_hi - kv0 >= window);
      if (edge) {
#pragma unroll
        for (int j = 0; j < kFaBN / 2; ++j) sc[j] *= scale_log2;
#pragma unroll
        for (int j = 0; j < kFaBN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kpos = kv0 + 8 * j + 2 * (lane & 3) + (e & 1);
            const int qpos = qpos_a + 8 * (e >> 1);
            const bool out = (causal && qpos < kpos) ||
                             (window > 0 && qpos - kpos >= window);
            float& x = sc[4 * j + e];
            x = kpos >= skv ? -INFINITY : out ? kNegInfL2 : x;
          }
      }
      float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
      for (int j = 0; j < kFaBN / 8; ++j) {
        mx_a = fmaxf(mx_a, fmaxf(sc[4 * j], sc[4 * j + 1]));
        mx_b = fmaxf(mx_b, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
      }
      const float fs = edge ? 1.f : scale_log2;
      const float mn_a = fmaxf(m_a, quad_max(mx_a) * fs);
      const float mn_b = fmaxf(m_b, quad_max(mx_b) * fs);
      const float corr_a = fexp2(m_a - mn_a), corr_b = fexp2(m_b - mn_b);
      m_a = mn_a;
      m_b = mn_b;
      float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
      for (int j = 0; j < kFaBN / 8; ++j) {
        sc[4 * j] = fexp2(fmaf(sc[4 * j], fs, -m_a));
        sc[4 * j + 1] = fexp2(fmaf(sc[4 * j + 1], fs, -m_a));
        sc[4 * j + 2] = fexp2(fmaf(sc[4 * j + 2], fs, -m_b));
        sc[4 * j + 3] = fexp2(fmaf(sc[4 * j + 3], fs, -m_b));
        sum_a += sc[4 * j] + sc[4 * j + 1];
        sum_b += sc[4 * j + 2] + sc[4 * j + 3];
      }
      l_a = l_a * corr_a + sum_a;  // this thread's part of the row sum
      l_b = l_b * corr_b + sum_b;
      uint32_t pa[kFaBN / 16][4];  // P as wgmma's A operand
      pack_a(pa, sc);
      issue_pv<DP>(o, pa, v_s + s * kKVTile, corr_a, corr_b);
      wgmma_wait<0>();
      fence_operand(o);
    }
    __syncwarp();  // the warp's lanes are done with the stage
    if (lane == 0) mbar_arrive(&empty[s]);
  }
  if (!has_rows) return;

  const float l_row[2] = {fmaxf(quad_sum(l_a), 1e-30f),
                          fmaxf(quad_sum(l_b), 1e-30f)};
  const float inv[2] = {1.f / l_row[0], 1.f / l_row[1]};
  const float m_row[2] = {m_a, m_b};
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = row_a + 8 * hf;
    if (row >= sq) continue;
    // the log-sum-exp in natural-log units: m is in log2 units of the
    // scaled scores
    if (lse != nullptr && (lane & 3) == 0)
      lse[static_cast<long long>(bh) * sq + row] =
          m_row[hf] * kLn2 + logf(l_row[hf]);
    __nv_bfloat16* o_row = out + (static_cast<long long>(bh) * sq + row) * d;
#pragma unroll
    for (int j = 0; j < kOut / 4; ++j) {
      const int col = 8 * j + 2 * (lane & 3);
      store_pair(o_row, col, d, o[4 * j + 2 * hf] * inv[hf],
                 o[4 * j + 2 * hf + 1] * inv[hf]);
    }
  }
}

template <int DP>
int launch_bf16(const void* q, const void* k, const void* v, void* out,
                float* lse, int batch, int hq, int hkv, int sq, int skv,
                int d, int d_out, Strides qs, Strides ks, Strides vs,
                float scale, int causal, int q_offset, int window,
                cudaStream_t s) {
  constexpr int kSmem = kFaBM * DP * 2 + 2 * kFaStages * kFaBN * DP * 2 +
                        (1 + 2 * kFaStages) * 8 + 1024;
  CUtensorMap tq, tk, tv;
  sm90::MapDims qd{}, kd{}, vd{};
  int err = sm90::map_bhsd(&tq, &qd, q, batch, hq, sq, d, qs.b, qs.h, qs.s,
                           kFaBM);
  if (!err)
    err = sm90::map_bhsd(&tk, &kd, k, batch, hkv, skv, d, ks.b, ks.h, ks.s,
                         kFaBN);
  if (!err)
    err = sm90::map_bhsd(&tv, &vd, v, batch, hkv, skv, d, vs.b, vs.h, vs.s,
                         kFaBN);
  if (err) return err;
  auto kernel = flash_attention_bf16<DP>;
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((sq + kFaBM - 1) / kFaBM, batch * hq);
  kernel<<<grid, kFaThreads, kSmem, s>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), lse, hq, hq / hkv, sq,
      skv, d_out, qd, kd, vd, scale * kLog2e, causal, q_offset, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry points bound with ctypes.  Each launches on `stream` and returns
// the first CUDA error (0 = launched), or sm90::kErrNoEncoder /
// sm90::kErrEncode (-1 / -2) when a TMA tensor map cannot be made.  The
// caller checks types, shapes, that D is contiguous, 1 <= D <= 128,
// Hq % Hkv == 0, B * Hq <= 65535, q_offset >= 0 and window >= 0.  Strides
// are in elements, in the order b, h, s.  lse, when not null, receives the
// float32 log-sum-exp [B, Hq, Sq] of each row's scaled scores in natural-log
// units (ln sum_j exp(s_ij)), which the backward (flash_attention_bwd.cu)
// reads; with a null lse the kernels do exactly what they did without it.

// float32 q, k, v on the CUDA cores
extern "C" int flash_attention_f32_launch(
    const void* q, const void* k, const void* v, void* out, int batch, int hq,
    int hkv, int sq, int skv, int d, long long q_sb, long long q_sh,
    long long q_ss, long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss, float scale, int causal,
    int q_offset, int window, float* lse, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Strides qs{q_sb, q_sh, q_ss}, ks{k_sb, k_sh, k_ss},
      vs{v_sb, v_sh, v_ss};
  return launch<float>(q, k, v, out, lse, batch, hq, hq / hkv, sq, skv, d, qs,
                       ks, vs, scale, causal, q_offset, window, s);
}

// bf16 q, k, v on the tensor cores: 16-byte aligned, every stride of a dim
// longer than 1 a multiple of 8 elements.  d is their last dim (at most
// 128), d_out <= d the width of out [B, Hq, Sq, d_out] (the wrapper pads D
// with zeros to meet the strides' rule); scale is 1 / sqrt(d_out).
extern "C" int flash_attention_bf16_launch(
    const void* q, const void* k, const void* v, void* out, int batch, int hq,
    int hkv, int sq, int skv, int d, int d_out, long long q_sb, long long q_sh,
    long long q_ss, long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss, float scale, int causal,
    int q_offset, int window, float* lse, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Strides qs{q_sb, q_sh, q_ss}, ks{k_sb, k_sh, k_ss},
      vs{v_sb, v_sh, v_ss};
  if (d <= 64)
    return launch_bf16<64>(q, k, v, out, lse, batch, hq, hkv, sq, skv, d,
                           d_out, qs, ks, vs, scale, causal, q_offset, window,
                           s);
  return launch_bf16<128>(q, k, v, out, lse, batch, hq, hkv, sq, skv, d,
                          d_out, qs, ks, vs, scale, causal, q_offset, window,
                          s);
}
