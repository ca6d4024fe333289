// attention.cuh: what the bf16 attention kernels share on sm_90a, the
// forward (flash_attention.cu) and its gradient (flash_attention_bwd.cu).
//
//  - the 4-D TMA tensor map of a bf16 [B, H, S, D] view read through its
//    strides (D contiguous), with the 128-byte swizzle and a box of 64
//    columns: D past the view's width and rows past S read as zero, so D
//    of 32 or 80 pads to 64 or 128 and a ragged last tile to its box;
//  - the load of one box by TMA, given which of the map's dims hold S, H
//    and B;
//  - two floats packed as a bf16 pair, a 64 x 64 float32 accumulator
//    packed as wgmma's A operand, the product of that operand with a
//    64-row tile read MN-major (P V in the forward; P^T dO, dS^T Q and
//    dS K in the backward), and 2^x on the special-function unit;
//  - the store of two columns of a bf16 output row.
#pragma once

#include <cuda_bf16.h>

#include "sm90.cuh"

namespace sm90 {

// which of a view's 4-D tensor-map dims (1-3) hold S, H and B
struct MapDims {
  int s, h, b;
};

__device__ __forceinline__ void tma_bhsd(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, MapDims md, int col,
                                         int row, int head, int batch) {
  const int c1 = md.s == 1 ? row : md.h == 1 ? head : batch;
  const int c2 = md.s == 2 ? row : md.h == 2 ? head : batch;
  const int c3 = md.s == 3 ? row : md.h == 3 ? head : batch;
  tma_load_4d(dst, map, bar, col, c1, c2, c3);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// a 64 x 64 float32 accumulator (wgmma fragments) as wgmma's bf16 A
// operand: columns 16 kk .. 16 kk + 15 are its 8-column blocks 2 kk and
// 2 kk + 1
__device__ __forceinline__ void pack_a(uint32_t (&a)[4][4],
                                       const float (&x)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[kk][r] = pack_bf16(x[8 * kk + 2 * r], x[8 * kk + 2 * r + 1]);
}

// acc += A B for A [64, 64] bf16 in registers (pack_a) and B [64, DP] a
// 64-row tile in shared memory read MN-major (transpose bit), its
// 64-column chunks 64 x 128 bytes apart; DP is 64 or 128.  Issued, not
// committed.
template <int DP>
__device__ __forceinline__ void issue_ab(float (&acc)[DP / 2],
                                         const uint32_t (&a)[4][4],
                                         const uint8_t* b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t db = sw128_desc(b + kk * 16 * 128, 64 * 128, 1024);
    if constexpr (DP == 128)
      wgmma_m64n128k16_bf16_rs_tb(acc, a[kk], db, 1);
    else
      wgmma_m64n64k16_bf16_rs_tb(acc, a[kk], db, 1);
  }
}

// columns col and col + 1 of a bf16 row of d columns
__device__ __forceinline__ void store_pair(__nv_bfloat16* row, int col, int d,
                                           float lo, float hi) {
  if (col + 1 < d && (d & 1) == 0) {
    *reinterpret_cast<__nv_bfloat162*>(row + col) =
        __floats2bfloat162_rn(lo, hi);
  } else {
    if (col < d) row[col] = __float2bfloat16_rn(lo);
    if (col + 1 < d) row[col + 1] = __float2bfloat16_rn(hi);
  }
}

// 2^x on the special-function unit (exp2f adds a denormal path)
__device__ __forceinline__ float fexp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// the 4-D tensor map of a bf16 [B, H, S, D] view with D contiguous: D
// innermost, then S, H and B by increasing stride (a dim of size 1 last,
// with any valid stride); a box of 64 columns x box_rows rows
inline int map_bhsd(CUtensorMap* map, MapDims* md, const void* ptr,
                    int batch, int heads, int seq, int d, long long sb,
                    long long sh, long long ss, int box_rows) {
  struct Dim {
    long long size, stride;
    int which;  // 0 S, 1 H, 2 B
  } dims[3] = {{seq, ss, 0}, {heads, sh, 1}, {batch, sb, 2}};
  auto later = [](const Dim& x, const Dim& y) {  // x after y
    if ((x.size == 1) != (y.size == 1)) return x.size == 1;
    return x.size != 1 && x.stride > y.stride;
  };
  for (int i = 1; i < 3; ++i)
    for (int j = i; j > 0 && later(dims[j - 1], dims[j]); --j) {
      const Dim t = dims[j];
      dims[j] = dims[j - 1];
      dims[j - 1] = t;
    }
  cuuint64_t gdim[4] = {static_cast<cuuint64_t>(d), 0, 0, 0};
  cuuint64_t gstride[3];
  cuuint32_t box[4] = {64, 1, 1, 1};
  int* slot[3] = {&md->s, &md->h, &md->b};
  unsigned long long extent = 2ull * d;  // bytes spanned by the dims so far
  for (int i = 0; i < 3; ++i) {
    gdim[i + 1] = static_cast<cuuint64_t>(dims[i].size);
    gstride[i] = dims[i].size == 1 ? (extent + 15) / 16 * 16
                                   : 2ull * dims[i].stride;
    extent = gstride[i] * gdim[i + 1];
    *slot[dims[i].which] = i + 1;
    if (dims[i].which == 0) box[i + 1] = static_cast<cuuint32_t>(box_rows);
  }
  return encode_sw128(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, ptr, gdim,
                      gstride, box);
}

}  // namespace sm90
