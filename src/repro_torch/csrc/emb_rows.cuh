// emb_rows.cuh: what emb_gather.cu and emb_scatter_add.cu share.
//
//  - row words: the kernels move rows as 32-bit words, four to a 16-byte
//    uint4 where the width and the pointers allow, else one at a time; sums
//    are float adds (kFloat) or uint32_t adds, which wrap as int32 does;
//  - lower_bounds: several binary searches of one ascending int32 array at
//    once, probe by probe, so that their loads are in flight together.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace emb {

template <bool kFloat>
__device__ __forceinline__ uint32_t add(uint32_t a, uint32_t b) {
  if constexpr (kFloat)
    return __float_as_uint(__uint_as_float(a) + __uint_as_float(b));
  else
    return a + b;
}

template <bool kFloat>
__device__ __forceinline__ uint32_t vadd(uint32_t a, uint32_t b) {
  return add<kFloat>(a, b);
}

template <bool kFloat>
__device__ __forceinline__ uint4 vadd(uint4 a, uint4 b) {
  return make_uint4(add<kFloat>(a.x, b.x), add<kFloat>(a.y, b.y),
                    add<kFloat>(a.z, b.z), add<kFloat>(a.w, b.w));
}

// pos[u] = how many of keys[0, n) are below key[u] (the first index whose
// key is >= key[u]), for kN keys at once.  keys ascend; top is the largest
// power of two <= n, or 0 when n == 0.  keys may point to shared or to
// global memory.
template <int kN>
__device__ __forceinline__ void lower_bounds(const int32_t* keys, int n,
                                             int top, const int32_t* key,
                                             int* pos) {
#pragma unroll
  for (int u = 0; u < kN; ++u) pos[u] = 0;
  for (int step = top; step > 0; step >>= 1) {
#pragma unroll
    for (int u = 0; u < kN; ++u)
      if (pos[u] + step <= n && keys[pos[u] + step - 1] < key[u])
        pos[u] += step;
  }
}

// 16-byte rows: width % 4 == 0 and every row pointer 16-byte aligned
inline bool vec4(int dim, const void* const* ptrs, int n_ptrs) {
  if (dim % 4) return false;
  for (int i = 0; i < n_ptrs; ++i)
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16) return false;
  return true;
}

inline int pow2_floor(int n) {
  unsigned p = 0;
  for (unsigned s = 1; s <= static_cast<unsigned>(n); s <<= 1) p = s;
  return static_cast<int>(p);
}

}  // namespace emb
