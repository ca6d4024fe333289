// emb_gather: shard-local embedding row lookup, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/sparse_gather/kernel.py:48
// (emb_gather, pallas_call at :56).  Per simulated core c and lookup b:
//   out[c,b,:] = sum over the rows r with ids[c,r] == idx[b] of table[c,r,:]
// summed from zero in ascending r.  A shard owns each id at most once, so
// this is a copy of the row when core c owns idx[b] and exact zeros when it
// does not (ROW_PAD_ID = -1 pad slots and IDX_PAD = -2 lookups never match a
// real id); summing the cores' partials, the fabric reduce, rebuilds the
// looked-up rows.  Equal to repro/kernels/sparse_gather/ref.py and to the
// plain version in repro_torch/kernels/sparse_gather.py on finite tables:
// the reference's one-hot dot multiplies every row by 0 or 1, so a NaN or an
// infinity anywhere in a shard reaches every lookup of that shard there, and
// a -0.0 row may come back as +0.0 in either; this kernel reads only the
// matching rows.  Integer sums wrap in uint32_t, as XLA's int32 dot does.
//
// Inputs: table [C, R, D] (int32 Q(f) or float32), ids int32 [C, R], idx
// int32 [B].  Output: out [C, B, D], every element written.
//
// Bound on the H100: bytes.  The work is C*R*B id compares (30.8M at the
// EMB main shape C=2048, R=235, B=64) against the ids read once (1.9 MB) and
// the [C, B, D] partials written once (8.4 MB at D=16), a few microseconds of
// either.  The compares are the kernel's own cost: the table rows it copies
// are the B that match.
//
// Design: the grid is (lookup groups, cores): a block stages its core's ids
// in shared memory when they fit (R <= 12288, 48 KB; else it reads them from
// global memory through L1) and its 8 warps take the group's lookups in
// turn, up to 8 each, so that one block per core serves the 64 lookups of an
// eager batch (a block per 8 lookups left 16,384 blocks of a few hundred
// cycles' work each, and the kernel ran at launch-wave latency).  The warp's
// lanes test 32 ids at a time and ballot; each match, in ascending r, is
// added into one accumulator per lane (lane = column, 32 columns per pass),
// so the row read and the partial write are coalesced.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kLookupsPerBlock = kWarps * 8;
constexpr int kMaxStagedIds = 12288;

template <typename T>
struct Sum;  // accumulator of one column: float, or uint32_t (wrapping)

template <>
struct Sum<float> {
  using Acc = float;
  __device__ static Acc add(Acc a, float v) { return a + v; }
  __device__ static float done(Acc a) { return a; }
};

template <>
struct Sum<int32_t> {
  using Acc = uint32_t;
  __device__ static Acc add(Acc a, int32_t v) {
    return a + static_cast<uint32_t>(v);
  }
  __device__ static int32_t done(Acc a) { return static_cast<int32_t>(a); }
};

template <typename T, bool kStaged>
__global__ void emb_gather_kernel(const T* __restrict__ table,
                                  const int32_t* __restrict__ ids,
                                  const int32_t* __restrict__ idx,
                                  T* __restrict__ out, int n_rows, int dim,
                                  int n_idx) {
  extern __shared__ int32_t ids_s[];
  const long long core = blockIdx.y;
  const int32_t* ids_c = ids + core * n_rows;
  if constexpr (kStaged) {
    for (int i = threadIdx.x; i < n_rows; i += kThreads) ids_s[i] = ids_c[i];
    __syncthreads();
  }
  const int lane = threadIdx.x & 31;
  const T* tab_c = table + core * n_rows * dim;
  int b_end = (blockIdx.x + 1) * kLookupsPerBlock;
  if (b_end > n_idx) b_end = n_idx;
  // warp-uniform loop: no barrier follows, so a warp may finish early
  for (int b = blockIdx.x * kLookupsPerBlock + (threadIdx.x >> 5); b < b_end;
       b += kWarps) {
    const int32_t key = __ldg(idx + b);
    T* out_b = out + (core * n_idx + b) * dim;
    for (int d0 = 0; d0 < dim; d0 += 32) {
      const int d = d0 + lane;
      typename Sum<T>::Acc acc = 0;
      for (int r0 = 0; r0 < n_rows; r0 += 32) {
        const int r = r0 + lane;
        bool hit = false;
        if (r < n_rows) hit = (kStaged ? ids_s[r] : __ldg(ids_c + r)) == key;
        unsigned mask = __ballot_sync(0xffffffffu, hit);
        while (mask) {  // warp-uniform: matches in ascending r
          const int j = __ffs(mask) - 1;
          mask &= mask - 1;
          if (d < dim)
            acc = Sum<T>::add(
                acc, __ldg(tab_c + static_cast<long long>(r0 + j) * dim + d));
        }
      }
      if (d < dim) out_b[d] = Sum<T>::done(acc);
    }
  }
}

template <typename T>
int launch(const void* table, const void* ids, const void* idx, void* out,
           int n_cores, int n_rows, int dim, int n_idx, cudaStream_t s) {
  const dim3 grid(
      static_cast<unsigned>((n_idx + kLookupsPerBlock - 1) / kLookupsPerBlock),
      static_cast<unsigned>(n_cores));
  const auto* tp = static_cast<const T*>(table);
  const auto* ip = static_cast<const int32_t*>(ids);
  const auto* xp = static_cast<const int32_t*>(idx);
  auto* op = static_cast<T*>(out);
  if (n_rows <= kMaxStagedIds)
    emb_gather_kernel<T, true>
        <<<grid, kThreads, static_cast<size_t>(n_rows) * sizeof(int32_t), s>>>(
            tp, ip, xp, op, n_rows, dim, n_idx);
  else
    emb_gather_kernel<T, false><<<grid, kThreads, 0, s>>>(tp, ip, xp, op,
                                                          n_rows, dim, n_idx);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry point bound with ctypes.  Launches on `stream`; returns
// cudaGetLastError() (0 = launched).  The caller checks types, shapes,
// contiguity, 1 <= C <= 65535, R >= 1 and B >= 1; is_float picks float32
// over int32.
extern "C" int emb_gather_launch(const void* table, const void* ids,
                                 const void* idx, void* out, int n_cores,
                                 int n_rows, int dim, int n_idx, int is_float,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_float)
    return launch<float>(table, ids, idx, out, n_cores, n_rows, dim, n_idx,
                         s);
  return launch<int32_t>(table, ids, idx, out, n_cores, n_rows, dim, n_idx,
                         s);
}
