// gini_counts: decision-tree split-evaluate counts, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/gini_split/kernel.py:58
// (gini_counts, pallas_call at :70).  Per simulated core c, leaf l, class k
// and feature f:
//   counts[c,l,k,f] = #{rows r of core c : leaf[r] = l, y[r] = k,
//                       x[r,f] <= th[l,f]}
//   totals[c,l,k]   = #{rows r of core c : leaf[r] = l, y[r] = k}
// bit-identical to repro/kernels/gini_split/ref.py and to the plain version
// in repro_torch/kernels/gini_split.py.  Rows whose leaf is outside [0, L) or
// whose class is outside [0, Cls) count nowhere.  Unlike the reference's
// ops.py this kernel checks its own ragged tail, so there is no spill slot
// and no pad correction here: the trainer's valid-mask correction is the
// only one.
//
// Input: x f32 [C, n_pc, F], y and leaf int32 [C, n_pc] (the cores' resident
// shards, one launch for all cores), th f32 [L, F] (the broadcast
// thresholds).  Outputs, zeroed by the caller and reduced over the cores by
// map_reduce: counts int32 [C, L, Cls, F] and totals int32 [C, L, Cls].
//
// Bound on the H100: bytes.  A row reads 4F + 8 bytes and does F compares;
// the outputs are C*L*Cls*(F+1) int32, written once.
//
// Design.  A core's partial (L = 4096 leaves, Cls = 2, F = 16: 512 KB) does
// not fit in shared memory, and at the root round every row of a core hits
// the same Cls*F counters.  So:
//  - A block owns a run of one core's rows (grid.y = core).  It first finds
//    the smallest and largest leaf among them and keeps a shared-memory
//    window of the leaves [lo, lo + W) (W*Cls*(F+1) int32 in 48 KB); rows
//    of leaves past the window add straight to global memory.  At the end
//    the block adds each non-zero window entry to its core's partial with
//    one global atomicAdd.
//  - A warp aggregates before it touches memory: __match_any_sync groups the
//    lanes that share a (leaf, class) slot, and for each feature the lowest
//    lane of a group adds the popcount of the group's below-threshold ballot.
//    At the root round that is one atomic per warp, class and feature
//    instead of 32.
//  - The threshold is gathered directly as th[leaf, f] and compared with the
//    same f32 `<=` as the reference.  (The Pallas kernel forms it with a
//    one-hot f32 matmul, exact only because one term is non-zero; a direct
//    gather is exact without that condition.)
// Integer adds do not depend on order, so the counts are exact under any
// schedule of the atomics.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerThread = 16;
constexpr int kRowsPerBlock = kThreads * kRowsPerThread;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void add_count(int32_t* win, int32_t* glob,
                                          int w, int w_eff, long long win_off,
                                          long long glob_off, int32_t v) {
  if (static_cast<unsigned>(w) < static_cast<unsigned>(w_eff))
    atomicAdd(&win[win_off], v);
  else
    atomicAdd(&glob[glob_off], v);
}

template <int kF, bool kVec>
__global__ void gini_counts_kernel(const float* __restrict__ x,
                                   const int32_t* __restrict__ y,
                                   const int32_t* __restrict__ leaf,
                                   const float* __restrict__ th,
                                   int32_t* __restrict__ counts,
                                   int32_t* __restrict__ totals,
                                   long long n_pc, int f_dim, int n_leaves,
                                   int n_cls, int win_cap) {
  extern __shared__ int32_t smem[];
  __shared__ int warp_lo[kThreads / 32], warp_hi[kThreads / 32];
  __shared__ int win_lo, win_n;

  const long long core = blockIdx.y;
  const long long row0 = static_cast<long long>(blockIdx.x) * kRowsPerBlock;
  long long row_end = row0 + kRowsPerBlock;
  if (row_end > n_pc) row_end = n_pc;
  const long long base = core * n_pc;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  // -- the block's leaf range, for the shared-memory window -----------------
  int lo = INT_MAX, hi = -1;
  for (long long r = row0 + threadIdx.x; r < row_end; r += blockDim.x) {
    const int l = leaf[base + r], k = y[base + r];
    if (l >= 0 && l < n_leaves && k >= 0 && k < n_cls) {
      lo = min(lo, l);
      hi = max(hi, l);
    }
  }
  lo = __reduce_min_sync(kFull, lo);
  hi = __reduce_max_sync(kFull, hi);
  if (lane == 0) {
    warp_lo[warp] = lo;
    warp_hi[warp] = hi;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int i = 1; i < kThreads / 32; ++i) {
      lo = min(lo, warp_lo[i]);
      hi = max(hi, warp_hi[i]);
    }
    win_lo = lo;
    win_n = hi < lo ? 0 : min(win_cap, hi - lo + 1);
  }
  __syncthreads();
  const int w_lo = win_lo, w_eff = win_n;
  const int slots = n_cls * f_dim;           // entries per leaf in counts
  int32_t* win_cnt = smem;                   // [W, Cls, F]
  int32_t* win_tot = smem + w_eff * slots;   // [W, Cls]
  for (int i = threadIdx.x; i < w_eff * (slots + n_cls); i += blockDim.x)
    smem[i] = 0;
  __syncthreads();

  int32_t* cnt_c = counts + core * n_leaves * slots;
  int32_t* tot_c = totals + core * n_leaves * n_cls;

  // -- count: every lane of a warp runs every iteration (warp intrinsics) ---
  for (long long rb = row0 + warp * 32; rb < row_end; rb += kThreads) {
    const long long r = rb + lane;
    int l = -1, k = 0;
    if (r < row_end) {
      l = leaf[base + r];
      k = y[base + r];
    }
    const bool ok = l >= 0 && l < n_leaves && k >= 0 && k < n_cls;
    const int seg = ok ? l * n_cls + k : -1;
    const unsigned peers = __match_any_sync(kFull, seg);
    const bool leader = ok && (__ffs(peers) - 1) == lane;
    const int w = l - w_lo;
    if (leader)
      add_count(win_tot, tot_c, w, w_eff, static_cast<long long>(w) * n_cls + k,
                static_cast<long long>(seg), __popc(peers));

    const float* xr = x + (base + (ok ? r : 0)) * f_dim;
    const float* tr = th + static_cast<long long>(ok ? l : 0) * f_dim;
    const long long woff = (static_cast<long long>(w) * n_cls + k) * f_dim;
    const long long goff = static_cast<long long>(seg) * f_dim;
    if constexpr (kF > 0) {
      float xv[kF], tv[kF];
      if (ok) {
        if constexpr (kVec) {
#pragma unroll
          for (int j = 0; j < kF; j += 4) {
            const float4 a = __ldg(reinterpret_cast<const float4*>(xr + j));
            const float4 b = __ldg(reinterpret_cast<const float4*>(tr + j));
            xv[j] = a.x; xv[j + 1] = a.y; xv[j + 2] = a.z; xv[j + 3] = a.w;
            tv[j] = b.x; tv[j + 1] = b.y; tv[j + 2] = b.z; tv[j + 3] = b.w;
          }
        } else {
#pragma unroll
          for (int f = 0; f < kF; ++f) {
            xv[f] = __ldg(xr + f);
            tv[f] = __ldg(tr + f);
          }
        }
      }
#pragma unroll
      for (int f = 0; f < kF; ++f) {
        const unsigned below = __ballot_sync(kFull, ok && xv[f] <= tv[f]);
        const int n = __popc(below & peers);
        if (leader && n) add_count(win_cnt, cnt_c, w, w_eff, woff + f,
                                   goff + f, n);
      }
    } else {
      for (int f = 0; f < f_dim; ++f) {
        const bool b = ok && __ldg(xr + f) <= __ldg(tr + f);
        const unsigned below = __ballot_sync(kFull, b);
        const int n = __popc(below & peers);
        if (leader && n) add_count(win_cnt, cnt_c, w, w_eff, woff + f,
                                   goff + f, n);
      }
    }
  }
  __syncthreads();

  // -- flush the window into the core's partial -----------------------------
  const long long cnt_off = static_cast<long long>(w_lo) * slots;
  for (int i = threadIdx.x; i < w_eff * slots; i += blockDim.x)
    if (win_cnt[i]) atomicAdd(&cnt_c[cnt_off + i], win_cnt[i]);
  const long long tot_off = static_cast<long long>(w_lo) * n_cls;
  for (int i = threadIdx.x; i < w_eff * n_cls; i += blockDim.x)
    if (win_tot[i]) atomicAdd(&tot_c[tot_off + i], win_tot[i]);
}

}  // namespace

// C entry point bound with ctypes.  Launches on `stream`; returns
// cudaGetLastError() (0 = launched).  The caller checks types, shapes,
// contiguity and 1 <= C <= 65535, zeroes counts and totals, and passes
// win_cap, the window's leaves: win_cap * Cls * (F + 1) * 4 bytes of shared
// memory, at most 48 KB (0 sends every count to global memory).  vec = 1
// asks for 16-byte loads (F % 4 == 0, x and th 16-byte aligned).
extern "C" int gini_counts_launch(const void* x, const void* y,
                                  const void* leaf, const void* th,
                                  void* counts, void* totals, int n_cores,
                                  long long n_pc, int f_dim, int n_leaves,
                                  int n_cls, int win_cap, int vec,
                                  void* stream) {
  const long long blocks_x = (n_pc + kRowsPerBlock - 1) / kRowsPerBlock;
  const dim3 grid(static_cast<unsigned>(blocks_x),
                  static_cast<unsigned>(n_cores));
  const size_t smem = static_cast<size_t>(win_cap) * n_cls * (f_dim + 1) *
                      sizeof(int32_t);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const float*>(x);
  const auto* yp = static_cast<const int32_t*>(y);
  const auto* lp = static_cast<const int32_t*>(leaf);
  const auto* tp = static_cast<const float*>(th);
  auto* cp = static_cast<int32_t*>(counts);
  auto* op = static_cast<int32_t*>(totals);
  if (f_dim == 16 && vec)
    gini_counts_kernel<16, true><<<grid, kThreads, smem, s>>>(
        xp, yp, lp, tp, cp, op, n_pc, f_dim, n_leaves, n_cls, win_cap);
  else if (f_dim == 16)
    gini_counts_kernel<16, false><<<grid, kThreads, smem, s>>>(
        xp, yp, lp, tp, cp, op, n_pc, f_dim, n_leaves, n_cls, win_cap);
  else
    gini_counts_kernel<0, false><<<grid, kThreads, smem, s>>>(
        xp, yp, lp, tp, cp, op, n_pc, f_dim, n_leaves, n_cls, win_cap);
  return static_cast<int>(cudaGetLastError());
}
