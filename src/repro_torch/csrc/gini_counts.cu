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
// whose class is outside [0, Cls) count nowhere (the trainer sends its
// invalid rows to leaf -1).
//
// Input: x f32 [C, n_pc, F], y and leaf int32 [C, n_pc] (the cores' resident
// shards, one launch for all cores), th f32 [L, F] (the broadcast
// thresholds).  Outputs: counts int32 [C, L, Cls, F] and totals int32
// [C, L, Cls], the per-core partials that map_reduce reduces over the cores.
// The kernel writes every entry of them: the caller allocates them empty.
//
// Bound on the H100: bytes.  A row reads 4F + 8 bytes and does F compares;
// the outputs are C*L*Cls*(F+1) int32, written once.  At [2048, 37500, 16]
// and L = 4096 that is 5.5 GB read and 1.14 GB written.
//
// What held the first port back: its output was zeroed by a memset and then
// filled by ~10 blocks per core with global atomics, one per non-zero entry
// of each block's shared-memory window; with leaves spread wide that is
// hundreds of millions of global atomics a launch.  So here each core's
// partial has one writer:
//  - One block owns one core (grid.y = core) and streams all its rows.  A
//    first pass over the core's leaf ids finds the range [lo, hi] they
//    span; the block keeps counters for the window [lo, lo + W) in opt-in
//    dynamic shared memory (W = 2,048 leaves at Cls = 2, F = 16: the 2,047
//    node ids a depth-10 tree numbers; 144 KB, so that L1, which shares the
//    SM's 256 KB with it, keeps room for the streamed rows).  It
//    stores zeros to the rest of the partial first, and at the end writes
//    the window with plain coalesced stores, zeros included: no memset, no
//    global atomics.  Rows of leaves past the window (a range wider than W)
//    add to the zeroed partial with global atomics: correct for any shape,
//    fast only where the window holds the range.
//  - Too few cores to fill the card (fewer than its SMs; at 2,048 cores
//    never): a core's rows split over grid.x blocks of rows_per_cta rows,
//    each with its own window over its own rows.  The caller then zeroes
//    the partial and each block adds its window's non-zero entries with
//    one global atomic each, at every flush.  One block a core would leave
//    most SMs idle there (at 16 cores, 116 of 132).
//  - Counters are 16 bits, two to a 32-bit word: counter j of a (leaf,
//    class) slot is feature j for j < F and the slot's total for j = F.  One
//    shared atomic then adds to two counters, and the window holds twice the
//    leaves.  A 16-bit counter must not carry, so the rows run in passes of
//    at most 65,535 (ROWS_PER_PASS in the wrapper's plan): after each pass
//    the window is flushed and zeroed (the first pass stores, later passes
//    add with plain loads and stores, which only this block makes).
//  - A narrow range leaves room for several copies of the window; warps
//    spread over the copies, so that at the root round 32 warps do not all
//    add into the same few words.  The copies are summed at the flush (the
//    rows of one pass number at most 65,535 over all copies, so the packed
//    sum cannot carry either).
//  - A warp aggregates before it touches memory: __match_any_sync groups the
//    lanes that share a (leaf, class) slot, and for each feature the lowest
//    lane of a group adds the popcount of the group's below-threshold ballot.
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

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// Block-cooperative zero stores of p[0, n), 16 bytes at a time where aligned.
__device__ __forceinline__ void zero_fill(int32_t* p, long long n) {
  if (n <= 0) return;
  const int mis = static_cast<int>((reinterpret_cast<uintptr_t>(p) & 15) / 4);
  long long head = mis ? 4 - mis : 0;
  if (head > n) head = n;
  for (long long i = threadIdx.x; i < head; i += kThreads) p[i] = 0;
  int4* q = reinterpret_cast<int4*>(p + head);
  const long long nv = (n - head) / 4;
  for (long long i = threadIdx.x; i < nv; i += kThreads)
    q[i] = make_int4(0, 0, 0, 0);
  for (long long i = head + nv * 4 + threadIdx.x; i < n; i += kThreads)
    p[i] = 0;
}

template <int kF, bool kVec>
__global__ void __launch_bounds__(kThreads, 1)
gini_counts_kernel(const float* __restrict__ x, const int32_t* __restrict__ y,
                   const int32_t* __restrict__ leaf,
                   const float* __restrict__ th, int32_t* __restrict__ counts,
                   int32_t* __restrict__ totals, long long n_pc,
                   long long rows_per_cta, int f_dim, int n_leaves,
                   int n_cls, int win_words, int rows_per_pass) {
  extern __shared__ uint32_t win[];   // [copies][W][Cls][wps] 2 x u16
  __shared__ int red_lo[kWarps], red_hi[kWarps];
  __shared__ int s_lo, s_n, s_copies;

  const int F = kF > 0 ? kF : f_dim;
  const int wps = (F + 2) / 2;        // words per slot: counters 0..F
  const int slot_words = n_cls * wps;
  const long long core = blockIdx.y;
  const long long base = core * n_pc;
  // this block's rows of the core; several blocks a core add into zeros
  const long long r_lo = blockIdx.x * rows_per_cta;
  const long long r_hi = min(n_pc, r_lo + rows_per_cta);
  const bool adds = gridDim.x > 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  // -- the rows' leaf range, for the shared-memory window -------------------
  int lo = INT_MAX, hi = -1;
#pragma unroll 8
  for (long long r = r_lo + threadIdx.x; r < r_hi; r += kThreads) {
    const int l = leaf[base + r];
    if (l >= 0 && l < n_leaves) {
      lo = min(lo, l);
      hi = max(hi, l);
    }
  }
  lo = __reduce_min_sync(kFull, lo);
  hi = __reduce_max_sync(kFull, hi);
  if (lane == 0) {
    red_lo[warp] = lo;
    red_hi[warp] = hi;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int i = 1; i < kWarps; ++i) {
      lo = min(lo, red_lo[i]);
      hi = max(hi, red_hi[i]);
    }
    const int n = hi < lo ? 0 : min(hi - lo + 1, win_words / slot_words);
    s_lo = n ? lo : 0;
    s_n = n;
    s_copies = n ? min(kWarps, win_words / (n * slot_words)) : 1;
  }
  __syncthreads();
  const int w_lo = s_lo, w_n = s_n, copies = s_copies;
  const int copy_words = w_n * slot_words;
  uint32_t* mine = win + (warp % copies) * copy_words;

  // -- zeros outside the window, before any row can add there ---------------
  const long long leaf_cnt = static_cast<long long>(n_cls) * F;
  int32_t* cnt_c = counts + core * n_leaves * leaf_cnt;
  int32_t* tot_c = totals + core * n_leaves * n_cls;
  if (!adds) {
    const long long w_hi = static_cast<long long>(w_lo) + w_n;
    zero_fill(cnt_c, w_lo * leaf_cnt);
    zero_fill(cnt_c + w_hi * leaf_cnt, (n_leaves - w_hi) * leaf_cnt);
    zero_fill(tot_c, static_cast<long long>(w_lo) * n_cls);
    zero_fill(tot_c + w_hi * n_cls, (n_leaves - w_hi) * n_cls);
    __threadfence();
  }

  for (long long p0 = r_lo; p0 < r_hi; p0 += rows_per_pass) {
    const long long p1 = min(r_hi, p0 + rows_per_pass);
    for (int i = threadIdx.x; i < copies * copy_words; i += kThreads)
      win[i] = 0;
    __syncthreads();

    // -- count: every lane of a warp runs every iteration (warp intrinsics)
    for (long long rb = p0 + warp * 32; rb < p1; rb += kThreads) {
      const long long r = rb + lane;
      const long long rr = base + (r < p1 ? r : p0);
      // loads do not wait for the validity test: x does not depend on it
      const int l = leaf[rr], k = y[rr];
      const bool ok = r < p1 && l >= 0 && l < n_leaves && k >= 0 &&
                      k < n_cls;
      const float* xr = x + rr * F;
      const float* tr = th + static_cast<long long>(ok ? l : 0) * F;
      const int seg = ok ? l * n_cls + k : -1;
      const unsigned peers = __match_any_sync(kFull, seg);
      const bool leader = ok && (__ffs(peers) - 1) == lane;
      const int w = l - w_lo;
      const bool in_win =
          static_cast<unsigned>(w) < static_cast<unsigned>(w_n);
      uint32_t* ws = mine + (w * n_cls + k) * wps;
      int32_t* gc = cnt_c + static_cast<long long>(seg) * F;
      int32_t* gt = tot_c + seg;

      // x and th of this row: registers for F = 16, memory otherwise
      float xv[kF > 0 ? kF : 1], tv[kF > 0 ? kF : 1];
      if constexpr (kF > 0 && kVec) {
#pragma unroll
        for (int j = 0; j < kF; j += 4) {
          const float4 a = __ldg(reinterpret_cast<const float4*>(xr + j));
          const float4 b = __ldg(reinterpret_cast<const float4*>(tr + j));
          xv[j] = a.x; xv[j + 1] = a.y; xv[j + 2] = a.z; xv[j + 3] = a.w;
          tv[j] = b.x; tv[j + 1] = b.y; tv[j + 2] = b.z; tv[j + 3] = b.w;
        }
      } else if constexpr (kF > 0) {
#pragma unroll
        for (int f = 0; f < kF; ++f) {
          xv[f] = __ldg(xr + f);
          tv[f] = __ldg(tr + f);
        }
      }
      // counter j of the group: feature j's below-threshold rows for
      // j < F, the group's rows for j = F, nothing past it
      auto below = [&](int j) {
        if constexpr (kF > 0) return xv[j] <= tv[j];
        return __ldg(xr + j) <= __ldg(tr + j);
      };
      auto count = [&](int j) {
        if (j < F) return __popc(__ballot_sync(kFull, ok && below(j)) & peers);
        return j == F ? __popc(peers) : 0;
      };
#pragma unroll
      for (int j = 0; j <= F; j += 2) {
        const int n0 = count(j), n1 = count(j + 1);
        if (leader) {
          if (in_win) {
            const uint32_t v = static_cast<uint32_t>(n0) |
                               (static_cast<uint32_t>(n1) << 16);
            if (v) atomicAdd(&ws[j / 2], v);
          } else {
            if (n0) atomicAdd(j < F ? gc + j : gt, n0);
            if (n1) atomicAdd(j + 1 < F ? gc + j + 1 : gt, n1);
          }
        }
      }
    }
    __syncthreads();

    // -- flush the window (the copies summed) into the core's partial --------
    // Entry i maps to the same thread in every pass, so a later pass reads
    // back what this thread stored.  Blocks that share a core add instead.
    const bool first = p0 == r_lo;
    auto put = [&](int32_t* p, int32_t v) {
      if (adds) {
        if (v) atomicAdd(p, v);
      } else {
        *p = first ? v : *p + v;
      }
    };
    int32_t* cnt_w = cnt_c + w_lo * leaf_cnt;
    for (int i = threadIdx.x; i < w_n * n_cls * F; i += kThreads) {
      const int slot = i / F, f = i - slot * F;
      const int off = slot * wps + (f >> 1);
      uint32_t s = 0;
      for (int c = 0; c < copies; ++c) s += win[c * copy_words + off];
      const int32_t v = static_cast<int32_t>((s >> ((f & 1) * 16)) & 0xffffu);
      put(cnt_w + i, v);
    }
    int32_t* tot_w = tot_c + static_cast<long long>(w_lo) * n_cls;
    for (int i = threadIdx.x; i < w_n * n_cls; i += kThreads) {
      const int off = i * wps + (F >> 1);
      uint32_t s = 0;
      for (int c = 0; c < copies; ++c) s += win[c * copy_words + off];
      const int32_t v = static_cast<int32_t>((s >> ((F & 1) * 16)) & 0xffffu);
      put(tot_w + i, v);
    }
    __syncthreads();
  }
}

template <int kF, bool kVec>
int launch(const float* x, const int32_t* y, const int32_t* leaf,
           const float* th, int32_t* counts, int32_t* totals, int n_cores,
           long long n_pc, int ctas_per_core, long long rows_per_cta,
           int f_dim, int n_leaves, int n_cls, int win_words,
           int rows_per_pass, cudaStream_t s) {
  const size_t smem = static_cast<size_t>(win_words) * sizeof(uint32_t);
  auto* fn = gini_counts_kernel<kF, kVec>;
  static size_t opted_in = 48 * 1024;   // per instantiation
  if (smem > opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = smem;
  }
  const dim3 grid(ctas_per_core, n_cores);
  fn<<<grid, kThreads, smem, s>>>(x, y, leaf, th, counts, totals, n_pc,
                                  rows_per_cta, f_dim, n_leaves, n_cls,
                                  win_words, rows_per_pass);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry point bound with ctypes.  Launches on `stream`; returns the CUDA
// error (0 = launched).  The caller checks types, shapes, contiguity and
// 1 <= C <= 65,535, and passes the plan of
// repro_torch/kernels/gini_split.py::gini_plan: ctas_per_core blocks of
// rows_per_cta rows a core (ctas_per_core * rows_per_cta >= n_pc); win_words,
// the window's 32-bit words (dynamic shared memory / 4, a multiple of the
// Cls * ceil((F + 1) / 2) words of a leaf); rows_per_pass <= 65,535.  It
// allocates counts and totals: empty where ctas_per_core = 1 (this kernel
// writes every entry), zeroed otherwise.  vec = 1 asks for 16-byte loads
// (F % 4 == 0, x and th 16-byte aligned).
extern "C" int gini_counts_launch(const void* x, const void* y,
                                  const void* leaf, const void* th,
                                  void* counts, void* totals, int n_cores,
                                  long long n_pc, int ctas_per_core,
                                  long long rows_per_cta, int f_dim,
                                  int n_leaves, int n_cls, int win_words,
                                  int rows_per_pass, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const float*>(x);
  const auto* yp = static_cast<const int32_t*>(y);
  const auto* lp = static_cast<const int32_t*>(leaf);
  const auto* tp = static_cast<const float*>(th);
  auto* cp = static_cast<int32_t*>(counts);
  auto* op = static_cast<int32_t*>(totals);
  if (f_dim == 16 && vec)
    return launch<16, true>(xp, yp, lp, tp, cp, op, n_cores, n_pc,
                            ctas_per_core, rows_per_cta, f_dim, n_leaves,
                            n_cls, win_words, rows_per_pass, s);
  if (f_dim == 16)
    return launch<16, false>(xp, yp, lp, tp, cp, op, n_cores, n_pc,
                             ctas_per_core, rows_per_cta, f_dim, n_leaves,
                             n_cls, win_words, rows_per_pass, s);
  return launch<0, false>(xp, yp, lp, tp, cp, op, n_cores, n_pc,
                          ctas_per_core, rows_per_cta, f_dim, n_leaves,
                          n_cls, win_words, rows_per_pass, s);
}
