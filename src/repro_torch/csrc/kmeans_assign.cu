// kmeans_assign: K-Means assign-and-accumulate over int16 points, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/kmeans_assign/kernel.py:51
// (kmeans_assign, pallas_call at :61).  Per simulated core c and row r:
//   label[c,r] = first argmin_k (||C_k||^2 - 2 x[c,r].C_k)   (int32, wrapping)
//   sums[c,k,:] += x[c,r,:]  and  counts[c,k] += 1  for k = label[c,r]
// bit-identical to repro/kernels/kmeans_assign/ref.py and to the plain
// version in repro_torch/kernels/kmeans_assign.py.  Every row counts (pad
// rows included): the trainer corrects for its pad rows itself.
//
// Input: x int16 [C, n_pc, F] (the cores' resident shards, one launch for all
// cores), centroids int16 [K, F] (the broadcast model).  Outputs: labels
// int32 [C, n_pc], per-core partial sums int32 [C, K, F] and counts int32
// [C, K], which map_reduce reduces over the cores.
//
// Bound on the H100: bytes.  A row is 2F bytes in and 4 bytes out.  On the
// CUDA cores (the first port) the K*F multiply-adds of a row were the bound
// (256 per 36 bytes at K = F = 16, over the card's int32 ridge); this
// kernel does them on the tensor cores, as the TPU kernel does on its
// matrix unit (kernel.py:37-48), so only the bytes are left.
//
// Design.
//  - Byte split.  The tensor cores multiply 8-bit integers, not 16-bit
//    ones.  Write x = 256 xh + xl with xh = x >> 8 (s8) and xl = x & 0xff
//    (u8), and the centroids likewise; then
//      x.c = 65536 xh.ch + 256 (xh.cl + xl.ch) + xl.cl   (mod 2^32).
//    Each product is one mma.sync.m16n8k16 with s32 accumulators (the
//    s8/u8 combinations all exist); the two middle ones share one.  Over a
//    depth of D features an accumulator's sum is at most D * 65,280 in
//    magnitude (128 * 255 twice), exact in int32 for D <= 32,896 (the
//    plan's MAX_EXACT_DEPTH; shared memory caps F far below it), so
//    composing them in uint32_t gives the reference's int32 wrap bit for
//    bit without relying on how the MMA overflows.
//  - mma.sync, not wgmma: a warp's tile is 16 rows x 8 clusters x 16
//    features (k16: F = 16 needs no zero padding), and after the split the
//    work is ~52 G int8 operations a launch, ~0.03 ms at the int8 rate:
//    nothing to gain from warpgroup tiles, which need 64 rows and a
//    shared-memory ring per warpgroup.
//  - Argmin per row on the CUDA cores: each thread scans its clusters
//    upward with a strict `<`, then the four threads of a row's group
//    combine, the lower index winning a tie: the first minimum, as
//    jnp.argmin.  Padded clusters (K rounded up to 16) never compete.
//  - Sums as the TPU kernel's one-hot product (kernel.py:45-48): onehot^T
//    (clusters x 16 rows, u8) times xh (s8) and xl (u8), accumulated in
//    registers over the warp's rows and folded into uint32 every 131,072
//    rows (so no int32 accumulator can overflow).  The same 16x16 tile of
//    x feeds both products: ldmatrix reads it as rows for the distances
//    and transposed (.trans) for the sums.  Counts are the popcount of the
//    one-hot operand's bytes.
//  - Streaming: a warp owns a ring of 32-row chunks in shared memory filled
//    by 16-byte cp.async, 8 chunks deep at K, F <= 16 (rows of 32 bytes,
//    their two 16-byte pieces swapped in every other group of 4 rows so
//    that ldmatrix reads without bank conflicts); wider shapes pad a row
//    to an odd number of 16-byte pieces instead, 2 chunks deep.  (In
//    trials on an H100, 4 chunks of padded rows left the copies alone well
//    short of the byte bound.)  Rows that are not 16-byte aligned
//    (F % 8 != 0 or an offset view) are copied with 2-byte loads.
//  - Writing the partial: the block's warps add into shared memory, then
//    the block writes its core's [K, F] and [K] once: plain stores where one
//    block owns a core (the caller allocates them empty), one atomic per
//    entry where the plan splits a core over blocks (few cores: zeroed).
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kChunk = 32;                 // rows a warp takes at a time
constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kNoLabel = 0xffffu;     // rows past the end of the range
constexpr int kFoldChunks = 4096;          // 131,072 rows: 255 * that < 2^31
constexpr int kFixedStages = 8;            // ring depth, K and F <= 16
constexpr int kWideStages = 2;             // ring depth otherwise

// Byte offset of row r's 16-byte piece c in a ring stage.  K, F <= 16: rows
// of 32 bytes, the two pieces swapped in rows 4-7 of every 8 (ldmatrix reads
// 8 rows of one piece: without the swap rows r and r + 4 share banks).
// Wider: rows of f_pad + 8 int16, an odd number of pieces.
template <bool kFixed>
__device__ __forceinline__ int piece_off(int r, int c, int rs) {
  if constexpr (kFixed) return r * 32 + ((c ^ ((r >> 2) & 1)) << 4);
  return r * rs * 2 + c * 16;
}

// Rows of a chunk that lie before the end of the block's range.
__device__ __forceinline__ int rows_left(long long left) {
  return left < kChunk ? static_cast<int>(left) : kChunk;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr,
                                              uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// d += a (16x16, row-major) * b (16x8, column-major); 8-bit operands whose
// signedness the name gives (A then B), s32 accumulators.
#define KMEANS_MMA(NAME, AT, BT)                                             \
  __device__ __forceinline__ void NAME(uint32_t (&d)[4], uint32_t a0,        \
                                       uint32_t a1, uint32_t b) {            \
    asm volatile("mma.sync.aligned.m16n8k16.row.col.s32." AT "." BT          \
                 ".s32 {%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"       \
                 : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])            \
                 : "r"(a0), "r"(a1), "r"(b));                                \
  }
KMEANS_MMA(mma_ss, "s8", "s8")
KMEANS_MMA(mma_su, "s8", "u8")
KMEANS_MMA(mma_us, "u8", "s8")
KMEANS_MMA(mma_uu, "u8", "u8")
#undef KMEANS_MMA

// High and low bytes of four int16 held two to a word: (lo16 of a, hi16 of
// a, lo16 of b, hi16 of b).
__device__ __forceinline__ uint32_t hi_bytes(uint32_t a, uint32_t b) {
  return __byte_perm(a, b, 0x7531);
}
__device__ __forceinline__ uint32_t lo_bytes(uint32_t a, uint32_t b) {
  return __byte_perm(a, b, 0x6420);
}

// One-hot bytes of four rows' labels against cluster `cl`.
__device__ __forceinline__ uint32_t onehot(const uint32_t (&lab)[4],
                                           uint32_t cl) {
  return static_cast<uint32_t>(lab[0] == cl) |
         (static_cast<uint32_t>(lab[1] == cl) << 8) |
         (static_cast<uint32_t>(lab[2] == cl) << 16) |
         (static_cast<uint32_t>(lab[3] == cl) << 24);
}

// One-hot bytes of four labels held as bytes (K <= 16) against cluster
// `cl`: the zero bytes of their XOR, found without carries between bytes.
__device__ __forceinline__ uint32_t onehot_bytes(uint32_t lab4, uint32_t cl) {
  const uint32_t v = lab4 ^ (cl * 0x01010101u);
  return ~(((v & 0x7f7f7f7fu) + 0x7f7f7f7fu) | v | 0x7f7f7f7fu) >> 7;
}

// x.c of a C-fragment entry from the byte-split products (the two middle
// ones accumulate into one).
__device__ __forceinline__ uint32_t compose(uint32_t hh, uint32_t mid,
                                            uint32_t ll) {
  return (hh << 16) + (mid << 8) + ll;
}

// The group of four threads that share a row combines: the smaller
// distance wins, the lower cluster on a tie (threads that saw no cluster
// hold INT_MAX and kNoLabel, which loses every tie).
__device__ __forceinline__ void group_min(int32_t& best, uint32_t& bk) {
#pragma unroll
  for (int m = 1; m <= 2; m <<= 1) {
    const int32_t ob = __shfl_xor_sync(kFull, best, m);
    const uint32_t ok = __shfl_xor_sync(kFull, bk, m);
    const bool take = ob < best || (ob == best && ok < bk);
    best = take ? ob : best;
    bk = take ? ok : bk;
  }
}

// kFixed: K <= 16 and F <= 16 (one cluster tile, one feature step), with the
// centroid fragments, the norms and the sums in registers; otherwise any
// padded K and F, with the sums added to shared memory per chunk.
template <bool kFixed, bool kAsync>
__global__ void __launch_bounds__(kThreads, 3)
kmeans_assign_kernel(const int16_t* __restrict__ x,
                     const int16_t* __restrict__ cents,
                     int32_t* __restrict__ labels, int32_t* __restrict__ sums,
                     int32_t* __restrict__ counts, long long n_pc, int f_dim,
                     int k, int k_pad, int f_pad, long long rows_per_cta,
                     int atomic_out) {
  constexpr int kStages = kFixed ? kFixedStages : kWideStages;
  extern __shared__ __align__(16) uint32_t smem[];
  // n-tiles of clusters, feature steps, m-tiles of clusters
  const int nt_n = kFixed ? 2 : k_pad / 8, ks_n = kFixed ? 1 : f_pad / 16;
  const int mc_n = kFixed ? 1 : k_pad / 16;
  const int rs = kFixed ? 16 : f_pad + 8;            // ring row, in int16
  uint32_t* frag = smem;                             // [nt][ks][h,l][lane]
  uint32_t* cnorm = frag + nt_n * ks_n * 64;         // [k_pad]
  uint32_t* red = cnorm + k_pad;                     // [k_pad][f_pad]
  uint32_t* red_cnt = red + k_pad * f_pad;           // [k_pad]
  int16_t* ring = reinterpret_cast<int16_t*>(red_cnt + k_pad);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;

  // -- centroid fragments (byte-split, in the K-column order below), norms
  // A thread's four K-columns 4t..4t+3 of a 16-feature step are features
  // {2t, 2t+1, 8+2t, 9+2t}: the order ldmatrix hands a row's values out.
  for (int i = tid; i < nt_n * ks_n * 64; i += kThreads) {
    const int ln = i & 31, hl = (i >> 5) & 1, step = i >> 6;
    const int ks = step % ks_n, nt = step / ks_n;
    const int kk = nt * 8 + (ln >> 2), tt = ln & 3;
    uint32_t word = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int f = ks * 16 + (b < 2 ? 2 * tt + b : 8 + 2 * tt + b - 2);
      const int v = (kk < k && f < f_dim) ? cents[kk * f_dim + f] : 0;
      const uint32_t byte = hl == 0 ? ((v >> 8) & 0xff) : (v & 0xff);
      word |= byte << (8 * b);
    }
    frag[i] = word;
  }
  for (int kk = tid; kk < k_pad; kk += kThreads) {
    uint32_t acc = 0;
    for (int f = 0; kk < k && f < f_dim; ++f) {
      const uint32_t v = static_cast<uint32_t>(
          static_cast<int32_t>(cents[kk * f_dim + f]));
      acc += v * v;
    }
    cnorm[kk] = acc;
  }
  for (int i = tid; i < k_pad * f_pad + k_pad; i += kThreads) red[i] = 0;
  __syncthreads();

  const long long core = blockIdx.y;
  const long long row0 = static_cast<long long>(blockIdx.x) * rows_per_cta;
  long long row1 = row0 + rows_per_cta;
  if (row1 > n_pc) row1 = n_pc;
  const int n_chunks = static_cast<int>((row1 - row0 + kChunk - 1) / kChunk);
  const int16_t* xc = x + core * n_pc * f_dim;
  int32_t* lc = labels + core * n_pc;
  int16_t* my_ring = ring + warp * kStages * kChunk * rs;
  const int parts = f_dim / 8;                       // 16-byte pieces a row
  const uint32_t ring_u32 = smem_u32(my_ring);
  // K, F <= 16 with 16-byte copies: F is 8 or 16, one or two pieces a row;
  // this lane copies row pr's piece pp, and with two pieces row pr + 16's
  const int pr = parts == 2 ? lane >> 1 : lane, pp = parts == 2 ? lane & 1 : 0;
  const int soff0 = piece_off<kFixed>(pr, pp, rs);
  const int soff1 = piece_off<kFixed>(pr + 16, pp, rs);

  auto fill = [&](int q) {                           // the warp's chunk q
    const int ch = warp + q * kWarps;
    if (ch >= n_chunks) return;
    const long long r0 = row0 + static_cast<long long>(ch) * kChunk;
    const int valid = rows_left(row1 - r0);
    const int st = (q % kStages) * kChunk * rs * 2;  // stage, in bytes
    if constexpr (kFixed && kAsync) {
      const int16_t* src = xc + (r0 + pr) * f_dim + pp * 8;
      if (pr < valid) cp_async16(ring_u32 + st + soff0, src);
      if (parts == 2 && pr + 16 < valid)
        cp_async16(ring_u32 + st + soff1, src + 16 * f_dim);
    } else if constexpr (kAsync) {
      for (int i = lane; i < valid * parts; i += 32) {
        const int r = i / parts, p = i - r * parts;
        cp_async16(ring_u32 + st + piece_off<kFixed>(r, p, rs),
                   xc + (r0 + r) * f_dim + p * 8);
      }
    } else {
      char* base = reinterpret_cast<char*>(my_ring) + st;
      for (int i = lane; i < valid * f_dim; i += 32) {
        const int r = i / f_dim, f = i - r * f_dim;
        *reinterpret_cast<int16_t*>(base + piece_off<kFixed>(r, f >> 3, rs) +
                                    (f & 7) * 2) = xc[(r0 + r) * f_dim + f];
      }
    }
  };

  uint32_t bh[kFixed ? 2 : 1], bl[kFixed ? 2 : 1], cn[kFixed ? 4 : 1];
  if constexpr (kFixed) {
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      bh[nt] = frag[(nt * 2) * 32 + lane];
      bl[nt] = frag[(nt * 2 + 1) * 32 + lane];
      cn[nt * 2] = cnorm[nt * 8 + 2 * t];
      cn[nt * 2 + 1] = cnorm[nt * 8 + 2 * t + 1];
    }
  }
  uint32_t s_h[kFixed ? 2 : 1][4] = {}, s_l[kFixed ? 2 : 1][4] = {};
  uint32_t cnt0 = 0, cnt1 = 0;
  // the register sums into the block's, which are uint32 and wrap
  auto fold = [&]() {
    if constexpr (kFixed) {
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const uint32_t v = (s_h[n][i] << 8) + s_l[n][i];
          const int cl = g + (i >> 1) * 8, f = n * 8 + 2 * t + (i & 1);
          if (v) atomicAdd(&red[cl * f_pad + f], v);
          s_h[n][i] = s_l[n][i] = 0;
        }
    }
  };

  if constexpr (kAsync) {
#pragma unroll
    for (int q = 0; q < kStages - 1; ++q) {
      fill(q);
      cp_async_commit();
    }
  }
  for (int q = 0; warp + q * kWarps < n_chunks; ++q) {
    if constexpr (kAsync) {
      fill(q + kStages - 1);
      cp_async_commit();
      cp_async_wait<kStages - 1>();
    } else {
      fill(q);
    }
    __syncwarp();
    const long long r0 =
        row0 + static_cast<long long>(warp + q * kWarps) * kChunk;
    const int valid = rows_left(row1 - r0);
    const uint32_t st = ring_u32 + (q % kStages) * kChunk * rs * 2;
    // lane l addresses row (l & 7) + 8 ((l >> 4) & 1), piece (l >> 3) & 1 of
    // a 16x16 tile: matrices (rows 0-7 | 8-15) x (features 0-7 | 8-15) in
    // the order r0: rows 0-7 f 0-7, r1: rows 0-7 f 8-15, r2: rows 8-15 f
    // 0-7, r3: rows 8-15 f 8-15
    const int lrow = (lane & 7) + ((lane >> 4) & 1) * 8;
    const int lpiece = (lane >> 3) & 1;

    uint32_t packed[2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      // this lane's ldmatrix address in the m-tile, feature step ks
      auto tile = [&](int ks) {
        return st + piece_off<kFixed>(mt * 16 + lrow, ks * 2 + lpiece, rs);
      };
      // -- distances: rows g and g + 8 of the m-tile, clusters 2t, 2t + 1
      // of each n-tile
      // A thread's clusters rise through its scan, so a strict `<` keeps
      // the first minimum; its first cluster is its smallest, so if that one
      // is padding, so are the rest (they keep INT_MAX and kNoLabel).
      int32_t best0 = INT_MAX, best1 = INT_MAX;
      uint32_t bk0 = kNoLabel, bk1 = kNoLabel;
      auto scan = [&](const uint32_t (&acc)[3][4], int nt, uint32_t cn0,
                      uint32_t cn1) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const uint32_t col = nt * 8 + 2 * t + (i & 1);
          const uint32_t cross = compose(acc[0][i], acc[1][i], acc[2][i]);
          const int32_t d =
              static_cast<int32_t>(((i & 1) ? cn1 : cn0) - 2u * cross);
          int32_t& best = i < 2 ? best0 : best1;
          uint32_t& bk = i < 2 ? bk0 : bk1;
          const bool take = col < static_cast<uint32_t>(k) &&
                            ((nt == 0 && (i & 1) == 0) || d < best);
          best = take ? d : best;
          bk = take ? col : bk;
        }
      };
      if constexpr (kFixed) {
        uint32_t a[4];
        ldsm_x4(tile(0), a);
        const uint32_t ah0 = hi_bytes(a[0], a[1]), ah1 = hi_bytes(a[2], a[3]);
        const uint32_t al0 = lo_bytes(a[0], a[1]), al1 = lo_bytes(a[2], a[3]);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          uint32_t acc[3][4] = {};
          mma_ss(acc[0], ah0, ah1, bh[nt]);
          mma_su(acc[1], ah0, ah1, bl[nt]);
          mma_us(acc[1], al0, al1, bh[nt]);
          mma_uu(acc[2], al0, al1, bl[nt]);
          scan(acc, nt, cn[nt * 2], cn[nt * 2 + 1]);
        }
      } else {
        for (int nt = 0; nt < nt_n; ++nt) {
          uint32_t acc[3][4] = {};
          for (int ks = 0; ks < ks_n; ++ks) {
            uint32_t a[4];
            ldsm_x4(tile(ks), a);
            const uint32_t ah0 = hi_bytes(a[0], a[1]),
                           ah1 = hi_bytes(a[2], a[3]);
            const uint32_t al0 = lo_bytes(a[0], a[1]),
                           al1 = lo_bytes(a[2], a[3]);
            const uint32_t* fr = frag + ((nt * ks_n + ks) * 2) * 32 + lane;
            mma_ss(acc[0], ah0, ah1, fr[0]);
            mma_su(acc[1], ah0, ah1, fr[32]);
            mma_us(acc[1], al0, al1, fr[0]);
            mma_uu(acc[2], al0, al1, fr[32]);
          }
          scan(acc, nt, cnorm[nt * 8 + 2 * t], cnorm[nt * 8 + 2 * t + 1]);
        }
      }
      group_min(best0, bk0);
      group_min(best1, bk1);
      if (mt * 16 + g >= valid) bk0 = kNoLabel;
      if (mt * 16 + g + 8 >= valid) bk1 = kNoLabel;
      packed[mt] = bk0 | (bk1 << 16);

      // -- sums: onehot^T (clusters x 16 rows) . x (16 rows x 8 features);
      // a thread's K-rows 4t..4t+3 are rows {2t, 2t+1, 8+2t, 9+2t}, the
      // order ldmatrix.trans hands a feature's values out
      const uint32_t u0 = __shfl_sync(kFull, packed[mt], 8 * t);
      const uint32_t u1 = __shfl_sync(kFull, packed[mt], 8 * t + 4);
      const uint32_t lab[4] = {u0 & 0xffffu, u1 & 0xffffu, u0 >> 16,
                               u1 >> 16};
      const uint32_t lab4 = __byte_perm(u0, u1, 0x6240);   // as bytes
      for (int ks = 0; ks < ks_n; ++ks) {
        uint32_t m[4];
        ldsm_x4_trans(tile(ks), m);
        // n-tile 2ks: features ks*16 + g; n-tile 2ks + 1: ks*16 + 8 + g
        const uint32_t xh[2] = {hi_bytes(m[0], m[2]), hi_bytes(m[1], m[3])};
        const uint32_t xl[2] = {lo_bytes(m[0], m[2]), lo_bytes(m[1], m[3])};
        for (int mc = 0; mc < (kFixed ? 1 : mc_n); ++mc) {
          const uint32_t a0 = kFixed ? onehot_bytes(lab4, g)
                                     : onehot(lab, mc * 16 + g);
          const uint32_t a1 = kFixed ? onehot_bytes(lab4, g + 8)
                                     : onehot(lab, mc * 16 + g + 8);
          if constexpr (kFixed) {
#pragma unroll
            for (int n = 0; n < 2; ++n) {
              mma_us(s_h[n], a0, a1, xh[n]);
              mma_uu(s_l[n], a0, a1, xl[n]);
            }
            cnt0 += __popc(a0);
            cnt1 += __popc(a1);
          } else {
#pragma unroll
            for (int n = 0; n < 2; ++n) {
              uint32_t h[4] = {}, l[4] = {};
              mma_us(h, a0, a1, xh[n]);
              mma_uu(l, a0, a1, xl[n]);
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                const int cl = mc * 16 + g + (i >> 1) * 8;
                const int f = ks * 16 + n * 8 + 2 * t + (i & 1);
                const uint32_t v = (h[i] << 8) + l[i];
                if (v) atomicAdd(&red[cl * f_pad + f], v);
              }
            }
            if (ks == 0) {
              uint32_t c0 = __popc(a0), c1 = __popc(a1);
              c0 += __shfl_xor_sync(kFull, c0, 1);
              c0 += __shfl_xor_sync(kFull, c0, 2);
              c1 += __shfl_xor_sync(kFull, c1, 1);
              c1 += __shfl_xor_sync(kFull, c1, 2);
              if (t == 0) {
                if (c0) atomicAdd(&red_cnt[mc * 16 + g], c0);
                if (c1) atomicAdd(&red_cnt[mc * 16 + g + 8], c1);
              }
            }
          }
        }
      }
    }

    // -- labels: lane l stores row l of the chunk
    {
      const uint32_t v0 = __shfl_sync(kFull, packed[0], 4 * (lane & 7));
      const uint32_t v1 = __shfl_sync(kFull, packed[1], 4 * (lane & 7));
      const int q4 = lane >> 3;
      const uint32_t v = q4 < 2 ? v0 : v1;
      const uint32_t lbl = (q4 & 1) ? v >> 16 : v & 0xffffu;
      if (lbl != kNoLabel) lc[r0 + lane] = static_cast<int32_t>(lbl);
    }
    if ((q + 1) % kFoldChunks == 0) fold();
    __syncwarp();        // the stage is refilled only after every lane read
  }
  if constexpr (kAsync) cp_async_wait<0>();

  // -- the warp's partial into shared memory, then the block's into the
  // core's
  fold();
  if constexpr (kFixed) {
    cnt0 += __shfl_xor_sync(kFull, cnt0, 1);
    cnt0 += __shfl_xor_sync(kFull, cnt0, 2);
    cnt1 += __shfl_xor_sync(kFull, cnt1, 1);
    cnt1 += __shfl_xor_sync(kFull, cnt1, 2);
    if (t == 0) {
      if (cnt0) atomicAdd(&red_cnt[g], cnt0);
      if (cnt1) atomicAdd(&red_cnt[g + 8], cnt1);
    }
  }
  __syncthreads();
  int32_t* sc = sums + core * k * f_dim;
  int32_t* cc = counts + core * k;
  for (int i = tid; i < k * f_dim; i += kThreads) {
    const int kk = i / f_dim, f = i - kk * f_dim;
    const int32_t v = static_cast<int32_t>(red[kk * f_pad + f]);
    if (atomic_out) {
      if (v) atomicAdd(&sc[i], v);
    } else {
      sc[i] = v;
    }
  }
  for (int i = tid; i < k; i += kThreads) {
    const int32_t v = static_cast<int32_t>(red_cnt[i]);
    if (atomic_out) {
      if (v) atomicAdd(&cc[i], v);
    } else {
      cc[i] = v;
    }
  }
}

template <bool kFixed, bool kAsync>
int launch(const int16_t* x, const int16_t* cents, int32_t* labels,
           int32_t* sums, int32_t* counts, int n_cores, int ctas_per_core,
           long long n_pc, int f_dim, int k, int k_pad, int f_pad,
           long long rows_per_cta, int atomic_out, int smem,
           cudaStream_t s) {
  auto* fn = kmeans_assign_kernel<kFixed, kAsync>;
  static int opted_in = 48 * 1024;   // per instantiation
  if (smem > opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = smem;
  }
  const dim3 grid(static_cast<unsigned>(ctas_per_core),
                  static_cast<unsigned>(n_cores));
  fn<<<grid, kThreads, smem, s>>>(x, cents, labels, sums, counts, n_pc, f_dim,
                                  k, k_pad, f_pad, rows_per_cta, atomic_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry point bound with ctypes.  Launches on `stream`; returns the CUDA
// error (0 = launched).  The caller checks types, shapes, contiguity and
// 1 <= C <= 65535, and passes the plan of
// repro_torch/kernels/kmeans_assign.py::kmeans_assign_plan: K and F padded
// to 16, `fixed` (K and F at most 16), the blocks per core and their rows
// (a multiple of 32), and the shared memory the layout above takes.  With
// one block per core it allocates sums and counts empty (every entry is
// stored); with more, zeroed (atomic_out = 1).  vec = 1 asks for 16-byte
// copies (F % 8 == 0 and x 16-byte aligned).
extern "C" int kmeans_assign_launch(const void* x, const void* cents,
                                    void* labels, void* sums, void* counts,
                                    int n_cores, int ctas_per_core,
                                    long long n_pc, int f_dim, int k,
                                    int k_pad, int f_pad, int fixed,
                                    long long rows_per_cta, int smem, int vec,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const int16_t*>(x);
  const auto* cp = static_cast<const int16_t*>(cents);
  auto* lp = static_cast<int32_t*>(labels);
  auto* sp = static_cast<int32_t*>(sums);
  auto* np = static_cast<int32_t*>(counts);
  const int atomic_out = ctas_per_core > 1;
  if (fixed && vec)
    return launch<true, true>(xp, cp, lp, sp, np, n_cores, ctas_per_core,
                              n_pc, f_dim, k, k_pad, f_pad, rows_per_cta,
                              atomic_out, smem, s);
  if (fixed)
    return launch<true, false>(xp, cp, lp, sp, np, n_cores, ctas_per_core,
                               n_pc, f_dim, k, k_pad, f_pad, rows_per_cta,
                               atomic_out, smem, s);
  if (vec)
    return launch<false, true>(xp, cp, lp, sp, np, n_cores, ctas_per_core,
                               n_pc, f_dim, k, k_pad, f_pad, rows_per_cta,
                               atomic_out, smem, s);
  return launch<false, false>(xp, cp, lp, sp, np, n_cores, ctas_per_core,
                              n_pc, f_dim, k, k_pad, f_pad, rows_per_cta,
                              atomic_out, smem, s);
}
