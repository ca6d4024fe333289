// int_matmul: int8 x int8 -> int32 matrix product, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/quant_matmul/kernel.py:43
// (int_matmul, pallas_call at :56).
//   c[m,n] = sum_k a[m,k] * b[k,n]    (a int8 [M,K], b int8 [K,N], row-major)
// accumulated in int32: exact, since |c| <= K * 128^2 < 2^31 for
// K <= 131,072 (the wrapper checks), so the order of the sum does not
// matter.  Equal to repro/kernels/quant_matmul/ref.py::int_matmul_ref and to
// the plain version in repro_torch/kernels/quant_matmul.py.  M, N and K need
// not be multiples of the tile: the kernels mask their ragged edges (the TPU
// kernel asserts divisibility).  The wrapper plans each launch (path, split
// count, k per split: kernels/quant_matmul.py::int_matmul_plan).
//
// Bound on the H100: at prefill (M = prompt length) the 2*M*K*N operations
// against the int8 tensor cores at 1,979 TOP/s; at decode (M = 1) the K*N
// bytes of b against 3.35 TB/s.  Two designs, by M:
//
// (a) M > 16, int_matmul_tc: the int8 tensor cores.  A CTA computes a
// 128 x 128 tile of c with three warpgroups.  The third, the producer, has
// its first thread keep TMA loads of a's [128 m x 128 k] and b's
// [128 k x 128 n] tiles two k steps ahead in a ring of four stages, each
// completing on an mbarrier.  wgmma reads int8 operands only K-major, and
// b is [K, N] row-major (N-major; its layout is the op's contract), so the
// producer's 128 threads then transpose each staged b tile in shared memory
// into the K-major 128-byte-swizzled layout wgmma's descriptor names: each
// thread reads 8 rows of 16 bytes, transposes 4 x 4 byte blocks with
// __byte_perm and writes 16 rows of 8 bytes, with a lane map that keeps both
// the reads and the writes free of bank conflicts.  The two consumer
// warpgroups (64 rows of the tile each) wait for the transposed tile, issue
// four wgmma.m64n128k32.s32.s8.s8 per k step from the a and b tiles, and
// release the stage.  TMA zero-fills out-of-range rows and columns, so
// ragged M, N and K add zeros; the epilogue masks the stores.  TMA needs
// 16-byte aligned rows: the wrapper hands this path K and the row pitch
// of b as multiples of 16 (a zero-padded copy otherwise).  When the tiles
// cannot fill the card, K is split over blockIdx.z and the partial sums
// are added with integer atomics into c, zeroed first: exact in any order.
//
// (b) M <= 16, int_matmul_stream: a streaming pass over b for decode.  A
// block of 256 threads owns 256 columns and a slice of K; each thread
// reads b as 16-byte vectors (16 columns of 4 rows at a time, several k
// passes' loads in flight: 2 passes and 3 blocks per SM for one row of a,
// 4 passes for up to 4 rows), transposes them into packed 4-k words with
// __byte_perm and multiplies them with __dp4a against a's words, staged
// once per block in shared memory, for MT = 1 or 4 rows of a per block: no
// work on rows that do not exist.  K is split so that ~4 blocks per SM are
// in flight, the 16 k groups of a block are summed through shuffles and
// shared memory, and the slices meet in c through integer atomics.  The
// vector loads need N % 16 == 0 and a 16-byte aligned b; otherwise the
// block loads bytes.
//
// ptxas -v (sm_90a, nvcc 12.9), no spills anywhere: int_matmul_tc 108
// registers, 197,728 bytes of dynamic shared memory (a, staged b and b^T
// rings); int_matmul_stream 64 registers and 8 KB (MT = 1), 160-169
// registers and 32 KB (MT = 4).
#include "sm90.cuh"

namespace {

using namespace sm90;

// ---- (a) tensor cores -------------------------------------------------------

constexpr int kTcBM = 128;             // rows of c per CTA
constexpr int kTcBN = 128;             // columns of c per CTA
constexpr int kTcBK = 128;             // k per step (bytes): one swizzle row
constexpr int kTcStages = 4;
constexpr int kTcPrefetch = 2;         // k steps TMA runs ahead
constexpr int kTcTile = kTcBM * kTcBK; // 16 KB: an a, staged-b or b^T tile
constexpr int kTcThreads = 384;        // 2 consumer warpgroups + producer
constexpr int kTcSmem = 3 * kTcStages * kTcTile + 3 * kTcStages * 8 + 1024;

// four words, each 4 bytes of one row, to four words, each one byte of the
// four rows: out[j] = bytes j of in[0..3]
__device__ __forceinline__ void transpose4(uint32_t r0, uint32_t r1,
                                           uint32_t r2, uint32_t r3,
                                           uint32_t& c0, uint32_t& c1,
                                           uint32_t& c2, uint32_t& c3) {
  const uint32_t t0 = __byte_perm(r0, r1, 0x5140);
  const uint32_t t1 = __byte_perm(r2, r3, 0x5140);
  const uint32_t t2 = __byte_perm(r0, r1, 0x7362);
  const uint32_t t3 = __byte_perm(r2, r3, 0x7362);
  c0 = __byte_perm(t0, t1, 0x5410);
  c1 = __byte_perm(t0, t1, 0x7632);
  c2 = __byte_perm(t2, t3, 0x5410);
  c3 = __byte_perm(t2, t3, 0x7632);
}

// The staged b tile (TMA, 128-byte swizzle) holds b[k, n] at
//   k * 128 + (((n >> 4) ^ (k & 7)) << 4) + (n & 15);
// the transposed tile (wgmma's K-major 128-byte swizzle) b[k, n] at
//   n * 128 + (((k >> 4) ^ (n & 7)) << 4) + (k & 15).
// This thread moves k = 8 kb .. 8 kb + 7 of n = 16 nb .. 16 nb + 15.
__device__ __forceinline__ void transpose_tile(const uint8_t* src,
                                               uint8_t* dst, int kb, int nb) {
  uint32_t in[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i) {  // row k = 8 kb + i, so k & 7 == i
    const uint4 v = *reinterpret_cast<const uint4*>(
        src + (8 * kb + i) * 128 + ((nb ^ i) << 4));
    in[i][0] = v.x;
    in[i][1] = v.y;
    in[i][2] = v.z;
    in[i][3] = v.w;
  }
  uint32_t out[16][2];  // [n - 16 nb][k quad]
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int q = 0; q < 2; ++q)
      transpose4(in[4 * q][j], in[4 * q + 1][j], in[4 * q + 2][j],
                 in[4 * q + 3][j], out[4 * j][q], out[4 * j + 1][q],
                 out[4 * j + 2][q], out[4 * j + 3][q]);
#pragma unroll
  for (int c = 0; c < 16; ++c) {  // row n = 16 nb + c, so n & 7 == c & 7
    *reinterpret_cast<uint2*>(dst + (16 * nb + c) * 128 +
                              (((kb >> 1) ^ (c & 7)) << 4) + ((kb & 1) << 3)) =
        make_uint2(out[c][0], out[c][1]);
  }
}

// TMA loads of a's and b's tiles at k0 into ring slot step % kTcStages
__device__ __forceinline__ void tc_issue(const CUtensorMap* ta,
                                         const CUtensorMap* tb, uint8_t* a_s,
                                         uint8_t* bs_s, uint64_t* full,
                                         int step, int k0, int m0, int n0) {
  const int s = step % kTcStages;
  mbar_expect_tx(&full[s], 2 * kTcTile);
  tma_load_2d(a_s + s * kTcTile, ta, &full[s], k0, m0);
  tma_load_2d(bs_s + s * kTcTile, tb, &full[s], n0, k0);
}

__global__ void __launch_bounds__(kTcThreads, 1)
    int_matmul_tc(const __grid_constant__ CUtensorMap ta,
                  const __grid_constant__ CUtensorMap tb,
                  int32_t* __restrict__ c, int M, int N, int ksteps,
                  int steps_per_split, int atomic) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* a_s = align1024(smem_raw);
  uint8_t* bs_s = a_s + kTcStages * kTcTile;  // b as TMA lands it
  uint8_t* bt_s = bs_s + kTcStages * kTcTile; // b transposed, K-major
  uint64_t* full = reinterpret_cast<uint64_t*>(bt_s + kTcStages * kTcTile);
  uint64_t* ready = full + kTcStages;
  uint64_t* empty = ready + kTcStages;

  const int tid = threadIdx.x, wg = tid >> 7;
  const int m0 = blockIdx.x * kTcBM, n0 = blockIdx.y * kTcBN;
  const int step0 = blockIdx.z * steps_per_split;
  const int nsteps = min(ksteps - step0, steps_per_split);

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kTcStages; ++s) {
      mbar_init(&full[s], 1);     // the TMA thread's arrival + the bytes
      mbar_init(&ready[s], 128);  // every producer thread after its stores
      mbar_init(&empty[s], 256);  // every consumer thread after its wgmma
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (wg == 2) {
    // producer: TMA loads, then the transpose of b's tile
    const int t = tid - 256, lane = t & 31, w = t >> 5;
    const int kb = lane & 15, nb = (2 * w + (lane >> 4)) ^ (kb & 7);
    if (t == 0)
      for (int step = 0; step < min(kTcPrefetch, nsteps); ++step)
        tc_issue(&ta, &tb, a_s, bs_s, full, step, (step0 + step) * kTcBK, m0,
                 n0);
    for (int step = 0; step < nsteps; ++step) {
      const int s = step % kTcStages;
      const int next = step + kTcPrefetch;
      if (t == 0 && next < nsteps) {
        // stage next % S was last read in step next - S: wait for that
        if (next >= kTcStages)
          mbar_wait(&empty[next % kTcStages], (next / kTcStages - 1) & 1);
        tc_issue(&ta, &tb, a_s, bs_s, full, next, (step0 + next) * kTcBK,
                 m0, n0);
      }
      mbar_wait(&full[s], (step / kTcStages) & 1);
      transpose_tile(bs_s + s * kTcTile, bt_s + s * kTcTile, kb, nb);
      fence_proxy_async();
      mbar_arrive(&ready[s]);
    }
    return;
  }

  // consumers: warpgroup wg owns rows 64 wg .. 64 wg + 63 of the tile
  int32_t acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0;
  for (int step = 0; step < nsteps; ++step) {
    const int s = step % kTcStages;
    mbar_wait(&ready[s], (step / kTcStages) & 1);
    const uint8_t* a_t = a_s + s * kTcTile + wg * 64 * kTcBK;
    const uint8_t* b_t = bt_s + s * kTcTile;
    fence_operand(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTcBK / 32; ++kk)
      wgmma_m64n128k32_s8_ss(acc, sw128_desc(a_t + 32 * kk, 16, 1024),
                             sw128_desc(b_t + 32 * kk, 16, 1024), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operand(acc);
    mbar_arrive(&empty[s]);
  }

  const int lane = tid & 31, warp = (tid >> 5) & 3;
  const int row0 = m0 + 64 * wg + 16 * warp + (lane >> 2);
#pragma unroll
  for (int j = 0; j < kTcBN / 8; ++j) {
    const int col = n0 + 8 * j + 2 * (lane & 3);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      if (row >= M) continue;
      int32_t* dst = c + static_cast<long long>(row) * N + col;
      const int32_t v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
      if (atomic) {
        if (col < N) atomicAdd(dst, v0);
        if (col + 1 < N) atomicAdd(dst + 1, v1);
      } else if (col + 1 < N && (N & 1) == 0) {
        *reinterpret_cast<int2*>(dst) = make_int2(v0, v1);
      } else {
        if (col < N) dst[0] = v0;
        if (col + 1 < N) dst[1] = v1;
      }
    }
  }
}

// ---- (b) streaming, M <= 16 ------------------------------------------------

constexpr int kStThreads = 256;
constexpr int kStCols = 256;        // columns of c per block, 16 a thread
constexpr int kStKStep = 64;        // k per block pass: 16 groups of 4
// passes whose loads are in flight, and blocks per SM: one row of a keeps
// registers for 3 blocks of 2 passes; 4 rows need theirs for 64 sums
template <int MT>
constexpr int kStUnroll = MT == 1 ? 2 : 4;
template <int MT>
constexpr int kStMinBlocks = MT == 1 ? 3 : 1;
constexpr int kStMaxKSplit = 4096;  // the planner's largest k per split

__device__ __forceinline__ uint32_t word(const uint4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// 16 bytes b[k, n .. n + 15], zero past the edges
template <bool kVec>
__device__ __forceinline__ uint4 load_b16(const int8_t* __restrict__ b, int k,
                                          int n, int k_end, int N) {
  if (k >= k_end || n >= N) return make_uint4(0, 0, 0, 0);
  const int8_t* p = b + static_cast<long long>(k) * N + n;
  if constexpr (kVec) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  } else {
    uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
    for (int i = 0; i < 16; ++i)
      if (n + i < N)
        w[i >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(p[i]))
                     << (8 * (i & 3));
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
}

template <int MT, bool kVec>
__global__ void __launch_bounds__(kStThreads, kStMinBlocks<MT>)
    int_matmul_stream(const int8_t* __restrict__ a,
                      const int8_t* __restrict__ b, int32_t* __restrict__ c,
                      int M, int N, int K, int k_per_split, int atomic) {
  // a's words while the block streams b; then the warps' partial sums
  constexpr int kAWords = MT * kStMaxKSplit / 4;
  constexpr int kRed = (kStThreads / 32) * MT * kStCols;
  __shared__ __align__(16) int32_t smem[kAWords > kRed ? kAWords : kRed];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cg = tid & 15, kg = tid >> 4;
  const int n = blockIdx.x * kStCols + 16 * cg;
  const int k_begin = blockIdx.y * k_per_split;
  const int k_end = min(K, k_begin + k_per_split);
  const int m0 = blockIdx.z * MT;
  const int kw = (k_end - k_begin + 3) >> 2;  // words of a per row

  for (int u = tid; u < MT * kw; u += kStThreads) {
    const int m = u / kw, k = k_begin + 4 * (u % kw);
    uint32_t w = 0;
    if (m0 + m < M) {
      const int8_t* p = a + static_cast<long long>(m0 + m) * K + k;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (k + j < k_end)
          w |= static_cast<uint32_t>(static_cast<uint8_t>(p[j])) << (8 * j);
    }
    smem[m * kw + u % kw] = static_cast<int32_t>(w);
  }
  __syncthreads();

  int32_t acc[MT][16];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[m][j] = 0;

  constexpr int kUnroll = kStUnroll<MT>;
  for (int k0 = k_begin + 4 * kg; k0 < k_end; k0 += kStKStep * kUnroll) {
    uint4 rows[kUnroll][4];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        rows[u][r] = load_b16<kVec>(b, k0 + u * kStKStep + r, n, k_end, N);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int k = k0 + u * kStKStep;
      if (k >= k_end) break;
      int32_t aw[MT];
#pragma unroll
      for (int m = 0; m < MT; ++m) aw[m] = smem[m * kw + ((k - k_begin) >> 2)];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t col[4];
        transpose4(word(rows[u][0], j), word(rows[u][1], j),
                   word(rows[u][2], j), word(rows[u][3], j), col[0], col[1],
                   col[2], col[3]);
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[m][4 * j + e] =
                __dp4a(static_cast<int32_t>(col[e]), aw[m], acc[m][4 * j + e]);
      }
    }
  }

  // the two k groups of a warp, then the 8 warps through shared memory
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < 16; ++j)
      acc[m][j] += __shfl_xor_sync(0xffffffffu, acc[m][j], 16);
  __syncthreads();  // a's words are read
  if (lane < 16) {
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < 16; j += 4)
        *reinterpret_cast<int4*>(
            &smem[(warp * MT + m) * kStCols + 16 * cg + j]) =
            make_int4(acc[m][j], acc[m][j + 1], acc[m][j + 2], acc[m][j + 3]);
  }
  __syncthreads();
  for (int u = tid; u < MT * kStCols; u += kStThreads) {
    const int m = u / kStCols, col = blockIdx.x * kStCols + u % kStCols;
    if (m0 + m >= M || col >= N) continue;
    int32_t sum = 0;
#pragma unroll
    for (int w = 0; w < kStThreads / 32; ++w)
      sum += smem[(w * MT + m) * kStCols + u % kStCols];
    int32_t* dst = c + static_cast<long long>(m0 + m) * N + col;
    if (atomic)
      atomicAdd(dst, sum);
    else
      *dst = sum;
  }
}

template <int MT>
int launch_stream(const int8_t* a, const int8_t* b, int32_t* c, int M, int N,
                  int K, int splits, int k_per_split, cudaStream_t s) {
  const bool vec = N % 16 == 0 && reinterpret_cast<uintptr_t>(b) % 16 == 0;
  const dim3 grid((N + kStCols - 1) / kStCols, splits, (M + MT - 1) / MT);
  if (vec)
    int_matmul_stream<MT, true><<<grid, kStThreads, 0, s>>>(
        a, b, c, M, N, K, k_per_split, splits > 1);
  else
    int_matmul_stream<MT, false><<<grid, kStThreads, 0, s>>>(
        a, b, c, M, N, K, k_per_split, splits > 1);
  return static_cast<int>(cudaGetLastError());
}

int zero_for_atomics(void* c, int M, int N, int splits, cudaStream_t s) {
  if (splits <= 1) return 0;
  return static_cast<int>(cudaMemsetAsync(
      c, 0, static_cast<size_t>(M) * N * sizeof(int32_t), s));
}

}  // namespace

// C entry points bound with ctypes.  Each launches on `stream` and returns
// the first CUDA error (0 = launched), or sm90::kErrNoEncoder /
// sm90::kErrEncode (-1 / -2) when a TMA tensor map cannot be made.  The
// caller checks types, shapes and contiguity and plans the launch.

// (a) a int8 [M, K] row-major, K % 16 == 0; b int8 [K, ldb], ldb % 16 ==
// 0 and ldb >= N (columns past N are read and not stored); both 16-byte
// aligned.  c int32 [M, N].  The grid is (ceil(M/128), ceil(N/128),
// splits); split z runs k steps of 128 from z * steps_per_split.
extern "C" int int_matmul_tc_launch(const void* a, const void* b, void* c,
                                    int m, int n, int k, int ldb, int splits,
                                    int steps_per_split, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  CUtensorMap ta, tb;
  const cuuint64_t a_dims[2] = {static_cast<cuuint64_t>(k),
                                static_cast<cuuint64_t>(m)};
  const cuuint64_t a_strides[1] = {static_cast<cuuint64_t>(k)};
  const cuuint64_t b_dims[2] = {static_cast<cuuint64_t>(ldb),
                                static_cast<cuuint64_t>(k)};
  const cuuint64_t b_strides[1] = {static_cast<cuuint64_t>(ldb)};
  const cuuint32_t box[2] = {kTcBK, kTcBM};  // 128 x 128 for a and b alike
  int err = encode_sw128(&ta, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, a, a_dims,
                         a_strides, box);
  if (err) return err;
  err = encode_sw128(&tb, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, b, b_dims,
                     b_strides, box);
  if (err) return err;
  err = zero_for_atomics(c, m, n, splits, s);
  if (err) return err;
  const cudaError_t attr = cudaFuncSetAttribute(
      int_matmul_tc, cudaFuncAttributeMaxDynamicSharedMemorySize, kTcSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((m + kTcBM - 1) / kTcBM, (n + kTcBN - 1) / kTcBN, splits);
  int_matmul_tc<<<grid, kTcThreads, kTcSmem, s>>>(
      ta, tb, static_cast<int32_t*>(c), m, n, (k + kTcBK - 1) / kTcBK,
      steps_per_split, splits > 1);
  return static_cast<int>(cudaGetLastError());
}

// (b) a int8 [M, K], b int8 [K, N], c int32 [M, N], all contiguous, any
// alignment; M <= 16.  mt (1 or 4) rows of a per block; split y runs
// k in [y * k_per_split, (y + 1) * k_per_split), k_per_split a multiple of
// 64 and at most 4096.
extern "C" int int_matmul_stream_launch(const void* a, const void* b, void* c,
                                        int m, int n, int k, int mt,
                                        int splits, int k_per_split,
                                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err = zero_for_atomics(c, m, n, splits, s);
  if (err) return err;
  const auto* ap = static_cast<const int8_t*>(a);
  const auto* bp = static_cast<const int8_t*>(b);
  auto* cp = static_cast<int32_t*>(c);
  if (mt == 1)
    return launch_stream<1>(ap, bp, cp, m, n, k, splits, k_per_split, s);
  return launch_stream<4>(ap, bp, cp, m, n, k, splits, k_per_split, s);
}
