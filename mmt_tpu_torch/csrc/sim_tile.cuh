// The fp32 MoE-similarity tile shared by the similarity kernel
// (moe_similarity.cu) and the fused similarity-and-rank kernel
// (fused_ranks.cu).  Both compute every similarity with this code, so a
// value the rank kernel compares is bitwise the value the similarity
// kernel stores for the same inputs.
//
// The arithmetic contract: every product sum is one fmaf chain over
// k = 0 .. K-1 in ascending order, starting from 0, in fp32 without TF32
// (the ranks compare these values for equality, so the tensor cores are
// out).  A value therefore depends on its row and column only, never on
// the tile shape, the thread layout, the slice depth or the number of
// stages: every instantiation of Tile gives the same bits.
//
// What bounds it on the H100 is the FFMA dispatch rate (one warp instruction
// per clock per SM sub-partition, 67 TFLOP/s in all): every other
// instruction dispatched takes a slot from the FMAs, and every stall of a
// warp must be covered by another.  What the design does about it:
//
// * Each thread holds an 8 x TN register tile (TN = 8 or 4), laid out in
//   quadrants of 4 x 4 (rows ty*4+i and BM/2+ty*4+i; columns tx*4+j and,
//   for TN = 8, BN/2+tx*4+j), so one k step is 8 TN FMAs for 2 + TN/4
//   16-byte shared loads from a k-major slice.  A warp is 4 x 8 threads:
//   its A fragments are 4 and its B fragments 8 consecutive float4,
//   conflict-free, the rest broadcast.  The fragments of k + 1 are loaded
//   while k's FMAs run.
// * The operands come k-major ([K, rows]: the C entry points first copy
//   both into scratch the wrappers allocate, one launch of k_major_kernel
//   below, under 1 ms of 62 at 20,000 x 20,000), so a tile's slice is BK runs
//   of BM (BN) contiguous floats and goes to shared memory as it lies, by
//   16-byte cp.async: 6 copies a thread and slice in the 128 x 64 tile.
//   Row-major operands need the copy itself to transpose, which only
//   4-byte copies can do: 24 a thread and slice, each with its own
//   address; that version measured 71 ms where this one takes 62.  TMA
//   would copy the same boxes; with 6 copies a thread there is little
//   left for it to save, and cp.async needs no descriptor per operand, so
//   it is not used.
// * K is walked in 16-deep slices through a ring of 3 shared buffers, so
//   two slices are in flight while one is multiplied, with one
//   __syncthreads per slice; a slice's copies are spread over the k steps
//   of the slice before, not sent in one burst in front of the fragment
//   loads.  The slice loop of the 128 x 64 tile runs 1,024 FFMA beside
//   64 LDS.128, 6 copies and about 60 other instructions.
// * Blocks are small (128 threads) and several share an SM (three of
//   128 x 64 at 168 registers), so one block's barrier and pipeline fill
//   are covered by the others; the register cap also keeps ptxas from
//   hoisting a whole slice of fragment loads in front of the FMAs, which
//   it did at 236 registers (79 ms against 62 at 20,000 x 20,000).
// * Two shapes (ops/similarity.py:pick_tile): 128 x 64 of 8 x 8 per
//   thread has the fewest shared loads per FMA and is the faster one when
//   the card is full of blocks; 64 x 64 of 8 x 4 puts four times the
//   warps of half the work each on a small matrix, where a warp's own
//   latency is what counts (every thread walks all of K).
//
// Columns past the end of an operand and k past K are zero-filled by the
// copy (src-size 0): exact zeros on the chains, never stored or counted.

#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace mmt_sim {

constexpr int MAX_M = 32;
constexpr int WS = MAX_M + 1;        // padded row of the staged weights
constexpr int PANEL = 8;             // row tiles per panel of the tile order
constexpr float EPS_ZERO_GUARD = 1e-5f;

// A BM x BN block tile of 8 x TN register tiles; MIN_BLOCKS blocks an SM
// are asked of the compiler (__launch_bounds__).
template <int BM_, int BN_, int MIN_BLOCKS_, int TN_ = 8>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, MIN_BLOCKS = MIN_BLOCKS_;
  static constexpr int TN = TN_, QN = TN / 4;        // 8 x TN a thread
  static constexpr int BK = 16, STAGES = 3;
  static constexpr int TX = BN / TN, TY = BM / 8;    // threads across, down
  static constexpr int THREADS = TX * TY;
  static constexpr int LDA = BM + 4, LDB = BN + 4;   // k-major row strides
  static constexpr int STAGE_FLOATS = BK * (LDA + LDB);
  static constexpr int PIPE_FLOATS = STAGES * STAGE_FLOATS;
  // 16-byte copies of one slice per thread, of each operand.
  static constexpr int FA = BK * (BM / 4) / THREADS;
  static constexpr int FB = BK * (BN / 4) / THREADS, COPIES = FA + FB;
  static_assert(TX % 8 == 0 && TY % 4 == 0, "a warp is 4 x 8 threads");
  static_assert(THREADS % (BM / 4) == 0 && THREADS % (BN / 4) == 0 &&
                    FA >= 1 && FB >= 1,
                "a thread's copies lie whole k rows apart");

  // The thread's place in the TY x TX grid: warps tile it in 4 x 8 patches.
  __device__ static int ty() {
    return (threadIdx.x / 32 / (TX / 8)) * 4 + threadIdx.x % 32 / 8;
  }
  __device__ static int tx() {
    return (threadIdx.x / 32 % (TX / 8)) * 8 + threadIdx.x % 8;
  }
  // Tile row of acc[i][.] and tile column of acc[.][j].
  __device__ static int row(int ty, int i) {
    return (i / 4) * (BM / 2) + ty * 4 + i % 4;
  }
  __device__ static int col(int tx, int j) {
    return (j / 4) * (BN / QN) + tx * 4 + j % 4;
  }
};

// 16 bytes from global to shared memory, past L1; ``bytes`` (16 or 0) are
// read, the rest is zero-filled.
__device__ __forceinline__ void cp_async16(uint32_t dst, const float* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// acc[i][j] = sum_k at[k, a0 + T::row(ty, i)] * bt[k, b0 + T::col(tx, j)]
// over k = 0 .. K-1, for k-major operands at [K, lda] and bt [K, ldb] (lda
// and ldb multiples of 4, the arrays 16-byte aligned); columns at or past
// lda / ldb give 0.  ``pipe`` is T::PIPE_FLOATS floats of 16-byte-aligned
// shared memory.  Every thread of the block must call it; it ends without
// a barrier (the block's threads may still be reading the last slices).
template <class T>
__device__ __forceinline__ void tile_product(const float* __restrict__ at,
                                             const float* __restrict__ bt,
                                             int lda, int ldb, int K, int a0,
                                             int b0, float* pipe,
                                             float (&acc)[8][T::TN]) {
  constexpr int BK = T::BK, LDA = T::LDA, LDB = T::LDB, STAGES = T::STAGES;
  constexpr int FA = T::FA, FB = T::FB;
  constexpr int CA = T::BM / 4, CB = T::BN / 4;   // float4 per k row
  const int ty = T::ty(), tx = T::tx();

  // This thread's copies: float4 number threadIdx.x % CA of the k rows
  // threadIdx.x / CA, + THREADS / CA, ... of the a slice; the same for b.
  // One pointer per copy, moved on by BK k rows after each slice.
  const int ca = threadIdx.x % CA * 4, cb = threadIdx.x % CB * 4;
  const int ka = threadIdx.x / CA, kb = threadIdx.x / CB;
  const bool in_a = a0 + ca < lda, in_b = b0 + cb < ldb;
  const float* src[FA + FB];
#pragma unroll
  for (int u = 0; u < FA; ++u)
    src[u] =
        at + size_t(ka + u * (T::THREADS / CA)) * lda + (in_a ? a0 + ca : 0);
#pragma unroll
  for (int u = 0; u < FB; ++u)
    src[FA + u] =
        bt + size_t(kb + u * (T::THREADS / CB)) * ldb + (in_b ? b0 + cb : 0);
  const size_t step_a = size_t(BK) * lda, step_b = size_t(BK) * ldb;
  const uint32_t pipe_s = static_cast<uint32_t>(__cvta_generic_to_shared(pipe));
  const uint32_t sa = pipe_s + (ka * LDA + ca) * 4;
  const uint32_t sb = pipe_s + (BK * LDA + kb * LDB + cb) * 4;
  int k0 = 0;                    // first k of the slice to copy next
  uint32_t wr = 0;               // byte offset of the stage it goes to

  // Copy number c (of T::COPIES) of that slice; past K it zero-fills.
  auto copy = [&](int c) {
    if (c < FA) {
      const int dk = c * (T::THREADS / CA);
      cp_async16(sa + wr + dk * LDA * 4, src[c],
                 (in_a && k0 + ka + dk < K) ? 16 : 0);
    } else {
      const int dk = (c - FA) * (T::THREADS / CB);
      cp_async16(sb + wr + dk * LDB * 4, src[c],
                 (in_b && k0 + kb + dk < K) ? 16 : 0);
    }
  };
  // All copies of the slice are under way: commit them and move on.
  auto next_slice = [&]() {
    cp_async_commit();
#pragma unroll
    for (int u = 0; u < FA; ++u) src[u] += step_a;
#pragma unroll
    for (int u = 0; u < FB; ++u) src[FA + u] += step_b;
    k0 += BK;
    wr = wr + T::STAGE_FLOATS * 4 == T::PIPE_FLOATS * 4
             ? 0
             : wr + T::STAGE_FLOATS * 4;
  };

#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < T::TN; ++j) acc[i][j] = 0.0f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
#pragma unroll
    for (int c = 0; c < T::COPIES; ++c) copy(c);
    next_slice();
  }

  const int slices = (K + BK - 1) / BK;
  int rd = 0;                    // float offset of the stage of slice s
  for (int s = 0; s < slices; ++s) {
    // Slice s has landed for this thread, then for all; and every thread
    // is done with slice s - 1, whose stage this iteration's copies (of
    // slice s + STAGES - 1, spread over the k steps) overwrite.
    cp_async_wait<STAGES - 2>();
    __syncthreads();

    const float* as = pipe + rd + ty * 4;
    const float* bs = pipe + rd + BK * LDA + tx * 4;
    float4 fa[2][2], fb[2][T::QN];
    auto fragments = [&](int k, int buf) {
      fa[buf][0] = *reinterpret_cast<const float4*>(as + k * LDA);
      fa[buf][1] = *reinterpret_cast<const float4*>(as + k * LDA + T::BM / 2);
#pragma unroll
      for (int u = 0; u < T::QN; ++u)
        fb[buf][u] = *reinterpret_cast<const float4*>(bs + k * LDB +
                                                      u * (T::BN / T::QN));
    };
    fragments(0, 0);
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const int cur = k & 1;
      if (k + 1 < BK) fragments(k + 1, cur ^ 1);
#pragma unroll
      for (int c = k * T::COPIES / BK; c < (k + 1) * T::COPIES / BK; ++c)
        copy(c);
      const float av[8] = {fa[cur][0].x, fa[cur][0].y, fa[cur][0].z,
                           fa[cur][0].w, fa[cur][1].x, fa[cur][1].y,
                           fa[cur][1].z, fa[cur][1].w};
      float bv[T::TN];
#pragma unroll
      for (int u = 0; u < T::QN; ++u) {
        bv[u * 4 + 0] = fb[cur][u].x;
        bv[u * 4 + 1] = fb[cur][u].y;
        bv[u * 4 + 2] = fb[cur][u].z;
        bv[u * 4 + 3] = fb[cur][u].w;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < T::TN; ++j)
          acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    next_slice();
    rd = rd + T::STAGE_FLOATS == T::PIPE_FLOATS ? 0 : rd + T::STAGE_FLOATS;
  }
  cp_async_wait<0>();
}

// Which tile of a q_tiles x c_tiles grid the block computes.  Blocks walk
// panels of PANEL row tiles (the last panel may be narrower), column tile
// by column tile and row tile by row tile inside a column: the blocks
// resident together then cover a compact patch of the matrix and share
// their operand tiles in L2.
__device__ __forceinline__ void decode_block(int q_tiles, int c_tiles, int& qt,
                                             int& ct) {
  const int per_panel = PANEL * c_tiles;
  const int p = blockIdx.x / per_panel, rem = blockIdx.x - p * per_panel;
  const int first = p * PANEL, width = min(PANEL, q_tiles - first);
  ct = rem / width;
  qt = first + rem - ct * width;
}

// Stage rows [r0, r0 + ROWS) of the [N, M] weights w into ws (0 past N).
// The caller synchronises before reading ws.
template <int ROWS, int THREADS>
__device__ __forceinline__ void stage_weights(const float* __restrict__ w,
                                              int N, int M, int r0,
                                              float (*ws)[WS]) {
  for (int e = threadIdx.x; e < ROWS * M; e += THREADS) {
    const int r = e / M, m = e % M;
    ws[r][m] = (r0 + r < N) ? w[size_t(r0 + r) * M + m] : 0.0f;
  }
}

// numer / (a . b over M), the denominator 0 -> 1e-5; an IEEE divide.
__device__ __forceinline__ float guarded_ratio(float numer, const float* a,
                                               const float* b, int M) {
  float d = 0.0f;
  for (int m = 0; m < M; ++m) d = fmaf(a[m], b[m], d);
  if (d == 0.0f) d = EPS_ZERO_GUARD;
  return numer / d;
}

// The k-major copies of both operands in one launch: a [na, K] -> at
// [K, lda] and b [nb, K] -> bt [K, ldb], zeros in the columns past na and
// nb.  32 x 32 tiles through shared memory, so that the reads run along K
// and the writes along the rows; blockIdx.z picks the operand.  A template
// so that the two sources that include this header may both define it.
template <int TILE = 32>
__global__ void __launch_bounds__(TILE * 8)
k_major_kernel(const float* __restrict__ a, const float* __restrict__ b,
               float* __restrict__ at, float* __restrict__ bt, int na, int nb,
               int K, int lda, int ldb) {
  __shared__ float tile[TILE][TILE + 1];
  const float* in = blockIdx.z ? b : a;
  float* out = blockIdx.z ? bt : at;
  const int n = blockIdx.z ? nb : na, ld = blockIdx.z ? ldb : lda;
  const int n0 = blockIdx.y * TILE, k0 = blockIdx.x * TILE;
  if (n0 >= ld) return;
  for (int r = threadIdx.y; r < TILE; r += 8) {
    const int row = n0 + r, k = k0 + threadIdx.x;
    tile[r][threadIdx.x] =
        (row < n && k < K) ? in[size_t(row) * K + k] : 0.0f;
  }
  __syncthreads();
  for (int r = threadIdx.y; r < TILE; r += 8) {
    const int k = k0 + r, col = n0 + threadIdx.x;
    if (k < K && col < ld) out[size_t(k) * ld + col] = tile[threadIdx.x][r];
  }
}

// Launch it; lda and ldb must be multiples of 4 no smaller than na and nb,
// and at and bt 16-byte aligned (what tile_product asks of its operands).
inline cudaError_t to_k_major(const float* a, const float* b, float* at,
                              float* bt, int na, int nb, int K, int lda,
                              int ldb, cudaStream_t stream) {
  if (lda < na || ldb < nb || lda % 4 || ldb % 4 ||
      reinterpret_cast<uintptr_t>(at) % 16 ||
      reinterpret_cast<uintptr_t>(bt) % 16) {
    return cudaErrorInvalidValue;
  }
  const int wide = lda > ldb ? lda : ldb;
  const dim3 grid((K + 31) / 32, (wide + 31) / 32, 2);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  k_major_kernel<><<<grid, dim3(32, 8), 0, stream>>>(a, b, at, bt, na, nb, K,
                                                      lda, ldb);
  return cudaGetLastError();
}

}  // namespace mmt_sim
