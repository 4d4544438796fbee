// fp32 SIMT GEMM for Hopper (sm_90a) with a fused epilogue, the building
// block of the fp32 FFN kernels on their route: the eval block (B1), the
// train forward (B2) and the tensor-parallel partials (B6, B7) in
// ffn_block.cu, the train backward (B3) in ffn_train_bwd.cu:
//
//   kKMajorB:   C[M, N] = A[M, K] B[N, K]^T   (B with K contiguous: the
//               forward's nn.Linear [out, in] weights as stored)
//   !kKMajorB:  C[M, N] = A[M, K] B[K, N]     (B with N contiguous: the
//               same weights as the backward reads them, as stored)
//
// A is [M, K] with K contiguous.  Every value is fp32 and every product
// an exact fmaf: no TF32 and no tensor cores, so that the fp32 path stays
// the port's full-precision witness (the fp32 parity tests, the fp32 CLI
// witnesses).  Each pair of neighbouring C values is handed to
// epi(row, col, c[row, col], c[row, col + 1]) and never stored here: the
// epilogues are the bf16 route's (ffn_gemm.cuh's callers), instantiated
// for fp32.
//
// What bounds it on the H100: the fp32 FMA pipes, 67 TFLOP/s (the
// flagship's eval block is 4 R H I = 68.6 GFLOP at video 10,900 x 512,
// I = 3072: 1.02 ms), against which the fp32 intermediate of the FFN
// ([R, I], 134 MB each way at that shape) costs ~0.08 ms at 3.35 TB/s.
// The FMA kernels it replaces on the path (ffn_block.cu:ffn_block_f32_kernel,
// ffn_train_bwd.cu:ffn_train_bwd_f32_kernel) reached 1/19 of that bound:
// 16 rows a block, uncoalesced scalar weight loads feeding 8-16 FMAs each,
// nothing staged in shared memory, so every block read all of W1 and W2.
//
// Design (the classic register-blocked SGEMM).  One block of 256 threads
// owns a BM x 128 tile of C (BM = 128, 64 or 32, the id of kTileRows,
// chosen per call by the caller, ops/ffn.py:pick_f32_tile).  Thread
// (ty, tx) of the 16 x 16 grid holds a (2 BM / 32) x 8 microtile in
// registers: rows ty * BM / 32 + i of each half of the tile, columns
// 4 tx + j of each half of the 128.  The K loop runs over 16-wide slices
// of A and B, staged k-major in shared memory (a [16, BM + 4] and a
// [16, 132] array), so that each k reads a thread's A values and B values
// with one or two vector loads each (threads of a warp share their A
// rows, and read 16 neighbouring float4s of B: no bank conflict) and
// does 2 BM / 32 x 8 FMAs on them.  Two such stages alternate: while the
// FMAs consume one, the next slice's global loads are in flight into
// registers (16-byte loads, four neighbouring threads on a row's 64
// bytes), stored to the other stage after the FMAs (transposed for a
// K-major operand: two-way bank conflicts on that store at most), with
// one barrier a slice.  The weights are read from L2 once per BM rows of
// A instead of once per 16.
//
// Numerics: every output is one fmaf chain over k = 0, 1, ..., K - 1 in
// that order, from 0, as the FMA kernels' chains; so every tile id gives
// bitwise equal results, and an unnormalised output (B6's partial) equals
// the FMA kernel's bit for bit.
//
// Shapes taken: N % 128 == 0, K % 16 == 0, any M >= 1 (rows past M are
// staged as zeros and never handed to the epilogue; at most 65,535 row
// tiles); A and B 16-byte aligned.

#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace mmt_sgemm {

constexpr int BN = 128;        // columns of a block tile
constexpr int BK = 16;         // K of a stage
constexpr int kThreads = 256;  // a 16 x 16 grid of microtiles
constexpr int kTileRows[] = {128, 64, 32};  // rows of a block tile, by tile id
constexpr int kNumTiles = 3;
constexpr int kPad = 4;        // row padding of the staged slices (floats)
constexpr int kLdB = BN + kPad;
constexpr int kBLoads = BN * BK / 4 / kThreads;  // float4s a thread, of B

template <int BM>
struct Shape {
  static_assert(BM % 32 == 0 && BM <= 128, "BM / 32 rows a half-microtile");
  static constexpr int kHalf = BM / 32;     // rows a thread in each half
  static constexpr int kRows = 2 * kHalf;   // rows of a thread's microtile
  static constexpr int kLdA = BM + kPad;
  static constexpr int kALoads = (BM * BK / 4 + kThreads - 1) / kThreads;
  // Blocks an SM should hold: caps the registers (128 a thread at BM =
  // 128, whose 64 accumulators need most of them).
  static constexpr int kMinBlocks = BM == 128 ? 2 : (BM == 64 ? 3 : 4);
};

// N consecutive floats of shared memory at p (aligned to 4 N bytes).
template <int N>
__device__ __forceinline__ void lds(float* d, const float* p) {
  if constexpr (N == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    d[0] = v.x, d[1] = v.y, d[2] = v.z, d[3] = v.w;
  } else if constexpr (N == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    d[0] = v.x, d[1] = v.y;
  } else {
    static_assert(N == 1, "1, 2 or 4 floats");
    d[0] = *p;
  }
}

// The float4s this thread copies of a K-major slice: columns [k0, k0 + BK)
// of rows [r0, r0 + RW) of the row-major [rows, K] src, rows at or past
// ``rows`` as zeros.  Four neighbouring threads read a row's 64 bytes.
template <int RW, int N>
__device__ __forceinline__ void load_rows(float4 (&v)[N],
                                          const float* __restrict__ src,
                                          int r0, int rows, int K, int k0) {
#pragma unroll
  for (int p = 0; p < N; ++p) {
    const int f = threadIdx.x + p * kThreads;
    const int r = f / (BK / 4), kq = f % (BK / 4);
    v[p] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    const bool in_slice = (RW * BK / 4) % kThreads == 0 || f < RW * BK / 4;
    if (in_slice && r0 + r < rows) {
      v[p] = *reinterpret_cast<const float4*>(src + size_t(r0 + r) * K + k0 +
                                              kq * 4);
    }
  }
}

// ... stored k-major, s[k * ld + row]: the transpose the FMAs read.
template <int RW, int N>
__device__ __forceinline__ void store_rows(float* s, int ld,
                                           const float4 (&v)[N]) {
#pragma unroll
  for (int p = 0; p < N; ++p) {
    const int f = threadIdx.x + p * kThreads;
    const int r = f / (BK / 4), k = (f % (BK / 4)) * 4;
    if ((RW * BK / 4) % kThreads == 0 || f < RW * BK / 4) {
      s[k * ld + r] = v[p].x;
      s[(k + 1) * ld + r] = v[p].y;
      s[(k + 2) * ld + r] = v[p].z;
      s[(k + 3) * ld + r] = v[p].w;
    }
  }
}

// The float4s this thread copies of an N-major slice: rows [k0, k0 + BK)
// of columns [n0, n0 + BN) of the row-major [K, ldn] src (a warp reads
// one row's 512 bytes), and their store, already k-major.
__device__ __forceinline__ void load_cols(float4 (&v)[kBLoads],
                                          const float* __restrict__ src,
                                          int n0, int ldn, int k0) {
#pragma unroll
  for (int p = 0; p < kBLoads; ++p) {
    const int f = threadIdx.x + p * kThreads;
    const int k = f / (BN / 4), n = (f % (BN / 4)) * 4;
    v[p] = *reinterpret_cast<const float4*>(src + size_t(k0 + k) * ldn + n0 +
                                            n);
  }
}

__device__ __forceinline__ void store_cols(float* s,
                                           const float4 (&v)[kBLoads]) {
#pragma unroll
  for (int p = 0; p < kBLoads; ++p) {
    const int f = threadIdx.x + p * kThreads;
    const int k = f / (BN / 4), n = (f % (BN / 4)) * 4;
    *reinterpret_cast<float4*>(s + k * kLdB + n) = v[p];
  }
}

template <int BM, bool kKMajorB, typename Epilogue>
__global__ void __launch_bounds__(kThreads, Shape<BM>::kMinBlocks)
    ffn_sgemm_kernel(const float* __restrict__ a, const float* __restrict__ b,
                     int M, int N, int K, Epilogue epi) {
  using S = Shape<BM>;
  __shared__ __align__(16) float as[2][BK * S::kLdA];
  __shared__ __align__(16) float bs[2][BK * kLdB];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  float4 ra[S::kALoads], rb[kBLoads];

  auto load = [&](int k0) {
    load_rows<BM>(ra, a, m0, M, K, k0);
    if constexpr (kKMajorB) {
      load_rows<BN>(rb, b, n0, N, K, k0);
    } else {
      load_cols(rb, b, n0, N, k0);
    }
  };
  auto store = [&](int stage) {
    store_rows<BM>(as[stage], S::kLdA, ra);
    if constexpr (kKMajorB) {
      store_rows<BN>(bs[stage], kLdB, rb);
    } else {
      store_cols(bs[stage], rb);
    }
  };

  float acc[S::kRows][8];
#pragma unroll
  for (int i = 0; i < S::kRows; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  load(0);
  store(0);
  __syncthreads();
  const int ktiles = K / BK;
  for (int kt = 0; kt < ktiles; ++kt) {
    const int stage = kt & 1;
    const bool more = kt + 1 < ktiles;
    if (more) load((kt + 1) * BK);  // in flight during this slice's FMAs
    const float* sa = as[stage] + ty * S::kHalf;
    const float* sb = bs[stage] + tx * 4;
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float av[S::kRows], bv[8];
      lds<S::kHalf>(av, sa + k * S::kLdA);
      lds<S::kHalf>(av + S::kHalf, sa + k * S::kLdA + BM / 2);
      lds<4>(bv, sb + k * kLdB);
      lds<4>(bv + 4, sb + k * kLdB + BN / 2);
#pragma unroll
      for (int i = 0; i < S::kRows; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    // The other stage was last read in the previous slice, before the
    // barrier that ended it.
    if (more) store(stage ^ 1);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < S::kRows; ++i) {
    const int row =
        m0 + (i / S::kHalf) * (BM / 2) + ty * S::kHalf + i % S::kHalf;
    if (row < M) {
#pragma unroll
      for (int g = 0; g < 2; ++g) {
        const int col = n0 + g * (BN / 2) + tx * 4;
        epi(row, col, acc[i][4 * g], acc[i][4 * g + 1]);
        epi(row, col + 2, acc[i][4 * g + 2], acc[i][4 * g + 3]);
      }
    }
  }
}

// True if a product with C [M, N] and K is a shape the kernel takes.
inline bool sgemm_shape_ok(int M, int N, int K) {
  return M > 0 && N > 0 && K > 0 && N % BN == 0 && K % BK == 0;
}

template <int BM, bool kKMajorB, typename Epilogue>
int launch_tile(const float* a, const float* b, int M, int N, int K,
                Epilogue epi, cudaStream_t stream) {
  const int row_tiles = (M + BM - 1) / BM;
  if (row_tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  ffn_sgemm_kernel<BM, kKMajorB, Epilogue>
      <<<dim3(N / BN, row_tiles), kThreads, 0, stream>>>(a, b, M, N, K, epi);
  return static_cast<int>(cudaGetLastError());
}

// C = A op(B) through ``epi`` with the block tile of id ``tile``; a CUDA
// error code (cudaErrorInvalidValue for a shape, alignment or tile id the
// kernel does not take).
template <bool kKMajorB, typename Epilogue>
int sgemm(const float* a, const float* b, int M, int N, int K, int tile,
          Epilogue epi, cudaStream_t stream) {
  if (!sgemm_shape_ok(M, N, K) || reinterpret_cast<uintptr_t>(a) % 16 ||
      reinterpret_cast<uintptr_t>(b) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (tile) {
    case 0:
      return launch_tile<kTileRows[0], kKMajorB>(a, b, M, N, K, epi, stream);
    case 1:
      return launch_tile<kTileRows[1], kKMajorB>(a, b, M, N, K, epi, stream);
    case 2:
      return launch_tile<kTileRows[2], kKMajorB>(a, b, M, N, K, epi, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace mmt_sgemm
