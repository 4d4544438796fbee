// TN GEMM for Hopper (sm_90a) with a fused epilogue, the building block
// of the bf16 FFN kernels on their GEMM route: the eval block (B1), its
// tensor-parallel partial (B6) and the train forward (B2) in
// ffn_block.cu, the train backward (B3) in ffn_train_bwd.cu:
//
//   C[M, N] = A[M, K] B[N, K]^T,  A and B bf16 with K contiguous,
//   accumulated in fp32, each pair of neighbouring C values handed to
//   epi(row, col, c[row, col], c[row, col + 1]) and never stored here.
//
// nn.Linear's [out, in] weights are [N, K] with K contiguous, so both
// products of the forward are this shape without a transpose; the
// backward's products read the weights transposed (ffn_train_bwd.cu makes
// the copies).
//
// Design.  One block owns a BM x 128 tile of C (BM = 128 or 64, the id
// of kTileRows, chosen per call by the caller).  Its K loop runs over
// 64-wide slices (128 bytes of bf16, one row of the 128-byte swizzle):
// one producer warp keeps a ring of kStages slices of A and B in flight
// with TMA (cp.async.bulk.tensor, 128-byte swizzle, completion on a "full"
// mbarrier per stage), and one consumer warpgroup per 64 rows runs four
// wgmma.m64n128k16 per slice from shared memory, with one group of them
// in flight while it waits for the next slice; a consumer releases a
// stage on its "empty" mbarrier once the wgmmas that read it are done.
// The weights are then read from L2 once per BM rows of A instead of
// once per 16 (the WMMA kernel's tile), and no thread spends registers or
// instructions on the copies.  Every tile id issues the same m64n128k16
// chain over K in the same order for a given output element, so the ids
// give bitwise equal results.  kStages fills 96 KB of shared memory, so
// two blocks share an SM and one block's epilogue overlaps the other's
// main loop (the grid is not persistent).
//
// Shapes taken: N % 128 == 0, K % 64 == 0, any M >= 1 (rows past M are
// read as zeros by TMA and never handed to the epilogue); A and B 16-byte
// aligned.  The tensor maps are encoded per call on the host, through
// libcuda's cuTensorMapEncodeTiled fetched with cudaGetDriverEntryPoint
// (the library does not link libcuda), and passed as __grid_constant__
// parameters.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace mmt_gemm {

using bf16 = __nv_bfloat16;

constexpr int BN = 128;  // columns of a block tile: one m64n128k16 wgmma
constexpr int BK = 64;   // K of a stage: 128 bytes of bf16
constexpr int kTileRows[] = {128, 64};  // rows of a block tile, by tile id
constexpr int kNumTiles = 2;
constexpr int kRingBytes = 96 * 1024;   // shared memory of the stage ring

template <int BM>
struct Shape {
  static_assert(BM % 64 == 0, "one consumer warpgroup per 64 rows");
  static constexpr int kConsumers = BM / 64;
  static constexpr int kThreads = kConsumers * 128 + 32;  // + producer warp
  static constexpr int kABytes = BM * BK * 2;
  static constexpr int kBBytes = BN * BK * 2;
  static constexpr int kStages = kRingBytes / (kABytes + kBBytes);
  // The ring, a full and an empty barrier per stage, and the slack to
  // align the ring to the 1024 bytes of the swizzle pattern.
  static constexpr size_t kSmem =
      size_t(kStages) * (kABytes + kBBytes) + 2 * kStages * 8 + 1024;
};

// ---- PTX wrappers --------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar))
               : "memory");
}

// Wait until the phase of parity ``parity`` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// TMA: the box of ``map`` at (inner, outer) into shared memory, counted
// on ``bar``.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int inner, int outer) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(inner),
      "r"(outer)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major tile with the 128-byte
// swizzle: start address, leading offset 16 B (unused by this layout),
// 1024 B between groups of 8 rows, swizzle mode 1.
__device__ __forceinline__ uint64_t smem_desc(const void* tile) {
  const uint64_t addr = smem_addr(tile);
  return ((addr & 0x3FFFF) >> 4) | (uint64_t(16 >> 4) << 16) |
         (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keep the compiler from moving accumulator registers across the
// asynchronous wgmmas that own them.
__device__ __forceinline__ void fence_operands(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64 x 128] += A[64 x 16] B[128 x 16]^T, both K-major in shared memory.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, 1, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db));
}

// ---- the kernel ------------------------------------------------------------

template <int BM, typename Epilogue>
__global__ void __launch_bounds__(Shape<BM>::kThreads, 2)
    ffn_tn_gemm_kernel(const __grid_constant__ CUtensorMap map_a,
                       const __grid_constant__ CUtensorMap map_b, int M, int K,
                       Epilogue epi) {
  using S = Shape<BM>;
  extern __shared__ unsigned char smem_raw[];
  // The swizzle pattern repeats every 1024 bytes: align the ring to it.
  unsigned char* smem = smem_raw + ((1024 - smem_addr(smem_raw) % 1024) % 1024);
  unsigned char* ring_a = smem;
  unsigned char* ring_b = smem + S::kStages * S::kABytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(
      smem + S::kStages * (S::kABytes + S::kBBytes));
  uint64_t* empty = full + S::kStages;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int ktiles = K / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], S::kConsumers * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == S::kConsumers) {
    // Producer warp: one thread issues every copy.
    if (threadIdx.x == S::kConsumers * 128) {
      for (int kt = 0; kt < ktiles; ++kt) {
        const int s = kt % S::kStages;
        if (kt >= S::kStages) mbar_wait(&empty[s], ((kt / S::kStages) & 1) ^ 1);
        mbar_expect_tx(&full[s], S::kABytes + S::kBBytes);
        tma_load(ring_a + s * S::kABytes, &map_a, &full[s], kt * BK, m0);
        tma_load(ring_b + s * S::kBBytes, &map_b, &full[s], kt * BK, n0);
      }
    }
    return;
  }

  // Consumer warpgroup wg: rows [m0 + 64 wg, m0 + 64 wg + 64).
  float d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0.0f;
  for (int kt = 0; kt < ktiles; ++kt) {
    const int s = kt % S::kStages;
    mbar_wait(&full[s], (kt / S::kStages) & 1);
    const uint64_t da = smem_desc(ring_a + s * S::kABytes + wg * 64 * BK * 2);
    const uint64_t db = smem_desc(ring_b + s * S::kBBytes);
    fence_operands(d);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < BK / 16; ++k) {
      // 16 elements of K are 32 bytes: 2 in the descriptor's address field.
      wgmma_m64n128k16(d, da + 2 * k, db + 2 * k);
    }
    wgmma_commit();
    wgmma_wait<1>();  // the previous slice's wgmmas are done: free its stage
    fence_operands(d);
    if (kt > 0) mbar_arrive(&empty[(kt - 1) % S::kStages]);
  }
  wgmma_wait<0>();
  fence_operands(d);

  // Accumulator layout of m64nNk16: warp w of the warpgroup holds rows
  // 16 w + lane / 4 (+ 8); d[4 j + e] is column 8 j + 2 (lane % 4) + e % 2,
  // row + 8 for e >= 2.
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  const int row = m0 + wg * 64 + warp * 16 + lane / 4;
  const int col = n0 + (lane % 4) * 2;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    if (row < M) epi(row, col + 8 * j, d[4 * j], d[4 * j + 1]);
    if (row + 8 < M) epi(row + 8, col + 8 * j, d[4 * j + 2], d[4 * j + 3]);
  }
}

// The epilogue that stores C in fp32, [M, ld]: B6's unreduced partial and
// B3's dx without dz (its tensor-parallel partial).
struct PartialEpilogue {
  float* out;
  int ld;
  __device__ __forceinline__ void operator()(int r, int c, float v0,
                                             float v1) const {
    *reinterpret_cast<float2*>(out + size_t(r) * ld + c) = make_float2(v0, v1);
  }
};

// ---- host side -------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, fetched once; null if unavailable.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &found);
#endif
    return (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// Tensor map of a row-major bf16 [rows, cols] matrix, read in boxes of
// box_rows x BK with the 128-byte swizzle; false if it cannot be encoded.
inline bool make_map(CUtensorMap* map, const void* base, int rows, int cols,
                     int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {cuuint64_t(cols), cuuint64_t(rows)};
  const cuuint64_t strides[1] = {cuuint64_t(cols) * sizeof(bf16)};
  const cuuint32_t box[2] = {cuuint32_t(BK), cuuint32_t(box_rows)};
  const cuuint32_t elem_strides[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                const_cast<void*>(base), dims, strides, box, elem_strides,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// True if a [M, K] x [N, K]^T product is a shape the kernel takes.
inline bool gemm_shape_ok(int M, int N, int K) {
  return M > 0 && N > 0 && K > 0 && N % BN == 0 && K % BK == 0;
}

template <int BM, typename Epilogue>
int launch_tile(const bf16* a, const bf16* b, int M, int N, int K,
                Epilogue epi, cudaStream_t stream) {
  using S = Shape<BM>;
  CUtensorMap map_a, map_b;
  if (!make_map(&map_a, a, M, K, BM) || !make_map(&map_b, b, N, K, BN)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto* fn = &ffn_tn_gemm_kernel<BM, Epilogue>;
  // Set once per instantiation, not on every call: the port drives one
  // card a process (a launch on another card would fail, not misbehave).
  static const cudaError_t opted_in = cudaFuncSetAttribute(
      reinterpret_cast<const void*>(fn),
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(S::kSmem));
  if (opted_in != cudaSuccess) return static_cast<int>(opted_in);
  fn<<<dim3(N / BN, (M + BM - 1) / BM), S::kThreads, S::kSmem, stream>>>(
      map_a, map_b, M, K, epi);
  return static_cast<int>(cudaGetLastError());
}

// C = A B^T through ``epi`` with the block tile of id ``tile``; a CUDA
// error code (cudaErrorInvalidValue for a shape, alignment or tile id the
// kernel does not take).
template <typename Epilogue>
int tn_gemm(const bf16* a, const bf16* b, int M, int N, int K, int tile,
            Epilogue epi, cudaStream_t stream) {
  if (!gemm_shape_ok(M, N, K) || reinterpret_cast<uintptr_t>(a) % 16 ||
      reinterpret_cast<uintptr_t>(b) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (tile) {
    case 0:
      return launch_tile<kTileRows[0]>(a, b, M, N, K, epi, stream);
    case 1:
      return launch_tile<kTileRows[1]>(a, b, M, N, K, epi, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace mmt_gemm
