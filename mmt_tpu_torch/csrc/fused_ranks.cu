// Fused MoE similarity and rank counts for Hopper (sm_90a): for each query
// q, over all candidates c,
//
//   s[q, c]   = numer[q, c] / guard(denom[q, c]) + colbias[c]
//   valid     = c < C && c != gtcol[q]
//   closer[q] = #{c : valid && s[q, c] >  gt[q]}
//   tied[q]   = #{c : valid && s[q, c] == gt[q]}
//
// with numer and denom as in moe_similarity.cu (rows pre-scaled by their
// modality weights, K = M * D; the entry point first copies them k-major).
// Only the two [Q] counts are written: the [Q, C] similarity matrix never
// reaches device memory.
//
// Replaces the TPU kernel mmt_tpu/ops/ranking.py:_rank_kernel (launched by
// _fused_counts).  The Pallas grid walks the candidate tiles in order and
// carries the counts in its output block from one step to the next; here
// blocks run in no order, so each block counts its one (query tile,
// candidate tile) and adds to the global int32 counts: one atomicAdd per
// query row and count from each group of 8 threads that found any.
// Integer atomics are exact, so the counts do not depend on the order of
// the blocks.
//
// What bounds it on the H100: the fp32 FMAs of the numerator, 2 Q C K
// FLOP, against 67 TFLOP/s (tensor cores are out: TF32 or bf16 would change
// which candidates tie).  At Q = C = 20,000 and K = 3,584 that is 42.8 ms,
// at 50,000 267 ms, per orientation and caption slot; the bytes (the two
// operands once, 0.6 GB at 20k) are 0.2 ms, and the k-major copies move
// them once more (under 1 ms).  The design keeps the whole
// matrix in registers tile by tile, through the register-blocked,
// cp.async-pipelined tile of sim_tile.cuh (so every value is bitwise what
// moe_similarity.cu stores), and spends nothing on device memory; its rate
// is that tile's FFMA dispatch rate.
//
// Grid: one block per tile, in the panel order of sim_tile.cuh:decode_block
// (the blocks resident together share operand tiles in L2).  With the
// 128 x 64 tile 20,000 x 20,000 is 49,141 blocks for 396 resident slots
// (3 an SM), 124.1 waves paid as 125: a tail under 1%.  A persistent grid
// (one block per slot looping over its tiles, the counts kept in shared
// memory across them) was built and measured 65-68 ms against 62 at 20k:
// with the loop around it ptxas schedules the slice loop worse, and the
// atomics it saves (6 M of them at 20k) cost less than that.  A thread's
// counts of a tile (at most 8 per row) travel packed in one int through
// three shuffles over the 8 lanes that share a row; nothing but the
// product lives in registers during the k loop.
//
// ptxas (sm_90a): 128 x 64: 163 registers, no spill, 65,024 bytes of
// dynamic shared memory; 64 x 64: 96 registers, no spill, 43,776 bytes.

#include <cuda_runtime.h>

#include <cstddef>

#include "sim_tile.cuh"

using namespace mmt_sim;

namespace {

// Shared memory past the tile's pipe: the staged weights of the tile's
// rows and columns, then per row the GT value and GT column, then per
// column the bias.
template <class T>
constexpr int smem_bytes() {
  return (T::PIPE_FLOATS + (T::BM + T::BN) * WS + 2 * T::BM + T::BN) *
         int(sizeof(float));
}

template <class T>
__global__ void __launch_bounds__(T::THREADS, T::MIN_BLOCKS)
fused_ranks_kernel(const float* __restrict__ t, const float* __restrict__ c,
                   const float* __restrict__ tw, const float* __restrict__ cw,
                   const float* __restrict__ gt, const int* __restrict__ gtcol,
                   const float* __restrict__ colbias, int* __restrict__ closer,
                   int* __restrict__ tied, int Q, int C, int K, int M,
                   int ldt, int ldc, int q_tiles, int c_tiles) {
  extern __shared__ float4 dyn_smem[];
  float* pipe = reinterpret_cast<float*>(dyn_smem);
  float (*tws)[WS] = reinterpret_cast<float (*)[WS]>(pipe + T::PIPE_FLOATS);
  float (*cws)[WS] = tws + T::BM;
  float* gts = reinterpret_cast<float*>(cws + T::BN);
  int* gcols = reinterpret_cast<int*>(gts + T::BM);
  float* bias = reinterpret_cast<float*>(gcols + T::BM);

  int qt, ct;
  decode_block(q_tiles, c_tiles, qt, ct);
  const int q0 = qt * T::BM, c0 = ct * T::BN;
  const int ty = T::ty(), tx = T::tx();

  float acc[8][T::TN];
  tile_product<T>(t, c, ldt, ldc, K, q0, c0, pipe, acc);
  stage_weights<T::BM, T::THREADS>(tw, Q, M, q0, tws);
  stage_weights<T::BN, T::THREADS>(cw, C, M, c0, cws);
  for (int r = threadIdx.x; r < T::BM; r += T::THREADS) {
    gts[r] = q0 + r < Q ? gt[q0 + r] : 0.0f;
    gcols[r] = q0 + r < Q ? gtcol[q0 + r] : -1;
  }
  for (int j = threadIdx.x; j < T::BN; j += T::THREADS)
    bias[j] = c0 + j < C ? colbias[c0 + j] : 0.0f;
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = T::row(ty, i), q = q0 + r;
    const float g = gts[r];
    const int gcol = gcols[r];
    int packed = 0;      // closer in the low half, tied in the high half
#pragma unroll
    for (int j = 0; j < T::TN; ++j) {
      const int cc = T::col(tx, j), col = c0 + cc;
      // The bias is added after the divide, as the JAX kernel does.
      const float s = guarded_ratio(acc[i][j], tws[r], cws[cc], M) + bias[cc];
      const bool valid = col < C && col != gcol;
      packed += (valid && s > g) ? 1 : 0;
      packed += (valid && s == g) ? 0x10000 : 0;
    }
    // The 8 threads that share a row are 8 neighbouring lanes.
#pragma unroll
    for (int off = 4; off > 0; off >>= 1)
      packed += __shfl_down_sync(0xffffffffu, packed, off, 8);
    if (threadIdx.x % 8 == 0 && q < Q) {
      if (packed & 0xffff) atomicAdd(closer + q, packed & 0xffff);
      if (packed >> 16) atomicAdd(tied + q, packed >> 16);
    }
  }
}

template <class T>
int launch(const float* t, const float* c, const float* tw, const float* cw,
           const float* gt, const int* gtcol, const float* colbias,
           int* closer, int* tied, int Q, int C, int K, int M, int ldt,
           int ldc, cudaStream_t stream) {
  const long long q_tiles = (Q + T::BM - 1) / T::BM;
  const long long c_tiles = (C + T::BN - 1) / T::BN;
  if (q_tiles * c_tiles > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto* fn = fused_ranks_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      reinterpret_cast<const void*>(fn),
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<T>());
  if (err != cudaSuccess) return static_cast<int>(err);
  fn<<<static_cast<unsigned>(q_tiles * c_tiles), T::THREADS, smem_bytes<T>(),
       stream>>>(t, c, tw, cw, gt, gtcol, colbias, closer, tied, Q, C, K, M,
                 ldt, ldc, static_cast<int>(q_tiles),
                 static_cast<int>(c_tiles));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// t [Q, K] and c [C, K] are copied k-major into the scratch tt [K, ldt] and
// ct [K, ldc] (ldt >= Q and ldc >= C, multiples of 4; 16-byte aligned),
// which the product reads.  closer and tied must be zeroed by the caller;
// they are added to.  tile: 0 = 128 x 64 (8 x 8 a thread), 1 = 64 x 64 (8 x 4 a
// thread), both of 128 threads; the ids of ops/similarity.py:TILES.
extern "C" int mmt_fused_ranks(const float* t, const float* c, const float* tw,
                               const float* cw, const float* gt,
                               const int* gtcol, const float* colbias,
                               int* closer, int* tied, float* tt, float* ct,
                               int Q, int C, int K, int M, int ldt, int ldc,
                               int tile, void* stream_ptr) {
  if (Q <= 0 || C <= 0 || K <= 0 || M <= 0 || M > MAX_M || tile < 0 ||
      tile > 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto stream = static_cast<cudaStream_t>(stream_ptr);
  const cudaError_t err = to_k_major(t, c, tt, ct, Q, C, K, ldt, ldc, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  switch (tile) {
    case 0:
      return launch<Tile<128, 64, 3>>(tt, ct, tw, cw, gt, gtcol, colbias, closer,
                                      tied, Q, C, K, M, ldt, ldc, stream);
    case 1:
      return launch<Tile<64, 64, 4, 4>>(tt, ct, tw, cw, gt, gtcol, colbias,
                                        closer, tied, Q, C, K, M, ldt, ldc,
                                        stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
