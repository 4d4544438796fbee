// Fused MoE similarity and rank counts for Hopper (sm_90a): for each query
// q, over all candidates c,
//
//   s[q, c]   = numer[q, c] / guard(denom[q, c]) + colbias[c]
//   valid     = c < C && c != gtcol[q]
//   closer[q] = #{c : valid && s[q, c] >  gt[q]}
//   tied[q]   = #{c : valid && s[q, c] == gt[q]}
//
// with numer and denom as in moe_similarity.cu (rows pre-scaled by their
// modality weights, K = M * D).  Only the two [Q] counts are written: the
// [Q, C] similarity matrix never reaches device memory.
//
// Replaces the TPU kernel mmt_tpu/ops/ranking.py:_rank_kernel (launched by
// _fused_counts).  The Pallas grid walks the candidate tiles in order and
// carries the counts in its output block from one step to the next; here
// blocks run in no order, so each block loops over its share of candidate
// tiles with the counts in registers and adds them to the global int32
// counts with one atomicAdd per query row.  Integer atomics are exact, so
// the counts do not depend on the order of the blocks.
//
// What bounds it on the H100: the fp32 FMAs of the numerator, 2 Q C K
// FLOP, against 67 TFLOP/s (tensor cores are out: TF32 or bf16 would change
// which candidates tie).  At Q = C = 20,000 and K = 3,584 that is 42.8 ms,
// at 50,000 267 ms, per orientation and caption slot; the bytes (the two
// operands once, 0.6 GB at 20k) are 0.2 ms.  The design keeps the whole
// matrix in registers tile by tile (the similarity tile of sim_tile.cuh, so
// every value is bitwise what moe_similarity.cu stores) and spends nothing
// on memory; its rate is that tile's register-blocked FMA rate.
//
// Grid: Q tiles x S candidate splits on one dimension (blockIdx.x, no 65535
// cap).  S gives the grid at least 8 blocks per SM: with two blocks
// resident per SM (100 registers a thread), a grid of one wave and a bit
// (313 blocks at 20k, S = 1) ran in two waves' time.

#include <cuda_runtime.h>

#include "sim_tile.cuh"

using namespace mmt_sim;

namespace {

__global__ void __launch_bounds__(THREADS)
fused_ranks_kernel(const float* __restrict__ t, const float* __restrict__ c,
                   const float* __restrict__ tw, const float* __restrict__ cw,
                   const float* __restrict__ gt, const int* __restrict__ gtcol,
                   const float* __restrict__ colbias, int* __restrict__ closer,
                   int* __restrict__ tied, int Q, int C, int K, int M,
                   int splits) {
  __shared__ Smem sm;
  const int q0 = (blockIdx.x / splits) * BQ, split = blockIdx.x % splits;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int c_tiles = (C + BV - 1) / BV;

  // The block's query rows are fixed: their weights, GT values and GT
  // columns are read once.  Rows past Q are counted and then dropped.
  stage_weights(tw, Q, M, q0, sm.tws);
  float g[4];
  int gcol[4], n_closer[4], n_tied[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int q = q0 + ty * 4 + i;
    g[i] = q < Q ? gt[q] : 0.0f;
    gcol[i] = q < Q ? gtcol[q] : -1;
    n_closer[i] = 0;
    n_tied[i] = 0;
  }

  for (int ct = split; ct < c_tiles; ct += splits) {
    const int c0 = ct * BV;
    float acc[4][4];
    tile_product(t, c, Q, C, K, q0, c0, sm, acc);
    stage_weights(cw, C, M, c0, sm.vws);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = c0 + tx * 4 + j;
      if (col >= C) continue;
      const float bias = colbias[col];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        // The bias is added after the divide, as the JAX kernel does.
        const float s = guarded_ratio(acc[i][j], sm.tws[ty * 4 + i],
                                      sm.vws[tx * 4 + j], M) + bias;
        const bool valid = col != gcol[i];
        n_closer[i] += (valid && s > g[i]) ? 1 : 0;
        n_tied[i] += (valid && s == g[i]) ? 1 : 0;
      }
    }
    __syncthreads();   // the next tile restages vws
  }

  // The 16 threads that share a row are one half-warp: reduce by shuffles,
  // then one atomicAdd per row and count.
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int a = n_closer[i], b = n_tied[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      a += __shfl_down_sync(0xffffffffu, a, off, 16);
      b += __shfl_down_sync(0xffffffffu, b, off, 16);
    }
    const int q = q0 + ty * 4 + i;
    if (tx == 0 && q < Q) {
      if (a) atomicAdd(closer + q, a);
      if (b) atomicAdd(tied + q, b);
    }
  }
}

}  // namespace

// closer and tied must be zeroed by the caller; they are added to.
extern "C" int mmt_fused_ranks(const float* t, const float* c, const float* tw,
                               const float* cw, const float* gt,
                               const int* gtcol, const float* colbias,
                               int* closer, int* tied, int Q, int C, int K,
                               int M, void* stream_ptr) {
  if (Q <= 0 || C <= 0 || K <= 0 || M <= 0 || M > MAX_M) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long q_tiles = (Q + BQ - 1) / BQ, c_tiles = (C + BV - 1) / BV;
  long long splits = (8LL * sms + q_tiles - 1) / q_tiles;
  if (splits > c_tiles) splits = c_tiles;
  if (splits < 1) splits = 1;
  if (q_tiles * splits > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  fused_ranks_kernel<<<static_cast<unsigned>(q_tiles * splits), THREADS, 0,
                       static_cast<cudaStream_t>(stream_ptr)>>>(
      t, c, tw, cw, gt, gtcol, colbias, closer, tied, Q, C, K, M,
      static_cast<int>(splits));
  return static_cast<int>(cudaGetLastError());
}
