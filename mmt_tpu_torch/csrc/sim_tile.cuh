// The 64 x 64 fp32 MoE-similarity tile shared by the similarity kernel
// (moe_similarity.cu) and the fused similarity-and-rank kernel
// (fused_ranks.cu).  Both compute every similarity with this code, so a
// value the rank kernel compares is bitwise the value the similarity
// kernel stores for the same inputs.
//
// Each block of 256 threads computes a 64 x 64 tile with a 4 x 4
// micro-tile per thread, staging 16-deep K slices of both operands in
// shared memory (each operand value is read from shared memory by 16
// threads, i.e. 8 FMAs per shared load).  Every sum is one fmaf chain in K
// order, in fp32 without TF32: the ranks compare these values for
// equality.  Ragged edges read zeros, they are not padded.

#pragma once

#include <cuda_runtime.h>

#include <cstddef>

namespace mmt_sim {

constexpr int BQ = 64, BV = 64, BK = 16;
constexpr int THREADS = 256;
constexpr int MAX_M = 32;
constexpr float EPS_ZERO_GUARD = 1e-5f;

struct Smem {
  float ts[BK][BQ + 4];
  float vs[BK][BV + 4];
  float tws[BQ][MAX_M + 1];   // modality weights of the tile's 64 rows
  float vws[BV][MAX_M + 1];   // ... and of its 64 columns
};

// acc[i][j] = t[q0 + ty * 4 + i, :] . v[v0 + tx * 4 + j, :] with
// ty = threadIdx.x / 16, tx = threadIdx.x % 16; rows past Q or V give 0.
// Every thread of the block must call it; it ends with __syncthreads().
__device__ __forceinline__ void tile_product(const float* __restrict__ t,
                                             const float* __restrict__ v,
                                             int Q, int V, int K, int q0,
                                             int v0, Smem& sm,
                                             float (&acc)[4][4]) {
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // 16 consecutive threads read 16 consecutive K values of one row.
    for (int e = tid; e < BQ * BK; e += THREADS) {
      const int r = e / BK, k = e % BK, gk = k0 + k;
      sm.ts[k][r] = (q0 + r < Q && gk < K) ? t[size_t(q0 + r) * K + gk] : 0.0f;
      sm.vs[k][r] = (v0 + r < V && gk < K) ? v[size_t(v0 + r) * K + gk] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sm.ts[k][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = sm.vs[k][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
}

// Stage rows [r0, r0 + 64) of the [N, M] weights w into ws (0 past N).
// The caller synchronises before reading ws.
__device__ __forceinline__ void stage_weights(const float* __restrict__ w,
                                              int N, int M, int r0,
                                              float (*ws)[MAX_M + 1]) {
  for (int e = threadIdx.x; e < 64 * M; e += THREADS) {
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

}  // namespace mmt_sim
