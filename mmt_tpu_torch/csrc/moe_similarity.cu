// Fused MoE-weighted similarity for Hopper (sm_90a):
//
//   numer[q, v] = t[q, :] . v[v, :]          (K = M * D, rows pre-scaled)
//   denom[q, v] = tw[q, :] . vw[v, :]        (over the M modalities)
//   out[q, v]   = numer / (denom == 0 ? 1e-5 : denom)
//
// Replaces the TPU kernel mmt_tpu/ops/similarity.py:_sim_kernel (launched
// by _pallas_moe_similarity through moe_similarity).  As there, the
// modality weights are multiplied into the embeddings and the [Q, M, D]
// rows are flattened to [Q, M * D] outside the kernel (in the torch
// wrapper), so the whole op is one NT product with a fused epilogue.
//
// What bounds it on the H100: at the flagship eval (Q = V = 1000, M = 7,
// D = 512) the product is 7.2 GFLOP of fp32, and the operands are 29 MB.
// It stays in fp32 without TF32 because the ranks compare these values for
// equality, so the tensor cores are out and the limit is the 67 TFLOP/s of
// fp32 FMA.  Each block computes a 64 x 64 output tile with a 4 x 4
// micro-tile per thread, staging 16-deep K slices of both operands in
// shared memory (each operand value is read from shared memory by 16
// threads, i.e. 8 FMAs per shared load).  The denominator's [64, M] weight
// rows are staged once per tile and the guarded divide is fused before the
// single store of the output, so no [Q, V] intermediate reaches device
// memory.  Ragged Q and V edges are masked, not padded.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int BQ = 64, BV = 64, BK = 16;
constexpr int THREADS = 256;
constexpr int MAX_M = 32;
constexpr float EPS_ZERO_GUARD = 1e-5f;

__global__ void __launch_bounds__(THREADS)
moe_similarity_kernel(const float* __restrict__ t, const float* __restrict__ v,
                      const float* __restrict__ tw,
                      const float* __restrict__ vw, float* __restrict__ out,
                      int Q, int V, int K, int M) {
  __shared__ float ts[BK][BQ + 4];
  __shared__ float vs[BK][BV + 4];
  __shared__ float tws[BQ][MAX_M + 1];
  __shared__ float vws[BV][MAX_M + 1];

  const int q0 = blockIdx.y * BQ, v0 = blockIdx.x * BV;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // 16 consecutive threads read 16 consecutive K values of one row.
    for (int e = tid; e < BQ * BK; e += THREADS) {
      const int r = e / BK, k = e % BK, gk = k0 + k;
      ts[k][r] = (q0 + r < Q && gk < K) ? t[size_t(q0 + r) * K + gk] : 0.0f;
      vs[k][r] = (v0 + r < V && gk < K) ? v[size_t(v0 + r) * K + gk] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = ts[k][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = vs[k][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  for (int e = tid; e < BQ * M; e += THREADS) {
    const int r = e / M, m = e % M;
    tws[r][m] = (q0 + r < Q) ? tw[size_t(q0 + r) * M + m] : 0.0f;
    vws[r][m] = (v0 + r < V) ? vw[size_t(v0 + r) * M + m] : 0.0f;
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int q = q0 + ty * 4 + i;
    if (q >= Q) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = v0 + tx * 4 + j;
      if (c >= V) continue;
      float d = 0.0f;
      for (int m = 0; m < M; ++m) d = fmaf(tws[ty * 4 + i][m], vws[tx * 4 + j][m], d);
      if (d == 0.0f) d = EPS_ZERO_GUARD;
      out[size_t(q) * V + c] = acc[i][j] / d;
    }
  }
}

}  // namespace

extern "C" int mmt_moe_similarity(const float* t, const float* v,
                                  const float* tw, const float* vw, float* out,
                                  int Q, int V, int K, int M,
                                  void* stream_ptr) {
  if (Q <= 0 || V <= 0 || K <= 0 || M <= 0 || M > MAX_M ||
      (Q + BQ - 1) / BQ > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((V + BV - 1) / BV, (Q + BQ - 1) / BQ);
  moe_similarity_kernel<<<grid, THREADS, 0,
                          static_cast<cudaStream_t>(stream_ptr)>>>(
      t, v, tw, vw, out, Q, V, K, M);
  return static_cast<int>(cudaGetLastError());
}
