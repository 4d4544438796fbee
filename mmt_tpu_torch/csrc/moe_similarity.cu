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
// fp32 FMA.  The 64 x 64 tile (csrc/sim_tile.cuh, shared with the fused
// rank kernel) stages 16-deep K slices of both operands in shared memory
// and gives each thread a 4 x 4 micro-tile.  The denominator's [64, M]
// weight rows are staged once per tile and the guarded divide is fused
// before the single store of the output, so no [Q, V] intermediate reaches
// device memory.  Ragged Q and V edges are masked, not padded.

#include <cuda_runtime.h>

#include <cstddef>

#include "sim_tile.cuh"

using namespace mmt_sim;

namespace {

__global__ void __launch_bounds__(THREADS)
moe_similarity_kernel(const float* __restrict__ t, const float* __restrict__ v,
                      const float* __restrict__ tw,
                      const float* __restrict__ vw, float* __restrict__ out,
                      int Q, int V, int K, int M) {
  __shared__ Smem sm;
  const int q0 = blockIdx.y * BQ, v0 = blockIdx.x * BV;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;

  float acc[4][4];
  tile_product(t, v, Q, V, K, q0, v0, sm, acc);
  stage_weights(tw, Q, M, q0, sm.tws);
  stage_weights(vw, V, M, v0, sm.vws);
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int q = q0 + ty * 4 + i;
    if (q >= Q) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = v0 + tx * 4 + j;
      if (c >= V) continue;
      out[size_t(q) * V + c] =
          guarded_ratio(acc[i][j], sm.tws[ty * 4 + i], sm.vws[tx * 4 + j], M);
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
