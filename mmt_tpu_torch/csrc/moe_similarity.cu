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
// wrapper), so the whole op is one NT product with a fused epilogue; the
// entry point first copies the two operands k-major ([K, Q], [K, V]).
//
// What bounds it on the H100: at the flagship eval (Q = V = 1000, M = 7,
// D = 512) the product is 7.2 GFLOP of fp32 over 29 MB of operands.  It
// stays in fp32 without TF32 because the ranks compare these values for
// equality, so the tensor cores are out and the limit is the 67 TFLOP/s
// of fp32 FMA: the FFMA dispatch slots.  The product is the register-blocked,
// cp.async-pipelined tile of csrc/sim_tile.cuh (shared with the fused rank
// kernel, which therefore compares bitwise these values), in one of two
// shapes that the caller picks per call from Q, V and the SM count
// (ops/similarity.py:pick_tile).  At 1000 x 1000 nothing fills the card:
// every thread walks all of K whatever the grid, 1.9 us of FMA dispatch per
// output of its own at 1.9 GHz, so the 64 x 64 tile of 8 x 4 per thread
// (256 blocks, two warps a scheduler, 0.11 ms of dispatch) beats the 128 x 64
// tile of 8 x 8 (128 blocks, one warp a scheduler, the same 0.11 ms with
// nothing to cover a stall): 0.215 against 0.260 ms.  Every shape gives
// the same bits.  The grid is one-dimensional and walks the matrix in
// panels of 8 row tiles (sim_tile.cuh:decode_block), so the blocks
// resident together share operand tiles in L2.  The denominator's weight
// rows are staged once per tile and the guarded divide is fused before
// the single store of the output (16-byte stores where V % 4 == 0), so no
// [Q, V] intermediate reaches device memory.  Ragged Q and V edges are
// masked, not padded; any K is taken.
//
// ptxas (sm_90a): 128 x 64: 161 registers, no spill, 63,744 bytes of
// dynamic shared memory; 64 x 64: 93 registers, no spill, 43,008
// bytes.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "sim_tile.cuh"

using namespace mmt_sim;

namespace {

template <class T>
constexpr int smem_bytes() {
  return (T::PIPE_FLOATS + (T::BM + T::BN) * WS) * int(sizeof(float));
}

template <class T>
__global__ void __launch_bounds__(T::THREADS, T::MIN_BLOCKS)
moe_similarity_kernel(const float* __restrict__ t, const float* __restrict__ v,
                      const float* __restrict__ tw,
                      const float* __restrict__ vw, float* __restrict__ out,
                      int Q, int V, int K, int M, int ldt, int ldv,
                      int q_tiles, int v_tiles, int vec) {
  extern __shared__ float4 dyn_smem[];
  float* pipe = reinterpret_cast<float*>(dyn_smem);
  float (*tws)[WS] = reinterpret_cast<float (*)[WS]>(pipe + T::PIPE_FLOATS);
  float (*vws)[WS] = tws + T::BM;

  int qt, vt;
  decode_block(q_tiles, v_tiles, qt, vt);
  const int q0 = qt * T::BM, v0 = vt * T::BN;
  const int ty = T::ty(), tx = T::tx();

  float acc[8][T::TN];
  tile_product<T>(t, v, ldt, ldv, K, q0, v0, pipe, acc);
  stage_weights<T::BM, T::THREADS>(tw, Q, M, q0, tws);
  stage_weights<T::BN, T::THREADS>(vw, V, M, v0, vws);
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = T::row(ty, i), q = q0 + r;
    if (q >= Q) continue;
#pragma unroll
    for (int jh = 0; jh < T::QN; ++jh) {
      const int cc = T::col(tx, jh * 4), c = v0 + cc;
      float s[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        s[j] = guarded_ratio(acc[i][jh * 4 + j], tws[r], vws[cc + j], M);
      float* dst = out + size_t(q) * V + c;
      if (vec && c + 3 < V) {
        *reinterpret_cast<float4*>(dst) = make_float4(s[0], s[1], s[2], s[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (c + j < V) dst[j] = s[j];
      }
    }
  }
}

template <class T>
int launch(const float* t, const float* v, const float* tw, const float* vw,
           float* out, int Q, int V, int K, int M, int ldt, int ldv,
           cudaStream_t stream) {
  const long long q_tiles = (Q + T::BM - 1) / T::BM;
  const long long v_tiles = (V + T::BN - 1) / T::BN;
  if (q_tiles * v_tiles > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto* fn = moe_similarity_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      reinterpret_cast<const void*>(fn),
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<T>());
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vec =
      V % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0 ? 1 : 0;
  fn<<<static_cast<unsigned>(q_tiles * v_tiles), T::THREADS, smem_bytes<T>(),
       stream>>>(t, v, tw, vw, out, Q, V, K, M, ldt, ldv,
                 static_cast<int>(q_tiles), static_cast<int>(v_tiles), vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// t [Q, K] and v [V, K] are copied k-major into the scratch tt [K, ldt] and
// vt [K, ldv] (ldt >= Q and ldv >= V, multiples of 4; 16-byte aligned),
// which the product reads.  tile: 0 = 128 x 64 (8 x 8 a thread), 1 = 64 x 64
// (8 x 4 a thread), both of 128 threads; the ids of ops/similarity.py:TILES.
extern "C" int mmt_moe_similarity(const float* t, const float* v,
                                  const float* tw, const float* vw, float* out,
                                  float* tt, float* vt, int Q, int V, int K,
                                  int M, int ldt, int ldv, int tile,
                                  void* stream_ptr) {
  if (Q <= 0 || V <= 0 || K <= 0 || M <= 0 || M > MAX_M || tile < 0 ||
      tile > 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto stream = static_cast<cudaStream_t>(stream_ptr);
  const cudaError_t err = to_k_major(t, v, tt, vt, Q, V, K, ldt, ldv, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  switch (tile) {
    case 0:
      return launch<Tile<128, 64, 3>>(tt, vt, tw, vw, out, Q, V, K, M, ldt, ldv,
                                      stream);
    case 1:
      return launch<Tile<64, 64, 4, 4>>(tt, vt, tw, vw, out, Q, V, K, M, ldt,
                                        ldv, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
