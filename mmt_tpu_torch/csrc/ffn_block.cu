// Fused eval FFN sub-block for Hopper (sm_90a):
//
//   out = LayerNorm(x + GELU_erf(x W1^T + b1) W2^T + b2)
//
// Replaces the TPU kernel mmt_tpu/ops/ffn.py:_ffn_kernel (launched by
// _pallas_ffn_2d through ffn_block).  Same numerics: x is rounded to the
// compute type for the first product, bias and erf-GELU run in fp32, the
// GELU output is rounded to the compute type for the second product, both
// products accumulate in fp32, and the residual + LayerNorm (fast variance
// mean(y^2) - mean^2, clamped at 0) run in fp32.  The output is fp32.
//
// What bounds it on the H100: at the flagship eval shapes (video 10,900 x
// 512 and text 1,500 x 768 rows per chunk of 50, I = 3072) the two
// products are 69 and 14 GFLOP, and the [R, I] intermediate would be 67
// and 9 MB of fp32 traffic each way if it went through device memory.
// The TPU kernel kept it in VMEM; here one block owns a tile of TR = 16
// rows and walks I in chunks of 128: the chunk of the intermediate lives
// in shared memory (fp32 for the GELU, then the compute type), and the
// [16, H] output accumulates in WMMA register fragments across chunks, so
// the intermediate never reaches device memory.  The weights (6.3 / 9.4 MB
// in bf16) stay resident in the 50 MB L2 and every block streams them from
// there: with 16-row tiles that L2 traffic, not the tensor cores, is the
// limit of this first version (larger row tiles, TMA and wgmma are later
// work).  The text tower gives only 94 blocks for 132 SMs.
//
// bf16 compute uses WMMA 16x16x16 bf16 fragments with fp32 accumulation.
// fp32 compute uses plain FMA (no TF32), so the card can check the kernel
// in full fp32.  Weights are read in nn.Linear's [out, in] layout: both
// products are "NT" with K contiguous, and no call needs a transpose.
// Ragged row counts are masked: rows past R are staged as zeros and never
// stored.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstddef>

namespace {

using bf16 = __nv_bfloat16;
using namespace nvcuda;

constexpr int TR = 16;              // rows per block: one WMMA M tile
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int IC = WARPS * 16;      // I-chunk: one 16-wide tile per warp
constexpr int MAX_H = 1024;
constexpr int MAXF = MAX_H / 16 / WARPS;  // output column tiles per warp
constexpr int MAXJ = MAX_H / THREADS;     // output columns per thread (fp32)
constexpr int PAD = 8;              // row padding of the staged tiles

__device__ __forceinline__ float gelu_erf(float u) {
  return 0.5f * u * (1.0f + erff(u * 0.70710678118654752f));
}

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ bf16 from_float<bf16>(float v) {
  return __float2bfloat16(v);
}

// Shared memory: x tile [TR, H + PAD] and GELU chunk [TR, IC + PAD] in the
// compute type, then an fp32 scratch [TR, max(H, IC) + 4] that holds the
// first product's tile (bf16 path) and the pre-LN rows (epilogue).
struct Layout {
  int ldx, ldi, lds;
  size_t xs_bytes, is_bytes, bytes;
  __host__ __device__ Layout(int h, size_t tc_size) {
    ldx = h + PAD;
    ldi = IC + PAD;
    lds = (h > IC ? h : IC) + 4;
    xs_bytes = size_t(TR) * ldx * tc_size;
    is_bytes = size_t(TR) * ldi * tc_size;
    bytes = xs_bytes + is_bytes + size_t(TR) * lds * sizeof(float);
  }
};

template <typename TC>
__device__ __forceinline__ void stage_x(const float* __restrict__ x, TC* xs,
                                        int row0, int R, int H, int ldx) {
  for (int e = threadIdx.x; e < TR * H; e += THREADS) {
    const int r = e / H, c = e % H;
    const float v = (row0 + r < R) ? x[size_t(row0 + r) * H + c] : 0.0f;
    xs[r * ldx + c] = from_float<TC>(v);
  }
}

// Residual + bias + fast-variance LayerNorm over the [TR, H] fp32 rows in
// ss, one warp per row.
__device__ __forceinline__ void layer_norm_epilogue(
    const float* __restrict__ x, const float* __restrict__ b2,
    const float* __restrict__ gamma, const float* __restrict__ beta,
    float* __restrict__ out, float* ss, int lds, int row0, int R, int H,
    float eps) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < TR; r += WARPS) {
    const int gr = row0 + r;
    if (gr >= R) continue;  // warp-uniform
    float s = 0.0f, s2 = 0.0f;
    for (int c = lane; c < H; c += 32) {
      const float y = ss[r * lds + c] + b2[c] + x[size_t(gr) * H + c];
      ss[r * lds + c] = y;
      s += y;
      s2 += y * y;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, off);
      s2 += __shfl_xor_sync(0xffffffffu, s2, off);
    }
    const float mean = s / H;
    const float var = fmaxf(s2 / H - mean * mean, 0.0f);
    const float rstd = rsqrtf(var + eps);
    for (int c = lane; c < H; c += 32) {
      out[size_t(gr) * H + c] =
          (ss[r * lds + c] - mean) * rstd * gamma[c] + beta[c];
    }
  }
}

// bf16 compute: WMMA fragments, [TR, H] accumulator in registers.
__global__ void __launch_bounds__(THREADS)
ffn_block_bf16_kernel(const float* __restrict__ x, const bf16* __restrict__ w1,
                      const float* __restrict__ b1,
                      const bf16* __restrict__ w2,
                      const float* __restrict__ b2,
                      const float* __restrict__ gamma,
                      const float* __restrict__ beta, float* __restrict__ out,
                      int R, int H, int I, float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L(H, sizeof(bf16));
  bf16* xs = reinterpret_cast<bf16*>(smem);
  bf16* is = reinterpret_cast<bf16*>(smem + L.xs_bytes);
  float* ss = reinterpret_cast<float*>(smem + L.xs_bytes + L.is_bytes);
  const int row0 = blockIdx.x * TR;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ntiles = H / 16;

  stage_x(x, xs, row0, R, H, L.ldx);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[MAXF];
#pragma unroll
  for (int f = 0; f < MAXF; ++f) wmma::fill_fragment(acc[f], 0.0f);
  __syncthreads();

  for (int c0 = 0; c0 < I; c0 += IC) {
    // First product: this warp's 16 columns of the chunk.
    const int col = c0 + warp * 16;
    if (col < I) {  // warp-uniform
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> u;
      wmma::fill_fragment(u, 0.0f);
      for (int k = 0; k < H; k += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
        wmma::load_matrix_sync(a, xs + k, L.ldx);
        wmma::load_matrix_sync(b, w1 + size_t(col) * H + k, H);
        wmma::mma_sync(u, a, b, u);
      }
      wmma::store_matrix_sync(ss + warp * 16, u, L.lds, wmma::mem_row_major);
    }
    __syncwarp();
    // Bias + GELU in fp32, rounded to bf16 for the second product.
    for (int e = lane; e < 256; e += 32) {
      const int r = e / 16, cc = e % 16, c = warp * 16 + cc;
      const float v = (col < I) ? gelu_erf(ss[r * L.lds + c] + b1[col + cc])
                                : 0.0f;
      is[r * L.ldi + c] = __float2bfloat16(v);
    }
    __syncthreads();
    // Second product: acc[f] (output tile n) += GELU chunk x W2[n, chunk]^T.
    const int kmax = min(IC, I - c0);
#pragma unroll
    for (int f = 0; f < MAXF; ++f) {
      const int n = warp + WARPS * f;
      if (n < ntiles) {  // warp-uniform
        for (int k = 0; k < kmax; k += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
          wmma::load_matrix_sync(a, is + k, L.ldi);
          wmma::load_matrix_sync(b, w2 + size_t(n) * 16 * I + c0 + k, I);
          wmma::mma_sync(acc[f], a, b, acc[f]);
        }
      }
    }
    __syncthreads();  // is and ss are rewritten by the next chunk
  }

#pragma unroll
  for (int f = 0; f < MAXF; ++f) {
    const int n = warp + WARPS * f;
    if (n < ntiles) {
      wmma::store_matrix_sync(ss + n * 16, acc[f], L.lds, wmma::mem_row_major);
    }
  }
  __syncthreads();
  layer_norm_epilogue(x, b2, gamma, beta, out, ss, L.lds, row0, R, H, eps);
}

// fp32 compute: plain FMA, [TR, H] accumulator in registers (thread t owns
// columns t, t + 256, ...).
__global__ void __launch_bounds__(THREADS)
ffn_block_f32_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                     const float* __restrict__ b1,
                     const float* __restrict__ w2,
                     const float* __restrict__ b2,
                     const float* __restrict__ gamma,
                     const float* __restrict__ beta, float* __restrict__ out,
                     int R, int H, int I, float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L(H, sizeof(float));
  float* xs = reinterpret_cast<float*>(smem);
  float* is = reinterpret_cast<float*>(smem + L.xs_bytes);
  float* ss = reinterpret_cast<float*>(smem + L.xs_bytes + L.is_bytes);
  const int row0 = blockIdx.x * TR;
  const int t = threadIdx.x;

  stage_x(x, xs, row0, R, H, L.ldx);
  float acc[MAXJ][TR];
#pragma unroll
  for (int j = 0; j < MAXJ; ++j)
#pragma unroll
    for (int r = 0; r < TR; ++r) acc[j][r] = 0.0f;
  __syncthreads();

  constexpr int RH = TR * IC / THREADS;  // rows per thread in the 1st product
  const int c = t % IC, rh = (t / IC) * RH;
  for (int c0 = 0; c0 < I; c0 += IC) {
    const int col = c0 + c;
    float u[RH];
#pragma unroll
    for (int r = 0; r < RH; ++r) u[r] = 0.0f;
    if (col < I) {
      const float* wrow = w1 + size_t(col) * H;
      for (int k = 0; k < H; ++k) {
        const float w = wrow[k];
#pragma unroll
        for (int r = 0; r < RH; ++r) u[r] = fmaf(xs[(rh + r) * L.ldx + k], w, u[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < RH; ++r) {
      is[(rh + r) * L.ldi + c] = (col < I) ? gelu_erf(u[r] + b1[col]) : 0.0f;
    }
    __syncthreads();
    const int kmax = min(IC, I - c0);
#pragma unroll
    for (int j = 0; j < MAXJ; ++j) {
      const int h = t + THREADS * j;
      if (h < H) {
        const float* wrow = w2 + size_t(h) * I + c0;
        for (int k = 0; k < kmax; ++k) {
          const float w = wrow[k];
#pragma unroll
          for (int r = 0; r < TR; ++r) acc[j][r] = fmaf(is[r * L.ldi + k], w, acc[j][r]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < MAXJ; ++j) {
    const int h = t + THREADS * j;
    if (h < H) {
#pragma unroll
      for (int r = 0; r < TR; ++r) ss[r * L.lds + h] = acc[j][r];
    }
  }
  __syncthreads();
  layer_norm_epilogue(x, b2, gamma, beta, out, ss, L.lds, row0, R, H, eps);
}

}  // namespace

// compute_dtype (shared with mmt_tpu_torch/ops/ffn.py): 0 = float32,
// 1 = bfloat16.  x, biases, gamma, beta and out are float32.
extern "C" int mmt_ffn_block(const float* x, const void* w1, const float* b1,
                             const void* w2, const float* b2,
                             const float* gamma, const float* beta, float* out,
                             int R, int H, int I, float eps, int compute_dtype,
                             void* stream_ptr) {
  if (R <= 0 || H <= 0 || H > MAX_H || H % 16 != 0 || I <= 0 || I % 16 != 0 ||
      compute_dtype < 0 || compute_dtype > 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const bool bf = compute_dtype == 1;
  const Layout L(H, bf ? sizeof(bf16) : sizeof(float));
  const void* fn = bf ? reinterpret_cast<const void*>(&ffn_block_bf16_kernel)
                      : reinterpret_cast<const void*>(&ffn_block_f32_kernel);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, int(L.bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((R + TR - 1) / TR);
  if (bf) {
    ffn_block_bf16_kernel<<<grid, THREADS, L.bytes, stream>>>(
        x, static_cast<const bf16*>(w1), b1, static_cast<const bf16*>(w2), b2,
        gamma, beta, out, R, H, I, eps);
  } else {
    ffn_block_f32_kernel<<<grid, THREADS, L.bytes, stream>>>(
        x, static_cast<const float*>(w1), b1, static_cast<const float*>(w2),
        b2, gamma, beta, out, R, H, I, eps);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* mmt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
