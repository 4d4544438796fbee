// Fused FFN sub-block for Hopper (sm_90a): the eval block, the train
// forward and their tensor-parallel shard-local halves:
//
//   eval  (B1):  out = LayerNorm(x + GELU_erf(x W1^T + b1) W2^T + b2)
//   train (B2):  z   = (GELU_erf(x W1^T + b1) W2^T + b2) * drop + x
//                out = LayerNorm(z), and also writes inter = x W1^T + b1
//                and z, both rounded to the compute type, for B3
//   partial (B6):        out = GELU_erf(x W1s^T + b1s) W2s^T   (fp32)
//   train partial (B7):  the same, and also writes inter = x W1s^T + b1s
//                        rounded to the compute type
//
// B1 replaces the TPU kernel mmt_tpu/ops/ffn.py:_ffn_kernel (launched by
// _pallas_ffn_2d through ffn_block); B2 replaces _ffn_train_fwd_kernel
// (launched by _pallas_ffn_train_fwd through ffn_block_train); B6
// replaces _ffn_partial_kernel (_pallas_ffn_partial_2d) and B7
// _ffn_train_fwd_partial_kernel (_pallas_ffn_train_fwd_partial), the
// halves that run on a tensor-parallel rank's column shard W1s [I/mp, H],
// b1s [I/mp] and row shard W2s [H, I/mp].  The partials are unreduced:
// the caller all-reduces them over the ranks and adds b2, the mask, the
// residual and the LayerNorm (mmt_tpu_torch/ops/ffn.py).  One template
// (Mode) gives all four: the partial modes are the same kernel with the
// epilogue off, the accumulator fragments stored straight to out.  Same
// numerics as the TPU kernels: x is
// rounded to the compute type for the first product, bias and erf-GELU
// run in fp32 on the unrounded product, the GELU output is rounded to the
// compute type for the second product, both products accumulate in fp32,
// the pre-scaled dropout mask multiplies y + b2 before the residual, and
// the residual + LayerNorm (fast variance mean(z^2) - mean^2, clamped at
// 0) run in fp32 on the unrounded z.  The output is fp32.
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
// work).  The text tower gives only 94 blocks for 132 SMs at eval (60 at
// the b32 train step).  B2 must write inter for the backward ([R, I] in
// the compute type: 43 MB at the b32 video shape), one 16 x 16 tile per
// warp and chunk straight from the fp32 scratch.  With two ranks the
// partials do half the work on half the weights (I/mp = 1536: 17 GFLOP
// at the video eval shape, bound 0.035 ms of bf16 tensor-core time) and
// stay L2-streaming bound in the same way; B7 writes half of B2's inter.
//
// bf16 compute uses WMMA 16x16x16 bf16 fragments with fp32 accumulation.
// fp32 compute uses plain FMA (no TF32), so the card can check the kernel
// in full fp32.  Weights are read in nn.Linear's [out, in] layout: both
// products are "NT" with K contiguous, and no call needs a transpose.
// Ragged row counts are masked: rows past R are staged as zeros and never
// stored.
//
// In bf16 all four take another route where H and I are multiples of
// 128 (every configuration under configs/eccv20/: H = 512 / 768, I =
// 3072, I/mp = 1536 / 768): two TMA + wgmma GEMMs with fused epilogues
// (ffn_gemm.cuh) and up to two row passes,
//
//   xb = bf16(x)                                     cast pass
//   u  = xb W1^T + b1                                GEMM 1, [R, I]
//   g  = bf16(GELU_erf(u)); B2, B7 also inter = bf16(u)   (its epilogue)
//   B6, B7: out = g W2^T                             GEMM 2
//   B1: out = g W2^T + b2 + x, then LayerNorm(out)   GEMM 2, row pass
//   B2: out = (g W2^T + b2) * drop + x, then z = bf16(out) and
//       LayerNorm(out)                               GEMM 2, row pass
//
// with the same rounding points as above (the intermediate goes through
// memory already rounded to bf16, as the WMMA kernel rounds it in shared
// memory; the GELU is taken of the unrounded u).  What bounds it: the two
// products, 4 R H I FLOP (69 GFLOP at the video eval shape: 0.069 ms of
// tensor-core time at 989 TFLOP/s; 44 GFLOP at B2's b32 video shape),
// against which the bf16 intermediate adds 2 x 67 MB of traffic at the
// video eval shape (~0.04 ms at 3.35 TB/s, partly in L2; B2 also writes
// inter, 43 MB at b32, B7 half that) and the row passes ~60 MB.  The
// weights are read from L2 once per 128 (or 64) rows instead of once per
// 16.  The
// LayerNorm is a row pass and not GEMM 2's epilogue: a block owns 128 of
// the H = 512 / 768 columns, and a block of all H columns would hold a
// [64, 768] fp32 accumulator, 384 registers a thread of one warpgroup.
//
// In fp32 (the compute type of every configuration under configs/eccv20/,
// which leave CENet's compute_dtype at its default) all four take the
// fp32 route at the same widths: the same two products and row pass in
// fp32 through the SIMT GEMM of ffn_sgemm.cuh (exact fmaf, no TF32), with
// no cast pass, g [R, I] in fp32 and inter and z stored in fp32; the
// epilogues and the row pass are the bf16 route's, instantiated for fp32.
// What bounds it: 4 R H I FLOP at the 67 TFLOP/s of fp32 FMA (1.02 ms at
// the video eval shape), against which g's round trip (2 x 134 MB there)
// is ~0.08 ms.  Every output of the products is one fmaf chain in
// ascending k, as the FMA kernel's, so the partial modes give its bits.
//
// Other widths keep the WMMA / FMA kernels.  The caller chooses the
// route (ops/ffn.py:gemm_route, f32_route): a tile id >= 0 takes the
// compute type's route, whose launcher refuses a shape it does not take;
// -1 the WMMA / FMA kernel, which also serves as the routes' witness.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstddef>

#include "ffn_common.cuh"
#include "ffn_gemm.cuh"
#include "ffn_sgemm.cuh"

namespace {

using namespace mmt_ffn;
using namespace nvcuda;

// What one instantiation computes: B1, B2, B6 or B7 (see the top).
enum class Mode { kEval, kTrain, kPartial, kTrainPartial };

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

// Bias (+ dropout mask) + residual + fast-variance LayerNorm over the
// [TR, H] fp32 rows in ss, one warp per row.  The train forward also
// writes the pre-LN rows z in the compute type.
template <bool kTrain, typename TC>
__device__ __forceinline__ void layer_norm_epilogue(
    const float* __restrict__ x, const float* __restrict__ b2,
    const float* __restrict__ drop, const float* __restrict__ gamma,
    const float* __restrict__ beta, float* __restrict__ out,
    TC* __restrict__ z, float* ss, int lds, int row0, int R, int H,
    float eps) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < TR; r += WARPS) {
    const int gr = row0 + r;
    if (gr >= R) continue;  // warp-uniform
    const size_t base = size_t(gr) * H;
    float s = 0.0f, s2 = 0.0f;
    for (int c = lane; c < H; c += 32) {
      float y;
      if constexpr (kTrain) {
        y = (ss[r * lds + c] + b2[c]) * drop[base + c] + x[base + c];
        z[base + c] = from_float<TC>(y);
      } else {
        y = ss[r * lds + c] + b2[c] + x[base + c];
      }
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
      out[base + c] = (ss[r * lds + c] - mean) * rstd * gamma[c] + beta[c];
    }
  }
}

// Kernel parameters: b2, gamma, beta and drop are read, and z written,
// only by the modes with the epilogue (B1: b2, gamma, beta; B2: all);
// inter is written only by the train modes.  The others get null
// pointers.
#define FFN_PARAMS(TC)                                                    \
  const float* __restrict__ x, const TC* __restrict__ w1,                 \
      const float* __restrict__ b1, const TC* __restrict__ w2,            \
      const float* __restrict__ b2, const float* __restrict__ gamma,      \
      const float* __restrict__ beta, const float* __restrict__ drop,     \
      float* __restrict__ out, TC* __restrict__ inter, TC* __restrict__ z, \
      int R, int H, int I, float eps

// Rows [row0, row0 + TR) of the [TR, lds] fp32 scratch to out [R, H],
// rows past R left out: the partial modes' store of a ragged tile.
__device__ __forceinline__ void store_rows(const float* ss, int lds,
                                           float* __restrict__ out, int row0,
                                           int R, int H) {
  for (int e = threadIdx.x; e < TR * H; e += THREADS) {
    const int r = e / H, c = e % H;
    if (row0 + r < R) out[size_t(row0 + r) * H + c] = ss[r * lds + c];
  }
}

// bf16 compute: WMMA fragments, [TR, H] accumulator in registers.
template <Mode kMode>
__global__ void __launch_bounds__(THREADS)
ffn_block_bf16_kernel(FFN_PARAMS(bf16)) {
  constexpr bool kInter =
      kMode == Mode::kTrain || kMode == Mode::kTrainPartial;
  constexpr bool kPartial =
      kMode == Mode::kPartial || kMode == Mode::kTrainPartial;
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
    // Bias + GELU in fp32, rounded to bf16 for the second product; the
    // train forward also stores the pre-GELU chunk.
    for (int e = lane; e < 256; e += 32) {
      const int r = e / 16, cc = e % 16, c = warp * 16 + cc;
      float v = 0.0f;
      if (col < I) {
        const float u = ss[r * L.lds + c] + b1[col + cc];
        if (kInter && row0 + r < R) {
          inter[size_t(row0 + r) * I + col + cc] = __float2bfloat16(u);
        }
        v = gelu_erf(u);
      }
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

  if (kPartial && row0 + TR <= R) {  // block-uniform: a whole tile of rows
#pragma unroll
    for (int f = 0; f < MAXF; ++f) {
      const int n = warp + WARPS * f;
      if (n < ntiles) {
        wmma::store_matrix_sync(out + size_t(row0) * H + n * 16, acc[f], H,
                                wmma::mem_row_major);
      }
    }
    return;
  }
#pragma unroll
  for (int f = 0; f < MAXF; ++f) {
    const int n = warp + WARPS * f;
    if (n < ntiles) {
      wmma::store_matrix_sync(ss + n * 16, acc[f], L.lds, wmma::mem_row_major);
    }
  }
  __syncthreads();
  if constexpr (kPartial) {
    store_rows(ss, L.lds, out, row0, R, H);
  } else {
    layer_norm_epilogue<kMode == Mode::kTrain>(x, b2, drop, gamma, beta, out,
                                               z, ss, L.lds, row0, R, H, eps);
  }
}

// fp32 compute: plain FMA, [TR, H] accumulator in registers (thread t owns
// columns t, t + 256, ...).
template <Mode kMode>
__global__ void __launch_bounds__(THREADS)
ffn_block_f32_kernel(FFN_PARAMS(float)) {
  constexpr bool kInter =
      kMode == Mode::kTrain || kMode == Mode::kTrainPartial;
  constexpr bool kPartial =
      kMode == Mode::kPartial || kMode == Mode::kTrainPartial;
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
      float v = 0.0f;
      if (col < I) {
        const float uu = u[r] + b1[col];
        if (kInter && row0 + rh + r < R) {
          inter[size_t(row0 + rh + r) * I + col] = uu;
        }
        v = gelu_erf(uu);
      }
      is[(rh + r) * L.ldi + c] = v;
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
      for (int r = 0; r < TR; ++r) {
        if constexpr (kPartial) {
          if (row0 + r < R) out[size_t(row0 + r) * H + h] = acc[j][r];
        } else {
          ss[r * L.lds + h] = acc[j][r];
        }
      }
    }
  }
  if constexpr (!kPartial) {
    __syncthreads();
    layer_norm_epilogue<kMode == Mode::kTrain>(x, b2, drop, gamma, beta, out,
                                               z, ss, L.lds, row0, R, H, eps);
  }
}

template <typename TC>
int launch(void (*fn)(FFN_PARAMS(TC)), const float* x, const void* w1,
           const float* b1, const void* w2, const float* b2,
           const float* gamma, const float* beta, const float* drop,
           float* out, void* inter, void* z, int R, int H, int I, float eps,
           cudaStream_t stream) {
  const Layout L(H, sizeof(TC));
  cudaError_t err = cudaFuncSetAttribute(
      reinterpret_cast<const void*>(fn),
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(L.bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  fn<<<dim3((R + TR - 1) / TR), THREADS, L.bytes, stream>>>(
      x, static_cast<const TC*>(w1), b1, static_cast<const TC*>(w2), b2,
      gamma, beta, drop, out, static_cast<TC*>(inter), static_cast<TC*>(z),
      R, H, I, eps);
  return static_cast<int>(cudaGetLastError());
}

template <Mode kMode>
int dispatch(const float* x, const void* w1, const float* b1, const void* w2,
             const float* b2, const float* gamma, const float* beta,
             const float* drop, float* out, void* inter, void* z, int R,
             int H, int I, float eps, int compute_dtype, void* stream_ptr) {
  if (!shapes_ok(R, H, I, compute_dtype)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (compute_dtype == 1) {
    return launch<bf16>(&ffn_block_bf16_kernel<kMode>, x, w1, b1, w2, b2,
                        gamma, beta, drop, out, inter, z, R, H, I, eps,
                        stream);
  }
  return launch<float>(&ffn_block_f32_kernel<kMode>, x, w1, b1, w2, b2,
                       gamma, beta, drop, out, inter, z, R, H, I, eps,
                       stream);
}

// ---- the bf16 GEMM route: cast, two GEMMs, row pass ---------------------

// x fp32 -> bf16, round to nearest even; n4 groups of 4 values.
__global__ void __launch_bounds__(256)
ffn_cast_bf16_kernel(const float4* __restrict__ x,
                     __nv_bfloat162* __restrict__ xb, size_t n4) {
  for (size_t i = blockIdx.x * size_t(blockDim.x) + threadIdx.x; i < n4;
       i += size_t(gridDim.x) * blockDim.x) {
    const float4 v = x[i];
    xb[2 * i] = __floats2bfloat162_rn(v.x, v.y);
    xb[2 * i + 1] = __floats2bfloat162_rn(v.z, v.w);
  }
}

// GEMM 1's epilogue for B1 and B6: g = TC(GELU_erf(acc + b1)), [R, ld]
// (bf16 on the GEMM route, fp32 on the fp32 route).
template <typename TC>
struct GeluEpilogue {
  const float* b1;
  TC* g;
  int ld;
  __device__ __forceinline__ void operator()(int r, int c, float v0,
                                             float v1) const {
    const float2 b = *reinterpret_cast<const float2*>(b1 + c);
    store2(g + size_t(r) * ld + c, gelu_erf(v0 + b.x), gelu_erf(v1 + b.y));
  }
};

// GEMM 1's epilogue for B2 and B7: u = acc + b1 in fp32, stored as inter =
// TC(u) for the backward, and g = TC(GELU_erf(u)) of the unrounded u.
template <typename TC>
struct GeluInterEpilogue {
  const float* b1;
  TC* inter;
  TC* g;
  int ld;
  __device__ __forceinline__ void operator()(int r, int c, float v0,
                                             float v1) const {
    const size_t at = size_t(r) * ld + c;
    const float2 b = *reinterpret_cast<const float2*>(b1 + c);
    const float u0 = v0 + b.x, u1 = v1 + b.y;
    store2(inter + at, u0, u1);
    store2(g + at, gelu_erf(u0), gelu_erf(u1));
  }
};

// GEMM 2's epilogue for B1: y = acc + b2 + x in fp32, stored to out for
// the row pass.
struct ResidualEpilogue {
  const float* b2;
  const float* x;
  float* out;
  int ld;
  __device__ __forceinline__ void operator()(int r, int c, float v0,
                                             float v1) const {
    const size_t at = size_t(r) * ld + c;
    const float2 b = *reinterpret_cast<const float2*>(b2 + c);
    const float2 xv = *reinterpret_cast<const float2*>(x + at);
    *reinterpret_cast<float2*>(out + at) =
        make_float2(v0 + b.x + xv.x, v1 + b.y + xv.y);
  }
};

// GEMM 2's epilogue for B2: z = (acc + b2) * drop + x in fp32, stored to
// out for the row pass.
struct DropResidualEpilogue {
  const float* b2;
  const float* drop;
  const float* x;
  float* out;
  int ld;
  __device__ __forceinline__ void operator()(int r, int c, float v0,
                                             float v1) const {
    const size_t at = size_t(r) * ld + c;
    const float2 b = *reinterpret_cast<const float2*>(b2 + c);
    const float2 d = *reinterpret_cast<const float2*>(drop + at);
    const float2 xv = *reinterpret_cast<const float2*>(x + at);
    *reinterpret_cast<float2*>(out + at) =
        make_float2((v0 + b.x) * d.x + xv.x, (v1 + b.y) * d.y + xv.y);
  }
};

// LayerNorm of the rows of y [R, H] in place (fast variance, as
// layer_norm_epilogue), one warp per row, H % 128 == 0 and H <= MAX_H.
// kWriteZ (B2) also stores the rows before the norm as z [R, H] in the
// compute type TC.
template <bool kWriteZ, typename TC>
__global__ void __launch_bounds__(256)
ffn_ln_rows_kernel(float* __restrict__ y, const float* __restrict__ gamma,
                   const float* __restrict__ beta, TC* __restrict__ z,
                   int R, int H, float eps) {
  constexpr int kMaxV = MAX_H / 128;  // float4s a lane
  const int row = blockIdx.x * 8 + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= R) return;
  float4* yr = reinterpret_cast<float4*>(y + size_t(row) * H);
  const float4* g4 = reinterpret_cast<const float4*>(gamma);
  const float4* b4 = reinterpret_cast<const float4*>(beta);
  const int nv = H / 128;
  float4 v[kMaxV];
  float s = 0.0f, s2 = 0.0f;
#pragma unroll
  for (int j = 0; j < kMaxV; ++j) {
    if (j < nv) {
      v[j] = yr[j * 32 + lane];
      if constexpr (kWriteZ) {
        store4(z + size_t(row) * H + (j * 32 + lane) * 4, v[j]);
      }
      s += v[j].x + v[j].y + v[j].z + v[j].w;
      s2 += v[j].x * v[j].x + v[j].y * v[j].y + v[j].z * v[j].z +
            v[j].w * v[j].w;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, off);
    s2 += __shfl_xor_sync(0xffffffffu, s2, off);
  }
  const float mean = s / H;
  const float var = fmaxf(s2 / H - mean * mean, 0.0f);
  const float rstd = rsqrtf(var + eps);
#pragma unroll
  for (int j = 0; j < kMaxV; ++j) {
    if (j < nv) {
      const float4 g = g4[j * 32 + lane], b = b4[j * 32 + lane];
      yr[j * 32 + lane] = make_float4((v[j].x - mean) * rstd * g.x + b.x,
                                      (v[j].y - mean) * rstd * g.y + b.y,
                                      (v[j].z - mean) * rstd * g.z + b.z,
                                      (v[j].w - mean) * rstd * g.w + b.w);
    }
  }
}

// B1, B6, B2 or B7 on the GEMM route: xb [R, H] and g [R, I] are bf16
// scratch from the caller; ``tile`` an id of mmt_gemm::kTileRows.  Takes
// bf16 with H and I multiples of 128 and H <= MAX_H (the row pass), and
// every pointer its mode reads or writes non-null and 16-byte aligned,
// else cudaErrorInvalidValue.
template <Mode kMode>
int launch_route(const float* x, const void* w1, const float* b1,
                 const void* w2, const float* b2, const float* gamma,
                 const float* beta, const float* drop, float* out, void* inter,
                 void* z, void* xb, void* g, int R, int H, int I, float eps,
                 int compute_dtype, int tile, cudaStream_t stream) {
  // Writes inter (B2, B7); stops at the unreduced partial (B6, B7); takes
  // the mask and writes z (B2).
  constexpr bool kInter =
      kMode == Mode::kTrain || kMode == Mode::kTrainPartial;
  constexpr bool kPartial =
      kMode == Mode::kPartial || kMode == Mode::kTrainPartial;
  constexpr bool kTrain = kMode == Mode::kTrain;
  if (compute_dtype != 1 || H <= 0 || I <= 0 || H % mmt_gemm::BN ||
      I % mmt_gemm::BN || H > MAX_H || R <= 0 || tile < 0 ||
      tile >= mmt_gemm::kNumTiles) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const void* ptrs[] = {x,    w1,   b1,    w2,   out,  xb,   g,
                        kPartial ? x : b2,  kPartial ? x : gamma,
                        kPartial ? x : beta, kTrain ? drop : x,
                        kInter ? inter : x, kTrain ? z : x};
  for (const void* p : ptrs) {
    if (p == nullptr || !aligned16(p)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  const size_t n4 = size_t(R) * H / 4;
  const int cast_blocks = int(n4 / 256 + 1 < 1056 ? n4 / 256 + 1 : 1056);
  ffn_cast_bf16_kernel<<<cast_blocks, 256, 0, stream>>>(
      reinterpret_cast<const float4*>(x), static_cast<__nv_bfloat162*>(xb),
      n4);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  const bf16* xbb = static_cast<const bf16*>(xb);
  const bf16* w1b = static_cast<const bf16*>(w1);
  const bf16* w2b = static_cast<const bf16*>(w2);
  bf16* gb = static_cast<bf16*>(g);
  if constexpr (kInter) {
    err = mmt_gemm::tn_gemm(
        xbb, w1b, R, I, H, tile,
        GeluInterEpilogue<bf16>{b1, static_cast<bf16*>(inter), gb, I},
        stream);
  } else {
    err = mmt_gemm::tn_gemm(xbb, w1b, R, I, H, tile,
                            GeluEpilogue<bf16>{b1, gb, I}, stream);
  }
  if (err) return err;
  if constexpr (kPartial) {
    return mmt_gemm::tn_gemm(gb, w2b, R, H, I, tile,
                             mmt_gemm::PartialEpilogue{out, H}, stream);
  } else {
    if constexpr (kTrain) {
      err = mmt_gemm::tn_gemm(gb, w2b, R, H, I, tile,
                              DropResidualEpilogue{b2, drop, x, out, H},
                              stream);
    } else {
      err = mmt_gemm::tn_gemm(gb, w2b, R, H, I, tile,
                              ResidualEpilogue{b2, x, out, H}, stream);
    }
    if (err) return err;
    ffn_ln_rows_kernel<kTrain, bf16><<<(R + 7) / 8, 256, 0, stream>>>(
        out, gamma, beta, static_cast<bf16*>(z), R, H, eps);
    return static_cast<int>(cudaGetLastError());
  }
}

// B1, B6, B2 or B7 on the fp32 route: the same two products and row pass
// as launch_route, in fp32 through ffn_sgemm.cuh, with no cast pass (x is
// fp32 already); g [R, I] is fp32 scratch from the caller and ``tile`` an
// id of mmt_sgemm::kTileRows.  Takes fp32 with H and I multiples of 128
// and H <= MAX_H, and every pointer its mode reads or writes non-null and
// 16-byte aligned, else cudaErrorInvalidValue.
template <Mode kMode>
int launch_f32_route(const float* x, const float* w1, const float* b1,
                     const float* w2, const float* b2, const float* gamma,
                     const float* beta, const float* drop, float* out,
                     float* inter, float* z, float* g, int R, int H, int I,
                     float eps, int compute_dtype, int tile,
                     cudaStream_t stream) {
  constexpr bool kInter =
      kMode == Mode::kTrain || kMode == Mode::kTrainPartial;
  constexpr bool kPartial =
      kMode == Mode::kPartial || kMode == Mode::kTrainPartial;
  constexpr bool kTrain = kMode == Mode::kTrain;
  if (compute_dtype != 0 || H <= 0 || I <= 0 || H % mmt_sgemm::BN ||
      I % mmt_sgemm::BN || H > MAX_H || R <= 0 || tile < 0 ||
      tile >= mmt_sgemm::kNumTiles) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const void* ptrs[] = {x,    w1,   b1,    w2,   out,  g,
                        kPartial ? x : b2,  kPartial ? x : gamma,
                        kPartial ? x : beta, kTrain ? drop : x,
                        kInter ? inter : x, kTrain ? z : x};
  for (const void* p : ptrs) {
    if (p == nullptr || !aligned16(p)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  int err;
  if constexpr (kInter) {
    err = mmt_sgemm::sgemm<true>(x, w1, R, I, H, tile,
                                 GeluInterEpilogue<float>{b1, inter, g, I},
                                 stream);
  } else {
    err = mmt_sgemm::sgemm<true>(x, w1, R, I, H, tile,
                                 GeluEpilogue<float>{b1, g, I}, stream);
  }
  if (err) return err;
  if constexpr (kPartial) {
    return mmt_sgemm::sgemm<true>(g, w2, R, H, I, tile,
                                  mmt_gemm::PartialEpilogue{out, H}, stream);
  } else {
    if constexpr (kTrain) {
      err = mmt_sgemm::sgemm<true>(g, w2, R, H, I, tile,
                                   DropResidualEpilogue{b2, drop, x, out, H},
                                   stream);
    } else {
      err = mmt_sgemm::sgemm<true>(g, w2, R, H, I, tile,
                                   ResidualEpilogue{b2, x, out, H}, stream);
    }
    if (err) return err;
    ffn_ln_rows_kernel<kTrain, float><<<(R + 7) / 8, 256, 0, stream>>>(
        out, gamma, beta, z, R, H, eps);
    return static_cast<int>(cudaGetLastError());
  }
}

// The route of ``tile`` >= 0 by compute type: the fp32 route (g fp32
// [R, I], xb unused) or the bf16 GEMM route (xb, g bf16); each refuses a
// shape or type it does not take.
template <Mode kMode>
int launch_routes(const float* x, const void* w1, const float* b1,
                  const void* w2, const float* b2, const float* gamma,
                  const float* beta, const float* drop, float* out,
                  void* inter, void* z, void* xb, void* g, int R, int H,
                  int I, float eps, int compute_dtype, int tile,
                  cudaStream_t stream) {
  if (compute_dtype == 0) {
    return launch_f32_route<kMode>(
        x, static_cast<const float*>(w1), b1, static_cast<const float*>(w2),
        b2, gamma, beta, drop, out, static_cast<float*>(inter),
        static_cast<float*>(z), static_cast<float*>(g), R, H, I, eps,
        compute_dtype, tile, stream);
  }
  return launch_route<kMode>(x, w1, b1, w2, b2, gamma, beta, drop, out, inter,
                             z, xb, g, R, H, I, eps, compute_dtype, tile,
                             stream);
}

}  // namespace

// compute_dtype (shared with mmt_tpu_torch/ops/ffn.py): 0 = float32,
// 1 = bfloat16.  x, biases, gamma, beta and out are float32.  ``tile`` >= 0
// takes the route of the compute type with that block tile (an unknown
// id, or a shape the route does not take, is refused): in bf16 the GEMM
// route, xb [R, H] and g [R, I] bf16 scratch; in fp32 the fp32 route, g
// [R, I] fp32 scratch and xb unused.  -1 the WMMA or FMA kernel, xb and g
// unused.
extern "C" int mmt_ffn_block(const float* x, const void* w1, const float* b1,
                             const void* w2, const float* b2,
                             const float* gamma, const float* beta, float* out,
                             void* xb, void* g, int R, int H, int I, float eps,
                             int compute_dtype, int tile, void* stream_ptr) {
  if (tile >= 0) {
    return launch_routes<Mode::kEval>(x, w1, b1, w2, b2, gamma, beta,
                                      nullptr, out, nullptr, nullptr, xb, g,
                                      R, H, I, eps, compute_dtype, tile,
                                      static_cast<cudaStream_t>(stream_ptr));
  }
  if (tile != -1) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch<Mode::kEval>(x, w1, b1, w2, b2, gamma, beta, nullptr, out,
                         nullptr, nullptr, R, H, I, eps, compute_dtype,
                         stream_ptr);
}

// Train forward (B2): as mmt_ffn_block, plus the float32 mask drop [R, H]
// and the compute-type outputs inter [R, I] and z [R, H].
extern "C" int mmt_ffn_train_fwd(const float* x, const float* drop,
                                 const void* w1, const float* b1,
                                 const void* w2, const float* b2,
                                 const float* gamma, const float* beta,
                                 float* out, void* inter, void* z, void* xb,
                                 void* g, int R, int H, int I, float eps,
                                 int compute_dtype, int tile,
                                 void* stream_ptr) {
  if (tile >= 0) {
    return launch_routes<Mode::kTrain>(x, w1, b1, w2, b2, gamma, beta, drop,
                                       out, inter, z, xb, g, R, H, I, eps,
                                       compute_dtype, tile,
                                       static_cast<cudaStream_t>(stream_ptr));
  }
  if (tile != -1) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch<Mode::kTrain>(x, w1, b1, w2, b2, gamma, beta, drop, out,
                               inter, z, R, H, I, eps, compute_dtype,
                               stream_ptr);
}

// Tensor-parallel partial (B6): x [R, H] float32, the shards w1 [I, H]
// and w2 [H, I] in the compute type (I is the rank's I/mp), b1 [I]
// float32; writes the unreduced float32 partial out [R, H].  xb, g and
// tile as for mmt_ffn_block.
extern "C" int mmt_ffn_partial(const float* x, const void* w1,
                               const float* b1, const void* w2, float* out,
                               void* xb, void* g, int R, int H, int I,
                               int compute_dtype, int tile, void* stream_ptr) {
  if (tile >= 0) {
    return launch_routes<Mode::kPartial>(
        x, w1, b1, w2, nullptr, nullptr, nullptr, nullptr, out, nullptr,
        nullptr, xb, g, R, H, I, 0.0f, compute_dtype, tile,
        static_cast<cudaStream_t>(stream_ptr));
  }
  if (tile != -1) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch<Mode::kPartial>(x, w1, b1, w2, nullptr, nullptr, nullptr,
                                  nullptr, out, nullptr, nullptr, R, H, I,
                                  0.0f, compute_dtype, stream_ptr);
}

// Tensor-parallel train partial (B7): as mmt_ffn_partial, plus inter
// [R, I] in the compute type.
extern "C" int mmt_ffn_train_fwd_partial(const float* x, const void* w1,
                                         const float* b1, const void* w2,
                                         float* out, void* inter, void* xb,
                                         void* g, int R, int H, int I,
                                         int compute_dtype, int tile,
                                         void* stream_ptr) {
  if (tile >= 0) {
    return launch_routes<Mode::kTrainPartial>(
        x, w1, b1, w2, nullptr, nullptr, nullptr, nullptr, out, inter,
        nullptr, xb, g, R, H, I, 0.0f, compute_dtype, tile,
        static_cast<cudaStream_t>(stream_ptr));
  }
  if (tile != -1) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch<Mode::kTrainPartial>(x, w1, b1, w2, nullptr, nullptr,
                                       nullptr, nullptr, out, inter, nullptr,
                                       R, H, I, 0.0f, compute_dtype,
                                       stream_ptr);
}

extern "C" const char* mmt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
