// Fused backward of the train-time FFN sub-block for Hopper (sm_90a) (B3):
//
//   dz     = LayerNorm backward of dy at z (fast variance, fp32)
//   dffn   = dz * drop                       (rounded to the compute type)
//   dinter = (dffn W2) * (Phi(u) + u phi(u)) at u = inter
//   dx     = dinter W1 (+ dz when add_dz)
//
// Replaces the TPU kernel mmt_tpu/ops/ffn.py:_ffn_train_bwd_kernel
// (launched by _pallas_ffn_train_bwd through ffn_block_train's backward).
// Same numerics: the LN backward runs in fp32 on the compute-type z that
// the forward stored; dz is written in the compute type, while dffn is the
// unrounded fp32 dz times the mask, rounded once for the product; the
// GELU derivative uses the exact erff and expf on the stored compute-type
// inter (the TPU kernel's A&S erf exists only because Mosaic has no erf);
// dinter is rounded to the compute type, stored, and fed to the second
// product; both products accumulate in fp32; the epilogue adds the fp32
// dz (add_dz = 0 leaves dx a tensor-parallel partial, as the TPU kernel's
// flag does).  The weight gradients are not here: they are plain GEMMs
// with K = R in mmt_tpu_torch/ops/ffn.py, as they were XLA on the TPU.
//
// What bounds it on the H100: the same two products as the forward (4 R H
// I flops: 44 GFLOP at the b32 video shape, 6,976 x 512 with I = 3072),
// plus reading inter and writing dinter ([R, I] in the compute type, 43 MB
// each at that shape).  As in the forward, one block owns TR = 16 rows and
// walks I in chunks of 128: the chunk of dinter is made in shared memory
// and consumed at once, and dx accumulates over the chunks in WMMA
// register fragments; every block streams both weight matrices from L2,
// which bounds this first version.  The text tower at b32 gives only 60
// blocks (960 rows) for 132 SMs.
//
// Layout: weights in nn.Linear's layout, w1 [I, H] and w2 [H, I].  Both
// products here read their weight operand with N contiguous (dffn W2:
// K = H, N = I; dinter W1: K = I, N = H), so the WMMA B fragments are
// row_major, where the forward's are col_major.  bf16 compute uses WMMA
// 16x16x16 bf16 fragments; fp32 compute uses plain FMA (no TF32).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstddef>

#include "ffn_common.cuh"

namespace {

using namespace mmt_ffn;
using namespace nvcuda;

// Shared memory: dz [TR, H + 4] fp32 (for the epilogue), dffn
// [TR, H + PAD] and the dinter chunk [TR, IC + PAD] in the compute type,
// and an fp32 chunk scratch [TR, IC + 4].
struct BwdLayout {
  int ldz, ldf, ldd, ldc;
  size_t dz_bytes, f_bytes, d_bytes, bytes;
  __host__ __device__ BwdLayout(int h, size_t tc_size) {
    ldz = h + 4;
    ldf = h + PAD;
    ldd = IC + PAD;
    ldc = IC + 4;
    dz_bytes = size_t(TR) * ldz * sizeof(float);
    f_bytes = size_t(TR) * ldf * tc_size;
    d_bytes = size_t(TR) * ldd * tc_size;
    bytes = dz_bytes + f_bytes + d_bytes + size_t(TR) * ldc * sizeof(float);
  }
};

// Kernel parameters (TC: the compute type).
#define BWD_PARAMS(TC)                                                     \
  const float* __restrict__ dy, const TC* __restrict__ z,                  \
      const TC* __restrict__ inter, const float* __restrict__ drop,        \
      const TC* __restrict__ w1, const TC* __restrict__ w2,                \
      const float* __restrict__ gamma, float* __restrict__ dx,             \
      TC* __restrict__ dz, TC* __restrict__ dinter, int R, int H, int I,   \
      float eps, int add_dz

// LayerNorm backward, one warp per row: writes dz (fp32 to dzs, compute
// type to HBM) and dffn = dz * drop (compute type) to dfs.  Rows past R
// are zero in both.
template <typename TC>
__device__ __forceinline__ void ln_backward(
    const float* __restrict__ dy, const TC* __restrict__ z,
    const float* __restrict__ drop, const float* __restrict__ gamma,
    TC* __restrict__ dz, float* dzs, TC* dfs, const BwdLayout& L, int row0,
    int R, int H, float eps) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < TR; r += WARPS) {
    const int gr = row0 + r;
    if (gr >= R) {  // warp-uniform
      for (int c = lane; c < H; c += 32) {
        dzs[r * L.ldz + c] = 0.0f;
        dfs[r * L.ldf + c] = from_float<TC>(0.0f);
      }
      continue;
    }
    const size_t base = size_t(gr) * H;
    float s = 0.0f, s2 = 0.0f;
    for (int c = lane; c < H; c += 32) {
      const float zz = to_float(z[base + c]);
      s += zz;
      s2 += zz * zz;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, off);
      s2 += __shfl_xor_sync(0xffffffffu, s2, off);
    }
    const float mean = s / H;
    const float var = fmaxf(s2 / H - mean * mean, 0.0f);
    const float rstd = rsqrtf(var + eps);
    float sg = 0.0f, sgz = 0.0f;  // sums of dy*gamma and dy*gamma*zhat
    for (int c = lane; c < H; c += 32) {
      const float zhat = (to_float(z[base + c]) - mean) * rstd;
      const float dyg = dy[base + c] * gamma[c];
      sg += dyg;
      sgz += dyg * zhat;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      sg += __shfl_xor_sync(0xffffffffu, sg, off);
      sgz += __shfl_xor_sync(0xffffffffu, sgz, off);
    }
    const float mg = sg / H, mgz = sgz / H;
    for (int c = lane; c < H; c += 32) {
      const float zhat = (to_float(z[base + c]) - mean) * rstd;
      const float dyg = dy[base + c] * gamma[c];
      const float d = rstd * (dyg - mg - zhat * mgz);
      dzs[r * L.ldz + c] = d;
      dz[base + c] = from_float<TC>(d);
      dfs[r * L.ldf + c] = from_float<TC>(d * drop[base + c]);
    }
  }
}

// dinter of one element of the chunk from the first product's value g:
// stored to HBM (compute type) and returned rounded, for the second
// product.  Rows past R give 0 and store nothing.
template <typename TC>
__device__ __forceinline__ TC dinter_at(const TC* __restrict__ inter,
                                        TC* __restrict__ dinter, float g,
                                        int gr, int col, int R, int I) {
  if (gr >= R) return from_float<TC>(0.0f);
  const size_t at = size_t(gr) * I + col;
  const TC d = from_float<TC>(g * gelu_erf_grad(to_float(inter[at])));
  dinter[at] = d;
  return d;
}

__global__ void __launch_bounds__(THREADS)
ffn_train_bwd_bf16_kernel(BWD_PARAMS(bf16)) {
  extern __shared__ __align__(128) unsigned char smem[];
  const BwdLayout L(H, sizeof(bf16));
  float* dzs = reinterpret_cast<float*>(smem);
  bf16* dfs = reinterpret_cast<bf16*>(smem + L.dz_bytes);
  bf16* ds = reinterpret_cast<bf16*>(smem + L.dz_bytes + L.f_bytes);
  float* cs = reinterpret_cast<float*>(smem + L.dz_bytes + L.f_bytes +
                                       L.d_bytes);
  const int row0 = blockIdx.x * TR;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ntiles = H / 16;

  ln_backward(dy, z, drop, gamma, dz, dzs, dfs, L, row0, R, H, eps);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[MAXF];
#pragma unroll
  for (int f = 0; f < MAXF; ++f) wmma::fill_fragment(acc[f], 0.0f);
  __syncthreads();

  for (int c0 = 0; c0 < I; c0 += IC) {
    // First product: this warp's 16 columns of dffn W2 (K = H).
    const int col = c0 + warp * 16;
    if (col < I) {  // warp-uniform
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> g;
      wmma::fill_fragment(g, 0.0f);
      for (int k = 0; k < H; k += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(a, dfs + k, L.ldf);
        wmma::load_matrix_sync(b, w2 + size_t(k) * I + col, I);
        wmma::mma_sync(g, a, b, g);
      }
      wmma::store_matrix_sync(cs + warp * 16, g, L.ldc, wmma::mem_row_major);
    }
    __syncwarp();
    for (int e = lane; e < 256; e += 32) {
      const int r = e / 16, cc = e % 16, c = warp * 16 + cc;
      ds[r * L.ldd + c] =
          (col < I) ? dinter_at(inter, dinter, cs[r * L.ldc + c], row0 + r,
                                col + cc, R, I)
                    : __float2bfloat16(0.0f);
    }
    __syncthreads();
    // Second product: acc[f] (dx tile n) += dinter chunk x W1[chunk, n].
    const int kmax = min(IC, I - c0);
#pragma unroll
    for (int f = 0; f < MAXF; ++f) {
      const int n = warp + WARPS * f;
      if (n < ntiles) {  // warp-uniform
        for (int k = 0; k < kmax; k += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
          wmma::load_matrix_sync(a, ds + k, L.ldd);
          wmma::load_matrix_sync(b, w1 + size_t(c0 + k) * H + n * 16, H);
          wmma::mma_sync(acc[f], a, b, acc[f]);
        }
      }
    }
    __syncthreads();  // ds and cs are rewritten by the next chunk
  }

  // Epilogue: each warp stages its tiles through its own 16 columns of cs.
#pragma unroll
  for (int f = 0; f < MAXF; ++f) {
    const int n = warp + WARPS * f;
    if (n < ntiles) {
      wmma::store_matrix_sync(cs + warp * 16, acc[f], L.ldc,
                              wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int r = e / 16, cc = e % 16, h = n * 16 + cc;
        if (row0 + r < R) {
          float v = cs[r * L.ldc + warp * 16 + cc];
          if (add_dz) v += dzs[r * L.ldz + h];
          dx[size_t(row0 + r) * H + h] = v;
        }
      }
      __syncwarp();
    }
  }
}

// fp32 compute: plain FMA, [TR, H] dx accumulator in registers (thread t
// owns columns t, t + 256, ...).
__global__ void __launch_bounds__(THREADS)
ffn_train_bwd_f32_kernel(BWD_PARAMS(float)) {
  extern __shared__ __align__(128) unsigned char smem[];
  const BwdLayout L(H, sizeof(float));
  float* dzs = reinterpret_cast<float*>(smem);
  float* dfs = reinterpret_cast<float*>(smem + L.dz_bytes);
  float* ds = reinterpret_cast<float*>(smem + L.dz_bytes + L.f_bytes);
  const int row0 = blockIdx.x * TR;
  const int t = threadIdx.x;

  ln_backward(dy, z, drop, gamma, dz, dzs, dfs, L, row0, R, H, eps);
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
    float g[RH];
#pragma unroll
    for (int r = 0; r < RH; ++r) g[r] = 0.0f;
    if (col < I) {
      for (int k = 0; k < H; ++k) {
        const float w = w2[size_t(k) * I + col];
#pragma unroll
        for (int r = 0; r < RH; ++r) g[r] = fmaf(dfs[(rh + r) * L.ldf + k], w, g[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < RH; ++r) {
      ds[(rh + r) * L.ldd + c] =
          (col < I) ? dinter_at(inter, dinter, g[r], row0 + rh + r, col, R, I)
                    : 0.0f;
    }
    __syncthreads();
    const int kmax = min(IC, I - c0);
#pragma unroll
    for (int j = 0; j < MAXJ; ++j) {
      const int h = t + THREADS * j;
      if (h < H) {
        for (int k = 0; k < kmax; ++k) {
          const float w = w1[size_t(c0 + k) * H + h];
#pragma unroll
          for (int r = 0; r < TR; ++r) acc[j][r] = fmaf(ds[r * L.ldd + k], w, acc[j][r]);
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
        if (row0 + r < R) {
          dx[size_t(row0 + r) * H + h] =
              add_dz ? acc[j][r] + dzs[r * L.ldz + h] : acc[j][r];
        }
      }
    }
  }
}

template <typename TC>
int launch(void (*fn)(BWD_PARAMS(TC)), const float* dy, const void* z,
           const void* inter, const float* drop, const void* w1,
           const void* w2, const float* gamma, float* dx, void* dz,
           void* dinter, int R, int H, int I, float eps, int add_dz,
           cudaStream_t stream) {
  const BwdLayout L(H, sizeof(TC));
  cudaError_t err = cudaFuncSetAttribute(
      reinterpret_cast<const void*>(fn),
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(L.bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  fn<<<dim3((R + TR - 1) / TR), THREADS, L.bytes, stream>>>(
      dy, static_cast<const TC*>(z), static_cast<const TC*>(inter), drop,
      static_cast<const TC*>(w1), static_cast<const TC*>(w2), gamma, dx,
      static_cast<TC*>(dz), static_cast<TC*>(dinter), R, H, I, eps, add_dz);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// compute_dtype (shared with mmt_tpu_torch/ops/ffn.py): 0 = float32,
// 1 = bfloat16.  dy, drop, gamma and dx are float32; z, inter, w1, w2, dz
// and dinter are in the compute type.
extern "C" int mmt_ffn_train_bwd(const float* dy, const void* z,
                                 const void* inter, const float* drop,
                                 const void* w1, const void* w2,
                                 const float* gamma, float* dx, void* dz,
                                 void* dinter, int R, int H, int I, float eps,
                                 int compute_dtype, int add_dz,
                                 void* stream_ptr) {
  if (!shapes_ok(R, H, I, compute_dtype)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (compute_dtype == 1) {
    return launch<bf16>(&ffn_train_bwd_bf16_kernel, dy, z, inter, drop, w1,
                        w2, gamma, dx, dz, dinter, R, H, I, eps, add_dz,
                        stream);
  }
  return launch<float>(&ffn_train_bwd_f32_kernel, dy, z, inter, drop, w1, w2,
                       gamma, dx, dz, dinter, R, H, I, eps, add_dz, stream);
}
