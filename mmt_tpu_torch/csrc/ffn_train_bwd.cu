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
// which bounds this WMMA kernel.  The text tower at b32 gives it only 60
// blocks (960 rows) for 132 SMs.
//
// Layout: weights in nn.Linear's layout, w1 [I, H] and w2 [H, I].  Both
// products here read their weight operand with N contiguous (dffn W2:
// K = H, N = I; dinter W1: K = I, N = H), so the WMMA B fragments are
// row_major, where the forward's are col_major.  bf16 compute uses WMMA
// 16x16x16 bf16 fragments; fp32 compute uses plain FMA (no TF32).
//
// In bf16 with H and I multiples of 128 (every configuration under
// configs/eccv20/) B3 takes the GEMM route of ffn_gemm.cuh instead, in
// four launches with the same rounding points:
//
//   w1t = W1^T [H, I], w2t = W2^T [I, H]    one transpose launch
//   dz, dffn = bf16(dz * drop), dx = dz     LayerNorm-backward row pass
//   dinter = bf16((dffn w2t^T) * gelu'(inter))   GEMM A, K = H
//   dx = dinter w1t^T + dx                  GEMM B, K = I
//
// The TN template reads B as [N, K] with K contiguous, so the weights are
// transposed into scratch once per call (3 MB each in bf16 at the
// flagship widths) rather than giving the template a second B layout.
// GEMM B with add_dz = 0 stores the product alone (the partial).  dinter
// goes through device memory as an output already, so the split costs
// only dffn ([R, H] bf16) and dx's fp32 round trip.  The weights are read
// from L2 once per 128 (or 64) rows instead of once per 16, and the text
// shape (960 rows) gives 90 blocks of 64 rows in GEMM B and 360 in GEMM
// A, against the WMMA kernel's 60.
//
// In fp32 at the same widths B3 takes the fp32 route in three launches:
// the same row pass (dz and dffn in fp32), then GEMM A and GEMM B through
// the SIMT GEMM of ffn_sgemm.cuh (exact fmaf, no TF32), which stages the
// weights k-major in shared memory itself and so reads W2 [H, I] and W1
// [I, H] as stored: no transposed copies.  What bounds it: 4 R H I FLOP
// at the 67 TFLOP/s of fp32 FMA (0.66 ms at the b32 video shape), plus
// inter read and dinter written in fp32 (86 MB each there, ~0.05 ms).
// The ids of ffn_sgemm.cuh's row tiles (128, 64, 32) give the text
// shape's GEMM B 180 blocks of 32 rows.

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

// ---- the bf16 GEMM route: transposes, row pass, two GEMMs ---------------

// w1 [I, H] -> w1t [H, I] (blockIdx.z 0) and w2 [H, I] -> w2t [I, H]
// (blockIdx.z 1) in one launch, as raw 16-bit words, a 32 x 32 tile a
// block through shared memory (row stride 34: 17 words, so a column read
// hits 32 banks).  H and I multiples of 32; blockIdx.x walks the (H / 32)
// (I / 32) tiles.
__global__ void __launch_bounds__(256)
ffn_transpose_bf16_kernel(const uint16_t* __restrict__ w1,
                          const uint16_t* __restrict__ w2,
                          uint16_t* __restrict__ w1t,
                          uint16_t* __restrict__ w2t, int H, int I) {
  __shared__ uint16_t tile[32][34];
  const bool second = blockIdx.z == 1;
  const uint16_t* src = second ? w2 : w1;
  uint16_t* dst = second ? w2t : w1t;
  const int rows = second ? H : I, cols = second ? I : H;  // src [rows, cols]
  const int tiles_c = cols / 32;
  const int r0 = (blockIdx.x / tiles_c) * 32, c0 = (blockIdx.x % tiles_c) * 32;
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  for (int k = ty; k < 32; k += 8) {
    tile[k][tx] = src[size_t(r0 + k) * cols + c0 + tx];
  }
  __syncthreads();
  for (int k = ty; k < 32; k += 8) {
    dst[size_t(c0 + k) * rows + r0 + tx] = tile[tx][k];
  }
}

// LayerNorm backward of dy at z, one warp per row, with ln_backward's
// arithmetic (fast variance, fp32): stores dz and dffn = dz * drop in the
// compute type TC, both rounded from the unrounded fp32 dz, and that fp32
// dz to dx unless dx is null.  H % 128 == 0 and H <= MAX_H.
template <typename TC>
__global__ void __launch_bounds__(256)
ffn_ln_bwd_rows_kernel(const float* __restrict__ dy, const TC* __restrict__ z,
                       const float* __restrict__ drop,
                       const float* __restrict__ gamma, TC* __restrict__ dz,
                       TC* __restrict__ dffn, float* __restrict__ dx, int R,
                       int H, float eps) {
  constexpr int kMaxV = MAX_H / 128;  // groups of 4 columns a lane
  const int row = blockIdx.x * 8 + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= R) return;
  const size_t base = size_t(row) * H;
  const int nv = H / 128;
  float4 zh[kMaxV], dg[kMaxV];  // z, then zhat; dy * gamma
  float s = 0.0f, s2 = 0.0f;
#pragma unroll
  for (int j = 0; j < kMaxV; ++j) {
    if (j < nv) {
      const float4 v = load4(z + base + (j * 32 + lane) * 4);
      zh[j] = v;
      s += v.x + v.y + v.z + v.w;
      s2 += v.x * v.x + v.y * v.y + v.z * v.z + v.w * v.w;
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
  float sg = 0.0f, sgz = 0.0f;  // sums of dy*gamma and dy*gamma*zhat
#pragma unroll
  for (int j = 0; j < kMaxV; ++j) {
    if (j < nv) {
      const int c = (j * 32 + lane) * 4;
      const float4 d = *reinterpret_cast<const float4*>(dy + base + c);
      const float4 g = *reinterpret_cast<const float4*>(gamma + c);
      dg[j] = make_float4(d.x * g.x, d.y * g.y, d.z * g.z, d.w * g.w);
      zh[j] = make_float4((zh[j].x - mean) * rstd, (zh[j].y - mean) * rstd,
                          (zh[j].z - mean) * rstd, (zh[j].w - mean) * rstd);
      sg += dg[j].x + dg[j].y + dg[j].z + dg[j].w;
      sgz += dg[j].x * zh[j].x + dg[j].y * zh[j].y + dg[j].z * zh[j].z +
             dg[j].w * zh[j].w;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    sg += __shfl_xor_sync(0xffffffffu, sg, off);
    sgz += __shfl_xor_sync(0xffffffffu, sgz, off);
  }
  const float mg = sg / H, mgz = sgz / H;
#pragma unroll
  for (int j = 0; j < kMaxV; ++j) {
    if (j < nv) {
      const int c = (j * 32 + lane) * 4;
      const float4 d = make_float4(rstd * (dg[j].x - mg - zh[j].x * mgz),
                                   rstd * (dg[j].y - mg - zh[j].y * mgz),
                                   rstd * (dg[j].z - mg - zh[j].z * mgz),
                                   rstd * (dg[j].w - mg - zh[j].w * mgz));
      const float4 m = *reinterpret_cast<const float4*>(drop + base + c);
      store4(dz + base + c, d);
      store4(dffn + base + c,
             make_float4(d.x * m.x, d.y * m.y, d.z * m.z, d.w * m.w));
      if (dx != nullptr) *reinterpret_cast<float4*>(dx + base + c) = d;
    }
  }
}

// GEMM A's epilogue: dinter = TC(acc * (Phi(u) + u phi(u))) at
// u = inter, [R, ld]; stored, and GEMM B's A operand (bf16 on the GEMM
// route, fp32 on the fp32 route).
template <typename TC>
struct DgeluEpilogue {
  const TC* inter;
  TC* dinter;
  int ld;
  __device__ __forceinline__ void operator()(int r, int c, float v0,
                                             float v1) const {
    const size_t at = size_t(r) * ld + c;
    const float2 u = load2(inter + at);
    store2(dinter + at, v0 * gelu_erf_grad(u.x), v1 * gelu_erf_grad(u.y));
  }
};

// GEMM B's epilogue with add_dz: dx = acc + dx, where dx holds the fp32
// dz of the row pass.
struct AccumulateEpilogue {
  float* out;
  int ld;
  __device__ __forceinline__ void operator()(int r, int c, float v0,
                                             float v1) const {
    float2* p = reinterpret_cast<float2*>(out + size_t(r) * ld + c);
    const float2 d = *p;
    *p = make_float2(v0 + d.x, v1 + d.y);
  }
};

// B3 on the GEMM route: dffn [R, H], w1t [H, I] and w2t [I, H] are bf16
// scratch from the caller; ``tile`` an id of mmt_gemm::kTileRows.  Takes
// bf16 with H and I multiples of 128 and H <= MAX_H (the row pass), and
// every pointer non-null and 16-byte aligned, else cudaErrorInvalidValue.
int launch_bwd_route(const float* dy, const void* z, const void* inter,
                     const float* drop, const void* w1, const void* w2,
                     const float* gamma, float* dx, void* dz, void* dinter,
                     void* dffn, void* w1t, void* w2t, int R, int H, int I,
                     float eps, int compute_dtype, int add_dz, int tile,
                     cudaStream_t stream) {
  if (compute_dtype != 1 || H <= 0 || I <= 0 || H % mmt_gemm::BN ||
      I % mmt_gemm::BN || H > MAX_H || R <= 0 || tile < 0 ||
      tile >= mmt_gemm::kNumTiles) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const void* ptrs[] = {dy, z,  inter,  drop, w1,   w2,  gamma,
                        dx, dz, dinter, dffn, w1t, w2t};
  for (const void* p : ptrs) {
    if (p == nullptr || !aligned16(p)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  bf16* w1tb = static_cast<bf16*>(w1t);
  bf16* w2tb = static_cast<bf16*>(w2t);
  bf16* dinterb = static_cast<bf16*>(dinter);
  ffn_transpose_bf16_kernel<<<dim3((H / 32) * (I / 32), 1, 2), 256, 0,
                              stream>>>(
      static_cast<const uint16_t*>(w1), static_cast<const uint16_t*>(w2),
      static_cast<uint16_t*>(w1t), static_cast<uint16_t*>(w2t), H, I);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  ffn_ln_bwd_rows_kernel<bf16><<<(R + 7) / 8, 256, 0, stream>>>(
      dy, static_cast<const bf16*>(z), drop, gamma, static_cast<bf16*>(dz),
      static_cast<bf16*>(dffn), add_dz ? dx : nullptr, R, H, eps);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  err = mmt_gemm::tn_gemm(static_cast<const bf16*>(dffn), w2tb, R, I, H,
                          tile,
                          DgeluEpilogue<bf16>{static_cast<const bf16*>(inter),
                                              dinterb, I},
                          stream);
  if (err) return err;
  if (add_dz) {
    return mmt_gemm::tn_gemm(dinterb, w1tb, R, H, I, tile,
                             AccumulateEpilogue{dx, H}, stream);
  }
  return mmt_gemm::tn_gemm(dinterb, w1tb, R, H, I, tile,
                           mmt_gemm::PartialEpilogue{dx, H}, stream);
}

// B3 on the fp32 route: the row pass and the two products of
// launch_bwd_route in fp32 through ffn_sgemm.cuh, which reads W2 [H, I]
// and W1 [I, H] as stored (N contiguous: no transposed copies); dffn
// [R, H] is fp32 scratch from the caller, ``tile`` an id of
// mmt_sgemm::kTileRows.  Takes fp32 with H and I multiples of 128 and
// H <= MAX_H, and every pointer non-null and 16-byte aligned, else
// cudaErrorInvalidValue.
int launch_bwd_f32_route(const float* dy, const float* z, const float* inter,
                         const float* drop, const float* w1, const float* w2,
                         const float* gamma, float* dx, float* dz,
                         float* dinter, float* dffn, int R, int H, int I,
                         float eps, int compute_dtype, int add_dz, int tile,
                         cudaStream_t stream) {
  if (compute_dtype != 0 || H <= 0 || I <= 0 || H % mmt_sgemm::BN ||
      I % mmt_sgemm::BN || H > MAX_H || R <= 0 || tile < 0 ||
      tile >= mmt_sgemm::kNumTiles) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const void* ptrs[] = {dy, z,  inter,  drop, w1,  w2,
                        gamma, dx, dz, dinter, dffn};
  for (const void* p : ptrs) {
    if (p == nullptr || !aligned16(p)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  ffn_ln_bwd_rows_kernel<float><<<(R + 7) / 8, 256, 0, stream>>>(
      dy, z, drop, gamma, dz, dffn, add_dz ? dx : nullptr, R, H, eps);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  err = mmt_sgemm::sgemm<false>(dffn, w2, R, I, H, tile,
                                DgeluEpilogue<float>{inter, dinter, I},
                                stream);
  if (err) return err;
  if (add_dz) {
    return mmt_sgemm::sgemm<false>(dinter, w1, R, H, I, tile,
                                   AccumulateEpilogue{dx, H}, stream);
  }
  return mmt_sgemm::sgemm<false>(dinter, w1, R, H, I, tile,
                                 mmt_gemm::PartialEpilogue{dx, H}, stream);
}

}  // namespace

// compute_dtype (shared with mmt_tpu_torch/ops/ffn.py): 0 = float32,
// 1 = bfloat16.  dy, drop, gamma and dx are float32; z, inter, w1, w2, dz
// and dinter are in the compute type.  ``tile`` >= 0 takes the route of
// the compute type with that block tile (an unknown id, or a shape the
// route does not take, is refused): in bf16 the GEMM route, dffn [R, H],
// w1t [H, I] and w2t [I, H] bf16 scratch; in fp32 the fp32 route, dffn
// [R, H] fp32 scratch, w1t and w2t unused.  -1 the WMMA or FMA kernel, the
// scratch unused.
extern "C" int mmt_ffn_train_bwd(const float* dy, const void* z,
                                 const void* inter, const float* drop,
                                 const void* w1, const void* w2,
                                 const float* gamma, float* dx, void* dz,
                                 void* dinter, void* dffn, void* w1t,
                                 void* w2t, int R, int H, int I, float eps,
                                 int compute_dtype, int add_dz, int tile,
                                 void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (tile >= 0 && compute_dtype == 0) {
    return launch_bwd_f32_route(
        dy, static_cast<const float*>(z), static_cast<const float*>(inter),
        drop, static_cast<const float*>(w1), static_cast<const float*>(w2),
        gamma, dx, static_cast<float*>(dz), static_cast<float*>(dinter),
        static_cast<float*>(dffn), R, H, I, eps, compute_dtype, add_dz, tile,
        stream);
  }
  if (tile >= 0) {
    return launch_bwd_route(dy, z, inter, drop, w1, w2, gamma, dx, dz, dinter,
                            dffn, w1t, w2t, R, H, I, eps, compute_dtype, add_dz,
                            tile, stream);
  }
  if (tile != -1 || !shapes_ok(R, H, I, compute_dtype)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (compute_dtype == 1) {
    return launch<bf16>(&ffn_train_bwd_bf16_kernel, dy, z, inter, drop, w1,
                        w2, gamma, dx, dz, dinter, R, H, I, eps, add_dz,
                        stream);
  }
  return launch<float>(&ffn_train_bwd_f32_kernel, dy, z, inter, drop, w1, w2,
                       gamma, dx, dz, dinter, R, H, I, eps, add_dz, stream);
}
