// Grouped fp32 expert GEMMs of a routed SwiGLU mixture-of-experts layer
// (the Moonlight / DeepSeek-V3 block of models/moe_text.py), on the SIMT
// tiles of ffn_sgemm.cuh.  It replaces no TPU kernel: the JAX package has
// no routed experts.  It was added so that the expert layer runs inside
// the train step's CUDA graph (train/step.py): how many rows each expert
// takes is known only on the device, and a capture can hold neither a
// host read of those counts nor a library GEMM whose shape follows them.
//
// The rows are the layer's (token, expert) assignments sorted by expert,
// the held experts first (ops/moe.py:route_plan, on the device):
// ``offsets[e] .. offsets[e + 1]`` are expert e's rows, ``tok[r]`` the
// token of row r, ``pos[t, j]`` the row of token t's j-th choice (rows at
// or past offsets[E] belong to experts this card does not hold).  Every
// grid is sized for the bound, all T x K assignments, and each block
// finds its expert and rows from the offsets it reads itself; a block
// past the held experts' rows exits at once.  E held experts, width H,
// expert width I; the gate and up weights are one [E, 2I, H] tensor with
// gate row n at 2n and up row n at 2n + 1, the down weights [E, H, I].
//
//   gate_up (fwd):  gu[r] = x[tok[r]] Wgu_e^T            [R, 2I]
//                   a[r, n] = silu(gu[r, 2n]) gu[r, 2n + 1]   (epilogue)
//   down (fwd):     ys[r] = rw[r] (a[r] Wd_e^T)           [R, H]
//   combine:        out[t] = sum_j ys[pos[t, j]] over held rows, j in order
//   dgate_up (bwd): g[r] = dout[tok[r]] Wd_e              [R, I], and from
//                   it, gu and rw: a[r] again and dgu[r] (the SwiGLU's
//                   gradient at rw[r] g[r])                     (epilogue)
//   dx (bwd):       dxs[r] = dgu[r] Wgu_e                 [R, H], then combine
//   wgrad (bwd):    C_e = sum_{r of e} s[r] A[ia(r)]^T B[ib(r)]:
//                   dWgu_e from dgu and x[tok], dWd_e from rw dout[tok] and a
//
// Numerics: fp32 and exact fmaf, no TF32 and no tensor cores, as
// ffn_sgemm.cuh.  Every output is one fmaf chain in a fixed order (over
// k ascending, or over an expert's rows in their sorted order), and the
// combine adds an assignment's rows in choice order: no atomics, so a
// step gives the same bits eager and replayed.
//
// What bounds it on the H100: the fp32 FMA pipes (67 TFLOP/s).  At the
// Moonlight tower's widths (H 2,048, I 1,408, 8 experts held) and ~300
// rows an expert, the two forward GEMMs are 6 R H I operations (~42
// GFLOP a layer at R = 2,400 held rows, 0.62 ms) against 277 MB of
// weights and rows (0.08 ms): the SIMT tile's FMA rate decides, as for
// B1-B3's fp32 route.  The row tiles are 64 rows (an expert's ~300 rows
// fill five), the weight-gradient tiles 128 x 128 of an expert's output.
//
// Shapes taken: H and I multiples of 128 (the row kernels' N) and of 16
// (their K); the weight gradient's M and N multiples of 128; E <= 64.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "ffn_sgemm.cuh"

namespace {

using mmt_sgemm::BK;
using mmt_sgemm::BN;
using mmt_sgemm::kBLoads;
using mmt_sgemm::kLdB;
using mmt_sgemm::kPad;
using mmt_sgemm::kThreads;
using mmt_sgemm::lds;

constexpr int kMaxExperts = 64;
constexpr int BM = 64;    // rows of a row kernel's block tile
constexpr int WM = 128;   // output rows of a weight-gradient block tile

__device__ __forceinline__ float silu(float g) {
  return g / (1.0f + expf(-g));
}

// The held expert and rows [r0, r1) of row tile ``t``: the experts' tiles
// of BM rows, expert after expert.  False past the last.
__device__ bool tile_of(const int* __restrict__ offsets, int E, int t,
                        int& e, int& r0, int& r1) {
  int base = 0;
  for (int i = 0; i < E; ++i) {
    const int lo = offsets[i], hi = offsets[i + 1];
    const int n = (hi - lo + BM - 1) / BM;
    if (t < base + n) {
      e = i;
      r0 = lo + (t - base) * BM;
      r1 = hi < r0 + BM ? hi : r0 + BM;
      return true;
    }
    base += n;
  }
  return false;
}

// Epilogues: each gets two neighbouring outputs (row r, columns c, c + 1;
// c even) of the block's tile.
struct GateUpEpi {  // gu [R, 2I], a [R, I]
  float* gu;
  float* a;
  int two_i;
  __device__ void operator()(int r, int c, float g, float u) const {
    *reinterpret_cast<float2*>(gu + size_t(r) * two_i + c) =
        make_float2(g, u);
    a[size_t(r) * (two_i / 2) + c / 2] = silu(g) * u;
  }
};

struct DownEpi {  // ys [R, H] = rw[r] * acc
  const float* rw;
  float* ys;
  int h;
  __device__ void operator()(int r, int c, float v0, float v1) const {
    const float s = rw[r];
    *reinterpret_cast<float2*>(ys + size_t(r) * h + c) =
        make_float2(s * v0, s * v1);
  }
};

struct StoreEpi {  // out [R, ld]
  float* out;
  int ld;
  __device__ void operator()(int r, int c, float v0, float v1) const {
    *reinterpret_cast<float2*>(out + size_t(r) * ld + c) = make_float2(v0, v1);
  }
};

struct DGateUpEpi {  // g [R, I] as computed, a [R, I], dgu [R, 2I]
  const float* gu;
  const float* rw;
  float* dgu;
  float* a;
  float* g;
  int i;
  __device__ void one(int r, int n, float gv) const {
    const float2 pre = *reinterpret_cast<const float2*>(gu + size_t(r) * 2 * i
                                                         + 2 * n);
    const float sg = 1.0f / (1.0f + expf(-pre.x));
    const float act = pre.x * sg;
    const float da = rw[r] * gv;
    g[size_t(r) * i + n] = gv;
    a[size_t(r) * i + n] = act * pre.y;
    *reinterpret_cast<float2*>(dgu + size_t(r) * 2 * i + 2 * n) = make_float2(
        da * pre.y * (sg * (1.0f + pre.x * (1.0f - sg))), da * act);
  }
  __device__ void operator()(int r, int c, float v0, float v1) const {
    one(r, c, v0);
    one(r, c + 1, v1);
  }
};

// C[r, n] = sum_k A[ia(r), k] op(W_e)[k, n] for the rows r of the block's
// tile, ia(r) = idx[r] (or r without idx); W_e [N, K] (kKMajorB) or
// [K, N].  The K loop is ffn_sgemm_kernel's: two stages, 16-wide slices.
template <bool kKMajorB, typename Epilogue>
__global__ void __launch_bounds__(kThreads, mmt_sgemm::Shape<BM>::kMinBlocks)
    moe_grouped_gemm_kernel(const float* __restrict__ a,
                            const int* __restrict__ idx,
                            const int* __restrict__ offsets, int E,
                            const float* __restrict__ w, int N, int K,
                            Epilogue epi) {
  using S = mmt_sgemm::Shape<BM>;
  __shared__ __align__(16) float as[2][BK * S::kLdA];
  __shared__ __align__(16) float bs[2][BK * kLdB];
  __shared__ int tile[3];
  if (threadIdx.x == 0) {
    int e = -1, r0 = 0, r1 = 0;
    if (!tile_of(offsets, E, blockIdx.y, e, r0, r1)) e = -1;
    tile[0] = e, tile[1] = r0, tile[2] = r1;
  }
  __syncthreads();
  const int e = tile[0];
  if (e < 0) return;
  const int r0 = tile[1], r1 = tile[2];
  const float* b = w + size_t(e) * N * K;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int n0 = blockIdx.x * BN;

  // The A rows this thread copies, fixed over the K loop (null: zeros).
  const float* arow[S::kALoads];
  int akq[S::kALoads];
#pragma unroll
  for (int p = 0; p < S::kALoads; ++p) {
    const int f = threadIdx.x + p * kThreads;
    const int r = f / (BK / 4);
    akq[p] = (f % (BK / 4)) * 4;
    const bool in_slice = (BM * BK / 4) % kThreads == 0 || f < BM * BK / 4;
    arow[p] = nullptr;
    if (in_slice && r0 + r < r1) {
      arow[p] = a + size_t(idx ? idx[r0 + r] : r0 + r) * K;
    }
  }
  float4 ra[S::kALoads], rb[kBLoads];
  auto load = [&](int k0) {
#pragma unroll
    for (int p = 0; p < S::kALoads; ++p) {
      ra[p] = arow[p] ? *reinterpret_cast<const float4*>(arow[p] + k0 + akq[p])
                      : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
    if constexpr (kKMajorB) {
      mmt_sgemm::load_rows<BN>(rb, b, n0, N, K, k0);
    } else {
      mmt_sgemm::load_cols(rb, b, n0, N, k0);
    }
  };
  auto store = [&](int stage) {
    mmt_sgemm::store_rows<BM>(as[stage], S::kLdA, ra);
    if constexpr (kKMajorB) {
      mmt_sgemm::store_rows<BN>(bs[stage], kLdB, rb);
    } else {
      mmt_sgemm::store_cols(bs[stage], rb);
    }
  };

  float acc[S::kRows][8];
#pragma unroll
  for (int i = 0; i < S::kRows; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  load(0);
  store(0);
  __syncthreads();
  const int ktiles = K / BK;
  for (int kt = 0; kt < ktiles; ++kt) {
    const int stage = kt & 1;
    const bool more = kt + 1 < ktiles;
    if (more) load((kt + 1) * BK);
    const float* sa = as[stage] + ty * S::kHalf;
    const float* sb = bs[stage] + tx * 4;
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float av[S::kRows], bv[8];
      lds<S::kHalf>(av, sa + k * S::kLdA);
      lds<S::kHalf>(av + S::kHalf, sa + k * S::kLdA + BM / 2);
      lds<4>(bv, sb + k * kLdB);
      lds<4>(bv + 4, sb + k * kLdB + BN / 2);
#pragma unroll
      for (int i = 0; i < S::kRows; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (more) store(stage ^ 1);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < S::kRows; ++i) {
    const int row =
        r0 + (i / S::kHalf) * (BM / 2) + ty * S::kHalf + i % S::kHalf;
    if (row < r1) {
#pragma unroll
      for (int g = 0; g < 2; ++g) {
        const int col = n0 + g * (BN / 2) + tx * 4;
        epi(row, col, acc[i][4 * g], acc[i][4 * g + 1]);
        epi(row, col + 2, acc[i][4 * g + 2], acc[i][4 * g + 3]);
      }
    }
  }
}

// The float4s this thread copies of rows [k0, k0 + BK) (those before
// ``hi``; zeros after) of columns [c0, c0 + W) of the row-major [*, ld]
// src, row r read at idx[r] (or r) and scaled by scale[r] (or 1), stored
// as they lie: s[k * (W + kPad) + c].
template <int W>
__device__ __forceinline__ void load_kslice(float4 (&v)[W * BK / 4 / kThreads],
                                            const float* __restrict__ src,
                                            const int* __restrict__ idx,
                                            const float* __restrict__ scale,
                                            int ld, int c0, int k0, int hi) {
#pragma unroll
  for (int p = 0; p < W * BK / 4 / kThreads; ++p) {
    const int f = threadIdx.x + p * kThreads;
    const int k = f / (W / 4), c = (f % (W / 4)) * 4;
    const int r = k0 + k;
    v[p] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (r < hi) {
      v[p] = *reinterpret_cast<const float4*>(
          src + size_t(idx ? idx[r] : r) * ld + c0 + c);
      if (scale) {
        const float s = scale[r];
        v[p].x *= s, v[p].y *= s, v[p].z *= s, v[p].w *= s;
      }
    }
  }
}

template <int W>
__device__ __forceinline__ void store_kslice(
    float* s, const float4 (&v)[W * BK / 4 / kThreads]) {
#pragma unroll
  for (int p = 0; p < W * BK / 4 / kThreads; ++p) {
    const int f = threadIdx.x + p * kThreads;
    const int k = f / (W / 4), c = (f % (W / 4)) * 4;
    *reinterpret_cast<float4*>(s + k * (W + kPad) + c) = v[p];
  }
}

// C[e] [M, N] = sum over expert e's rows r, in order, of
// s[r] A[ia(r), m] B[ib(r), n]: the weight gradients.  Block (x, y, z):
// columns n0 = 128 x, rows m0 = WM y of expert z's output.  An expert
// without rows writes zeros.
__global__ void __launch_bounds__(kThreads, mmt_sgemm::Shape<WM>::kMinBlocks)
    moe_grouped_wgrad_kernel(const float* __restrict__ a,
                             const int* __restrict__ a_idx,
                             const float* __restrict__ a_scale, int M,
                             const float* __restrict__ b,
                             const int* __restrict__ b_idx, int N,
                             const int* __restrict__ offsets,
                             float* __restrict__ c) {
  using S = mmt_sgemm::Shape<WM>;
  __shared__ __align__(16) float as[2][BK * S::kLdA];
  __shared__ __align__(16) float bs[2][BK * kLdB];
  const int e = blockIdx.z;
  const int lo = offsets[e], hi = offsets[e + 1];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int m0 = blockIdx.y * WM, n0 = blockIdx.x * BN;
  float4 ra[WM * BK / 4 / kThreads], rb[BN * BK / 4 / kThreads];
  auto load = [&](int k0) {
    load_kslice<WM>(ra, a, a_idx, a_scale, M, m0, k0, hi);
    load_kslice<BN>(rb, b, b_idx, nullptr, N, n0, k0, hi);
  };
  auto store = [&](int stage) {
    store_kslice<WM>(as[stage], ra);
    store_kslice<BN>(bs[stage], rb);
  };

  float acc[S::kRows][8];
#pragma unroll
  for (int i = 0; i < S::kRows; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  if (hi > lo) {
    load(lo);
    store(0);
  }
  __syncthreads();
  int stage = 0;
  for (int k0 = lo; k0 < hi; k0 += BK, stage ^= 1) {
    const bool more = k0 + BK < hi;
    if (more) load(k0 + BK);
    const float* sa = as[stage] + ty * S::kHalf;
    const float* sb = bs[stage] + tx * 4;
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float av[S::kRows], bv[8];
      lds<S::kHalf>(av, sa + k * S::kLdA);
      lds<S::kHalf>(av + S::kHalf, sa + k * S::kLdA + WM / 2);
      lds<4>(bv, sb + k * kLdB);
      lds<4>(bv + 4, sb + k * kLdB + BN / 2);
#pragma unroll
      for (int i = 0; i < S::kRows; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (more) store(stage ^ 1);
    __syncthreads();
  }

  float* out = c + size_t(e) * M * N;
#pragma unroll
  for (int i = 0; i < S::kRows; ++i) {
    const int row =
        m0 + (i / S::kHalf) * (WM / 2) + ty * S::kHalf + i % S::kHalf;
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      const int col = n0 + g * (BN / 2) + tx * 4;
      *reinterpret_cast<float4*>(out + size_t(row) * N + col) = make_float4(
          acc[i][4 * g], acc[i][4 * g + 1], acc[i][4 * g + 2],
          acc[i][4 * g + 3]);
    }
  }
}

// out[t] = sum over j = 0 .. K - 1 of ys[pos[t, j]], the rows of held
// experts only (pos below offsets[E]), added in that order from 0.  One
// block a token.
__global__ void moe_grouped_combine_kernel(const float* __restrict__ ys,
                                           const int* __restrict__ pos,
                                           const int* __restrict__ offsets,
                                           int E, int K, int H,
                                           float* __restrict__ out) {
  const int t = blockIdx.x;
  const int held = offsets[E];
  const float4* y4 = reinterpret_cast<const float4*>(ys);
  float4* o4 = reinterpret_cast<float4*>(out) + size_t(t) * (H / 4);
  for (int h = threadIdx.x; h < H / 4; h += blockDim.x) {
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int j = 0; j < K; ++j) {
      const int p = pos[t * K + j];
      if (p < held) {
        const float4 v = y4[size_t(p) * (H / 4) + h];
        acc.x += v.x, acc.y += v.y, acc.z += v.z, acc.w += v.w;
      }
    }
    o4[h] = acc;
  }
}

bool aligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

int row_tiles(int rows_bound, int E) { return (rows_bound + BM - 1) / BM + E; }

template <bool kKMajorB, typename Epilogue>
int launch_rows(const float* a, const int* idx, const int* offsets, int E,
                const float* w, int rows_bound, int N, int K, Epilogue epi,
                cudaStream_t stream) {
  if (E < 1 || E > kMaxExperts || rows_bound < 1 || N % BN || K % BK ||
      !aligned(a) || !aligned(w) || row_tiles(rows_bound, E) > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  moe_grouped_gemm_kernel<kKMajorB, Epilogue>
      <<<dim3(N / BN, row_tiles(rows_bound, E)), kThreads, 0, stream>>>(
          a, idx, offsets, E, w, N, K, epi);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int mmt_moe_gate_up(const float* x, const int* tok,
                               const int* offsets, const float* w_gu,
                               float* gu, float* a, int rows_bound, int E,
                               int H, int I, void* stream) {
  return launch_rows<true>(x, tok, offsets, E, w_gu, rows_bound, 2 * I, H,
                           GateUpEpi{gu, a, 2 * I},
                           static_cast<cudaStream_t>(stream));
}

extern "C" int mmt_moe_down(const float* a, const int* offsets,
                            const float* w_d, const float* rw, float* ys,
                            int rows_bound, int E, int H, int I,
                            void* stream) {
  return launch_rows<true>(a, nullptr, offsets, E, w_d, rows_bound, H, I,
                           DownEpi{rw, ys, H},
                           static_cast<cudaStream_t>(stream));
}

extern "C" int mmt_moe_dgate_up(const float* dout, const int* tok,
                                const int* offsets, const float* w_d,
                                const float* gu, const float* rw, float* dgu,
                                float* a, float* g, int rows_bound, int E,
                                int H, int I, void* stream) {
  return launch_rows<false>(dout, tok, offsets, E, w_d, rows_bound, I, H,
                            DGateUpEpi{gu, rw, dgu, a, g, I},
                            static_cast<cudaStream_t>(stream));
}

extern "C" int mmt_moe_dx(const float* dgu, const int* offsets,
                          const float* w_gu, float* dxs, int rows_bound,
                          int E, int H, int I, void* stream) {
  return launch_rows<false>(dgu, nullptr, offsets, E, w_gu, rows_bound, H,
                            2 * I, StoreEpi{dxs, H},
                            static_cast<cudaStream_t>(stream));
}

extern "C" int mmt_moe_wgrad(const float* a, const int* a_idx,
                             const float* a_scale, int M, const float* b,
                             const int* b_idx, int N, const int* offsets,
                             int E, float* c, void* stream) {
  if (E < 1 || E > kMaxExperts || M % WM || N % BN || !aligned(a) ||
      !aligned(b) || !aligned(c) || M / WM > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  moe_grouped_wgrad_kernel<<<dim3(N / BN, M / WM, E), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      a, a_idx, a_scale, M, b, b_idx, N, offsets, c);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mmt_moe_combine(const float* ys, const int* pos,
                               const int* offsets, int E, int T, int K,
                               int H, float* out, void* stream) {
  if (E < 1 || E > kMaxExperts || T < 1 || H % 4 || !aligned(ys) ||
      !aligned(out)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  moe_grouped_combine_kernel<<<T, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      ys, pos, offsets, E, K, H, out);
  return static_cast<int>(cudaGetLastError());
}
