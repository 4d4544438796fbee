// Tiling constants and helpers shared by the FFN kernels (ffn_block.cu:
// eval block and train forward; ffn_train_bwd.cu: train backward).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace mmt_ffn {

using bf16 = __nv_bfloat16;

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

// d/du gelu_erf(u) = Phi(u) + u * phi(u), with the exact erff.
__device__ __forceinline__ float gelu_erf_grad(float u) {
  const float big_phi = 0.5f * (1.0f + erff(u * 0.70710678118654752f));
  const float phi = expf(-0.5f * u * u) * 0.3989422804014327f;
  return big_phi + u * phi;
}

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ bf16 from_float<bf16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) {
  return __bfloat162float(v);
}

// Four bf16 values at p (8-byte aligned) as fp32, and back (round to
// nearest even): the row passes' vector loads and stores.
__device__ __forceinline__ float4 load_bf16x4(const bf16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ __forceinline__ void store_bf16x4(bf16* p, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 raw;
  raw.x = *reinterpret_cast<const uint32_t*>(&lo);
  raw.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = raw;
}

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// True if H and I are shapes the FFN kernels take.
inline bool shapes_ok(int R, int H, int I, int compute_dtype) {
  return R > 0 && H > 0 && H <= MAX_H && H % 16 == 0 && I > 0 &&
         I % 16 == 0 && compute_dtype >= 0 && compute_dtype <= 1;
}

}  // namespace mmt_ffn
