// Shared by the fused CP-field kernels: field_fused.cu (K1/K2, forward) and
// field_fused_bwd.cu (K4/K5, backward). Widths of the heads, the layout of
// the packed weights (ops/field_fused.py::pack_weights) and small helpers.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSigmaWidth = 64;                  // ws0 out
constexpr int kGeo = 16;                         // ws1 out: σ ⊕ 15 geo
constexpr int kSh = 16;                          // SH degree 4
constexpr int kColorIn = kSh + kGeo - 1;         // 31
constexpr int kColorWidth = 64;
// floats after ws0 [F][64] in the packed weights: ws1 [64][16],
// wc0 [31][64], wc1ᵀ [64 out][64 in], wc2 [64][4] (column 3 zero)
constexpr int kOffWc0 = kSigmaWidth * kGeo;
constexpr int kOffWc1 = kOffWc0 + kColorIn * kColorWidth;
constexpr int kOffWc2 = kOffWc1 + kColorWidth * kColorWidth;
constexpr int kTail = kOffWc2 + kColorWidth * 4;

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16(v));   // round to nearest even
}

__device__ __forceinline__ void unpack4(uint2 raw, float* out) {
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  out[0] = __low2float(lo);
  out[1] = __high2float(lo);
  out[2] = __low2float(hi);
  out[3] = __high2float(hi);
}

// acc[0..63] += a · w[0..63], w a float4-aligned row (shared or global)
__device__ __forceinline__ void axpy64(float* acc, float a, const float* w) {
  const float4* w4 = reinterpret_cast<const float4*>(w);
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const float4 v = w4[j];
    acc[4 * j + 0] = fmaf(a, v.x, acc[4 * j + 0]);
    acc[4 * j + 1] = fmaf(a, v.y, acc[4 * j + 1]);
    acc[4 * j + 2] = fmaf(a, v.z, acc[4 * j + 2]);
    acc[4 * j + 3] = fmaf(a, v.w, acc[4 * j + 3]);
  }
}

// Σ_j w[j]·v[j] over 64, w a float4-aligned row (shared or global)
__device__ __forceinline__ float dot64(const float* w, const float* v) {
  const float4* w4 = reinterpret_cast<const float4*>(w);
  float acc = 0.f;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const float4 u = w4[j];
    acc = fmaf(u.x, v[4 * j + 0], acc);
    acc = fmaf(u.y, v[4 * j + 1], acc);
    acc = fmaf(u.z, v[4 * j + 2], acc);
    acc = fmaf(u.w, v[4 * j + 3], acc);
  }
  return acc;
}

inline int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
  }
  return count;
}

}  // namespace
