// Shared by the CP kernels: field_fused.cu (K1/K2, forward),
// field_fused_bwd.cu (K4/K5, backward) and cp_encode.cu (K6, the encode
// alone). Widths of the heads, the layout of the packed weights
// (ops/field_fused.py::pack_weights), the encode's two taps and small
// helpers.
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

// The two nonzero taps of the TPU's triangle row max(1 − |pos − u|, 0) at
// u = clip(x, 0, 1)·(R_max − 1): rows i0 = min(⌊u⌋, R_max − 2) and i0 + 1,
// at signed distances d0 = i0 − u and d1 = i0 + 1 − u, each weight rounded
// to bf16 as the TPU rounds its mask. A lerp of two bf16 line values with
// these weights is the TPU's dot over R_max to the last bit: the products
// of two bf16 values are exact in f32 and the other terms are exact zeros.
// At u = R_max − 1 (x clipped to 1) the clamp gives w0 = 0 and w1 = 1.
// A NaN x stays NaN (fmaxf/fminf would map it to 0), so its weights and
// features are NaN, as the plain version's clip and maximum make them.
struct CpTap {
  int i0;
  float d0, d1, w0, w1;
};

__device__ __forceinline__ CpTap cp_tap(float x, int r_max) {
  CpTap t;
  const float c = (x != x) ? x : fminf(fmaxf(x, 0.f), 1.f);
  const float u = c * (float)(r_max - 1);
  t.i0 = (u == u) ? min((int)floorf(u), r_max - 2) : 0;
  t.d0 = (float)t.i0 - u;
  t.d1 = (float)(t.i0 + 1) - u;
  t.w0 = bf16_round(1.f - fabsf(t.d0));
  t.w1 = bf16_round(1.f - fabsf(t.d1));
  return t;
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
