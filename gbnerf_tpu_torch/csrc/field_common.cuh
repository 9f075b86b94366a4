// Shared by the CP kernels: field_fused.cu (K1/K2, forward),
// field_fused_bwd.cu (K4/K5, backward) and cp_encode.cu (K6, the encode
// alone). Widths of the heads, the encode's two taps, their tie
// conventions, and small helpers. (The packed weights' layout is
// field_tile.cuh's.)
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

// sign(d)·[|d| < 1]: the derivative of the tap weight relu(1 − |d|) in u
// at signed distance d = r − u, 0 at d = 0 (du = 0 at a grid node, as the
// TPU kernel's jnp.sign)
__device__ __forceinline__ float tie_sign(float d) {
  return fabsf(d) < 1.f ? (d > 0.f ? 1.f : (d < 0.f ? -1.f : 0.f)) : 0.f;
}

__device__ __forceinline__ void unpack4(uint2 raw, float* out) {
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  out[0] = __low2float(lo);
  out[1] = __high2float(lo);
  out[2] = __low2float(hi);
  out[3] = __high2float(hi);
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
