// Fused CP-field forward for Hopper (sm_90a): grid encode + σ/colour heads.
//
// Replaces the TPU kernels gbnerf_tpu/ops/field_fused.py::_kernel (K1, the
// full field: rgb logits ⊕ σ) and ::_kernel_sigma (K2, the σ-only variant of
// the eval coarse pass), one templated source with SIGMA_ONLY as the flag.
//
// What it computes, per point p (layout [N, 3] in → [N, 4] out):
//   encode  u_a = clip(x_a, 0, 1)·(R_max − 1), a = 0..2; the TPU contracts
//           the triangle row relu(1 − |pos − u|) with the unified lines
//           [R_max, F]. Only the taps i0 = ⌊u⌋ and i0 + 1 are nonzero, so a
//           2-tap lerp computes the same number: each tap weight is rounded
//           to bf16 as the TPU's mask is, the lines are bf16, the products of
//           two bf16 values are exact in f32 and the two-term sum rounds once,
//           as the dot over R_max does (the other terms are exact zeros).
//           i0 is clamped to R_max − 2: at u = R_max − 1 (x clipped to 1.0)
//           the first tap's weight is then 0 and the second's 1.
//           feat_f = fa_0 · fa_1 · fa_2 (CP product).
//   σ-net   h0 = relu(feat @ ws0 [F,64]); h1 = h0 @ ws1 [64,16]; σ = h1[0].
//   colour  hc = SH(16) ⊕ h1[1..15]; relu(hc @ wc0 [31,64]) → relu(@ wc1
//           [64,64]) → @ wc2 [64,3] = rgb logits.
//   Every layer's input is rounded to bf16 and accumulated in f32, with relu
//   in f32, as heads_apply does (field_fused.py:65-79).
//
// What bounds it on the H100: at the fine pass of one 16384-ray block
// (2.1 M points) the heads are ≈ 25 kFLOP a point, ≈ 52 GFLOP in all, while
// the HBM traffic is ≈ 100 B a point (x, SH in; raw out). This version does
// the heads as scalar f32 FMAs, one point per thread, with the weights
// staged in shared memory as f32 (bf16-rounded by the wrapper) and read as
// warp-wide broadcasts, so it is bound by the CUDA cores' FMA rate. A
// tensor-core (mma/wgmma) version would move the heads to a 989 TFLOP/s
// unit and leave it bound by memory; that is later work.
//
// Design against that bound: the encode is computed feature by feature and
// folded straight into the 64 h0 accumulators, so no [F] vector is ever
// live; each later layer loops over its input with the output accumulators
// in registers (at most 64 + 16 live); every weight row is read as float4
// broadcasts (one shared load per 4 FMAs). Blocks are persistent (as many
// as are resident at once) so each loads the ≈ 50 KB of weights once, not
// once per tile. The unified lines (3 × 257 × 80 bf16 = 123 KB) are read
// through L1/L2: they do not fit beside the weights of several blocks.

#include "field_common.cuh"

namespace {

constexpr int kThreads = 128;

template <bool kSigmaOnly>
__global__ void __launch_bounds__(kThreads)
field_fused_kernel(const float* __restrict__ x, const float* __restrict__ sh,
                   const __nv_bfloat16* __restrict__ lines,
                   const float* __restrict__ wpack, float* __restrict__ out,
                   int n, int r_max, int feat) {
  extern __shared__ float4 smem4[];
  float* sw = reinterpret_cast<float*>(smem4);
  const int n_w = feat * kSigmaWidth + (kSigmaOnly ? kOffWc0 : kTail);
  for (int i = threadIdx.x; i < n_w / 4; i += blockDim.x)
    smem4[i] = reinterpret_cast<const float4*>(wpack)[i];
  __syncthreads();
  const float* s_ws0 = sw;
  const float* s_ws1 = sw + feat * kSigmaWidth;

  for (int p = blockIdx.x * blockDim.x + threadIdx.x; p < n;
       p += gridDim.x * blockDim.x) {
    // ---- encode taps, one pair per axis
    const __nv_bfloat16* row0[3];
    float w0[3], w1[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const CpTap t = cp_tap(x[3 * p + a], r_max);
      w0[a] = t.w0;
      w1[a] = t.w1;
      row0[a] = lines + ((size_t)a * r_max + t.i0) * feat;
    }

    // ---- encode ⊗ ws0, folded per feature into the h0 accumulators
    float h0[kSigmaWidth];
#pragma unroll
    for (int j = 0; j < kSigmaWidth; ++j) h0[j] = 0.f;
    for (int f = 0; f < feat; f += 4) {
      float e[4] = {1.f, 1.f, 1.f, 1.f};   // 1·fa_0 is exact: (fa_0·fa_1)·fa_2
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        float l0[4], l1[4];
        unpack4(__ldg(reinterpret_cast<const uint2*>(row0[a] + f)), l0);
        unpack4(__ldg(reinterpret_cast<const uint2*>(row0[a] + feat + f)), l1);
#pragma unroll
        for (int k = 0; k < 4; ++k)
          e[k] *= fmaf(w1[a], l1[k], w0[a] * l0[k]);
      }
#pragma unroll
      for (int k = 0; k < 4; ++k)
        axpy64(h0, bf16_round(e[k]), s_ws0 + (f + k) * kSigmaWidth);
    }

    // ---- h1 = bf16(relu(h0)) @ ws1
    float h1[kGeo];
#pragma unroll
    for (int j = 0; j < kGeo; ++j) h1[j] = 0.f;
#pragma unroll
    for (int j = 0; j < kSigmaWidth; ++j) {
      const float a = bf16_round(fmaxf(h0[j], 0.f));
      const float4* w4 = reinterpret_cast<const float4*>(s_ws1 + j * kGeo);
#pragma unroll
      for (int q = 0; q < kGeo / 4; ++q) {
        const float4 v = w4[q];
        h1[4 * q + 0] = fmaf(a, v.x, h1[4 * q + 0]);
        h1[4 * q + 1] = fmaf(a, v.y, h1[4 * q + 1]);
        h1[4 * q + 2] = fmaf(a, v.z, h1[4 * q + 2]);
        h1[4 * q + 3] = fmaf(a, v.w, h1[4 * q + 3]);
      }
    }
    const float sigma = h1[0];
    if (kSigmaOnly) {
      reinterpret_cast<float4*>(out)[p] = make_float4(0.f, 0.f, 0.f, sigma);
      continue;
    }

    // ---- h2 = relu((SH ⊕ h1[1:]) @ wc0), inputs bf16-rounded
    const float* s_wc0 = s_ws1 + kOffWc0;
    float h2[kColorWidth];
#pragma unroll
    for (int j = 0; j < kColorWidth; ++j) h2[j] = 0.f;
    const float4* sh4 = reinterpret_cast<const float4*>(sh + (size_t)p * kSh);
#pragma unroll
    for (int q = 0; q < kSh / 4; ++q) {
      const float4 s = __ldg(sh4 + q);
      axpy64(h2, bf16_round(s.x), s_wc0 + (4 * q + 0) * kColorWidth);
      axpy64(h2, bf16_round(s.y), s_wc0 + (4 * q + 1) * kColorWidth);
      axpy64(h2, bf16_round(s.z), s_wc0 + (4 * q + 2) * kColorWidth);
      axpy64(h2, bf16_round(s.w), s_wc0 + (4 * q + 3) * kColorWidth);
    }
#pragma unroll
    for (int i = 1; i < kGeo; ++i)
      axpy64(h2, bf16_round(h1[i]), s_wc0 + (kSh + i - 1) * kColorWidth);
#pragma unroll
    for (int j = 0; j < kColorWidth; ++j) h2[j] = bf16_round(fmaxf(h2[j], 0.f));

    // ---- h3_k = relu(h2 @ wc1[:, k]), folded at once into rgb += h3_k·wc2[k]
    const float* s_wc1t = s_ws1 + kOffWc1;
    const float4* s_wc2 = reinterpret_cast<const float4*>(s_ws1 + kOffWc2);
    float r0 = 0.f, r1 = 0.f, r2 = 0.f;
#pragma unroll 2
    for (int k = 0; k < kColorWidth; ++k) {
      const float4* w4 = reinterpret_cast<const float4*>(s_wc1t + k * kColorWidth);
      float acc = 0.f;
#pragma unroll
      for (int q = 0; q < kColorWidth / 4; ++q) {
        const float4 v = w4[q];
        acc = fmaf(h2[4 * q + 0], v.x, acc);
        acc = fmaf(h2[4 * q + 1], v.y, acc);
        acc = fmaf(h2[4 * q + 2], v.z, acc);
        acc = fmaf(h2[4 * q + 3], v.w, acc);
      }
      const float g = bf16_round(fmaxf(acc, 0.f));
      const float4 c = s_wc2[k];
      r0 = fmaf(g, c.x, r0);
      r1 = fmaf(g, c.y, r1);
      r2 = fmaf(g, c.z, r2);
    }
    reinterpret_cast<float4*>(out)[p] = make_float4(r0, r1, r2, sigma);
  }
}

template <bool kSigmaOnly>
int launch(const float* x, const float* sh, const __nv_bfloat16* lines,
           const float* wpack, float* out, int n, int r_max, int feat,
           cudaStream_t stream) {
  const int n_w = feat * kSigmaWidth + (kSigmaOnly ? kOffWc0 : kTail);
  const size_t smem = (size_t)n_w * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      field_fused_kernel<kSigmaOnly>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  // persistent blocks: exactly as many as are resident at once (registers
  // or shared memory bound it), so no block waits for a second wave
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, field_fused_kernel<kSigmaOnly>, kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (n + kThreads - 1) / kThreads;
  const int cap = sm_count() * (per_sm > 0 ? per_sm : 1);
  const int grid = tiles < cap ? tiles : cap;
  field_fused_kernel<kSigmaOnly><<<grid, kThreads, smem, stream>>>(
      x, sh, lines, wpack, out, n, r_max, feat);
  return (int)cudaGetLastError();
}

}  // namespace

// x [n,3] f32, sh [n,16] f32 (unused when sigma_only), lines [3,r_max,feat]
// bf16, wpack the packed bf16-rounded f32 weights (see field_fused.py), out
// [n,4] f32. Returns cudaGetLastError() after the launch (0 = success).
extern "C" int gbnerf_field_fused(const void* x, const void* sh,
                                  const void* lines, const void* wpack,
                                  void* out, int n, int r_max, int feat,
                                  int sigma_only, void* stream) {
  if (n == 0) return 0;
  const auto* xl = static_cast<const float*>(x);
  const auto* sl = static_cast<const float*>(sh);
  const auto* ll = static_cast<const __nv_bfloat16*>(lines);
  const auto* wl = static_cast<const float*>(wpack);
  auto* ol = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  return sigma_only ? launch<true>(xl, sl, ll, wl, ol, n, r_max, feat, st)
                    : launch<false>(xl, sl, ll, wl, ol, n, r_max, feat, st);
}
