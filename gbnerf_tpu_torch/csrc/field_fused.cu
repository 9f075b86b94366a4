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
//           2-tap lerp computes the same number (cp_tap, field_common.cuh):
//           each tap weight is rounded to bf16 as the TPU's mask is, the
//           lines are bf16, the products of two bf16 values are exact in
//           f32 and the two-term sum rounds once, as the dot over R_max does.
//           feat_f = fa_0 · fa_1 · fa_2 (CP product).
//   σ-net   h0 = relu(feat @ ws0 [F,64]); h1 = h0 @ ws1 [64,16]; σ = h1[0].
//   colour  hc = SH(16) ⊕ h1[1..15]; relu(hc @ wc0 [31,64]) → relu(@ wc1
//           [64,64]) → @ wc2 [64,3] = rgb logits.
//   Every layer's input is rounded to bf16 and summed in f32, with relu in
//   f32, as heads_apply does (ops/field_fused.py).
//
// What bounds it on the H100: at the fine pass of one 16384-ray render
// (2,097,152 points, F 80) the heads are 12,416 multiply-adds a point, 52
// GFLOP in all: 0.053 ms on the bf16 tensor cores (989 TFLOP/s), 0.78 ms
// as scalar f32 FMAs (67 TFLOP/s, the previous design). The bytes (x, SH
// in, raw out: ≈ 0.058 ms at 3.35 TB/s) set the bound once the heads run
// on the tensor cores. Beside them the encode gathers 6 line values and
// does ≈ 11 f32 operations a feature.
//
// Design (field_tile.cuh holds the parts shared with K4/K5):
// - The heads on the tensor cores: each warp takes 16-point m-tiles and
//   runs every layer as an mma.sync.m16n8k16 chain, each layer's C
//   fragments turned into the next one's bf16 A fragments in registers;
//   nothing but the output leaves the registers.
// - The encode is computed straight into the A fragments of bf16(enc): a
//   lane's entries of a k-chunk are its two points × four neighbouring
//   features (the chunk order of field_tile.cuh; ws0's rows are packed to
//   match), each a product of three 2-tap lerps, one 8-byte load a tap row.
//   The encode's gathers are about half of the kernel's time (PERF.md).
// - The weights (≈ 29 KB bf16 at F 80) and, when they fit, the unified
//   lines (3 × 257 × 88 bf16 = 136 KB, rows padded to 4·odd words for the
//   banks) are staged in shared memory once per persistent block of 16
//   warps (≈ 100 registers a thread, no spills; 165,136 bytes of shared
//   memory, one block an SM); where the lines do not fit, they are read
//   through L1/L2. Each warp's chain of products waits on the one before,
//   so the SM needs many warps: 16 took 0.422 ms where 8 took 0.553.
// K1's forward is not made exact at the relu boundaries as K4's recompute
// is (field_tile.cuh::seq_fixup): its output is continuous there.

#include "field_tile.cuh"

namespace {

// 16 warps a block: each warp's chain of products waits on the one
// before, so an SM needs many warps in flight (≈ 100 registers a thread)
constexpr int kFwdWarps = 16;
constexpr int kFwdBlock = 32 * kFwdWarps;

template <bool kSigmaOnly>
__global__ void __launch_bounds__(kFwdBlock, 1)
field_fused_kernel(const float* __restrict__ x, const float* __restrict__ sh,
                   const bf16* __restrict__ lines,
                   const bf16* __restrict__ wpack, float* __restrict__ out,
                   int n, int r_max, int feat, int stage_lines) {
  extern __shared__ __align__(16) unsigned char smem[];
  const WLayout W = weight_layout(feat, kSigmaOnly);
  bf16* sw = reinterpret_cast<bf16*>(smem);
  copy16(sw, wpack, W.total);
  const bf16* L = lines;
  int ls = feat;
  if (stage_lines) {             // [3·R_max][line_stride] bf16, 8 B a copy
    bf16* sl = sw + W.total;
    ls = line_stride(feat);
    const int q = feat / 4;
    for (int i = threadIdx.x; i < 3 * r_max * q; i += blockDim.x)
      *reinterpret_cast<uint2*>(sl + (i / q) * ls + (i % q) * 4) =
          reinterpret_cast<const uint2*>(lines)[i];
    L = sl;
  }
  __syncthreads();

  const int l = lane_id(), tig = l & 3;
  const int mtiles = (n + 15) / 16;
  for (int mt = blockIdx.x * kFwdWarps + (threadIdx.x >> 5); mt < mtiles;
       mt += gridDim.x * kFwdWarps) {
    const int p0 = mt * 16;
    LaneTaps t;
    lane_taps(t, x, p0, n, r_max, ls);
    float h1[2][4];
    sigma_net<true, false>(h1, t, L, ls, feat, sw, W, nullptr, 0, nullptr);
    // σ = h1[:, 0]: C entries 0 (row g) and 2 (row g + 8) of lanes tig 0
    const int pa = p0 + (l >> 2), pb = pa + 8;
    if (kSigmaOnly) {
      if (tig == 0) {
        if (pa < n)
          reinterpret_cast<float4*>(out)[pa] = make_float4(0.f, 0.f, 0.f, h1[0][0]);
        if (pb < n)
          reinterpret_cast<float4*>(out)[pb] = make_float4(0.f, 0.f, 0.f, h1[0][2]);
      }
      continue;
    }
    uint32_t hc[2][4];
    hc_frags(hc, h1, sh, p0, n);
    float rgb[4];
    uint32_t m2, m3;
    color_net<true, false>(rgb, m2, m3, hc, sw, W, nullptr, nullptr,
                          nullptr);
    // rgb: lane tig 0 holds columns 0, 1 and tig 1 columns 2, 3 (3 is the
    // zero padding of wc2), which takes σ from its tig-0 neighbour
    const float sa = __shfl_sync(0xffffffffu, h1[0][0], l & ~3);
    const float sb = __shfl_sync(0xffffffffu, h1[0][2], l & ~3);
    if (tig < 2) {
      if (pa < n)
        reinterpret_cast<float2*>(out)[2 * pa + tig] =
            make_float2(rgb[0], tig ? sa : rgb[1]);
      if (pb < n)
        reinterpret_cast<float2*>(out)[2 * pb + tig] =
            make_float2(rgb[2], tig ? sb : rgb[3]);
    }
  }
}

// Shared memory of a block: the weights, and the lines when stage_lines
size_t fwd_smem(int r_max, int feat, bool sigma_only, bool stage_lines) {
  size_t b = (size_t)weight_layout(feat, sigma_only).total * sizeof(bf16);
  if (stage_lines) b += (size_t)3 * r_max * line_stride(feat) * sizeof(bf16);
  return b;
}

template <bool kSigmaOnly>
int launch(const float* x, const float* sh, const bf16* lines,
           const bf16* wpack, float* out, int n, int r_max, int feat,
           cudaStream_t stream) {
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  const bool stage = fwd_smem(r_max, feat, kSigmaOnly, true) <= (size_t)optin;
  const size_t smem = fwd_smem(r_max, feat, kSigmaOnly, stage);
  cudaError_t err = cudaFuncSetAttribute(
      field_fused_kernel<kSigmaOnly>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  // persistent blocks: exactly as many as are resident at once, so each
  // stages the weights (and lines) once
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, field_fused_kernel<kSigmaOnly>, kFwdBlock, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (n + 16 * kFwdWarps - 1) / (16 * kFwdWarps);
  const int cap = sm_count() * (per_sm > 0 ? per_sm : 1);
  const int grid = blocks < cap ? blocks : cap;
  field_fused_kernel<kSigmaOnly><<<grid, kFwdBlock, smem, stream>>>(
      x, sh, lines, wpack, out, n, r_max, feat, (int)stage);
  return (int)cudaGetLastError();
}

}  // namespace

// x [n,3] f32, sh [n,16] f32 (unused when sigma_only), lines [3,r_max,feat]
// bf16 (feat a multiple of 4), wpack the packed bf16 weights
// (ops/field_fused.py::pack_weights; 16-byte aligned), out [n,4] f32.
// Returns cudaGetLastError() after the launch (0 = success).
extern "C" int gbnerf_field_fused(const void* x, const void* sh,
                                  const void* lines, const void* wpack,
                                  void* out, int n, int r_max, int feat,
                                  int sigma_only, void* stream) {
  if (n == 0) return 0;
  const auto* xl = static_cast<const float*>(x);
  const auto* sl = static_cast<const float*>(sh);
  const auto* ll = static_cast<const bf16*>(lines);
  const auto* wl = static_cast<const bf16*>(wpack);
  auto* ol = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  return sigma_only ? launch<true>(xl, sl, ll, wl, ol, n, r_max, feat, st)
                    : launch<false>(xl, sl, ll, wl, ol, n, r_max, feat, st);
}

// Registers, local (spill) bytes a thread, dynamic shared memory and blocks
// an SM of K1 (K2 when sigma_only) at this shape → info[4]; 0 = success.
extern "C" int gbnerf_field_fused_info(int r_max, int feat, int sigma_only,
                                       int* info) {
  const void* fn = sigma_only ? (const void*)field_fused_kernel<true>
                              : (const void*)field_fused_kernel<false>;
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  const bool so = sigma_only != 0;
  const bool stage = fwd_smem(r_max, feat, so, true) <= (size_t)optin;
  const size_t smem = fwd_smem(r_max, feat, so, stage);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
  int per_sm = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn,
                                                        kFwdBlock, smem);
  info[0] = attr.numRegs;
  info[1] = (int)attr.localSizeBytes;
  info[2] = (int)smem;
  info[3] = per_sm;
  return (int)err;
}
