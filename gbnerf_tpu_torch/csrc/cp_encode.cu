// Standalone CP encode for Hopper (sm_90a): points × unified lines → features.
//
// Replaces the TPU kernel gbnerf_tpu/ops/cp_pallas.py::_kernel (K6, reached
// through _fwd_impl ← cp_encode_unified ← cp_encode_fused(use_pallas=True)).
//
// What it computes (layout [N, 3] in, [3, R_max, F] lines, [N, F] out, f32):
// for each axis a, u = clip(x_a, 0, 1)·(R_max − 1); the TPU contracts the
// triangle row max(1 − |pos − u|, 0), rounded to bf16, with the bf16-rounded
// lines [R_max, F] in f32 and multiplies the three axes: out = fx ⊙ fy ⊙ fz.
// Only the taps i0 and i0 + 1 of that row are nonzero, so a lerp of two
// bf16 line values with bf16 tap weights gives the same number to the last
// bit (cp_tap in field_common.cuh, shared with K1 and K4).
//
// What bounds it on the H100: the output. At the profile's shape (2,097,152
// points, R_max 257, F 80) it writes 320 B and reads 12 B a point, ≈ 0.70 GB
// in all, ≈ 0.21 ms at 3.35 TB/s, while the arithmetic is ≈ 11 f32
// operations an output (≈ 0.03 ms at 67 TFLOP/s).
//
// Design against that bound: one thread per (point, quad of 4 features), the
// quads of a point in neighbouring threads, so that a warp writes whole
// 320-byte rows as float4 stores, coalesced. The lines are read many times
// (6 rows of 4 features per output quad) and must come from on-chip memory:
// each block converts them once into bf16 in shared memory (3 × 257 × 80 ×
// 2 B = 123 KB, so one 1024-thread block an SM) and loops over its share of
// the points (persistent blocks). Measured on the H100 at that shape, this
// took 0.318 ms where reading the f32 lines through L1/L2 (__ldg float4)
// took 0.405 ms; the wrapper refuses lines that do not fit.

#include "field_common.cuh"

namespace {

// 1024 threads: at R_max 257, F 80 the staged lines leave room for one
// block an SM
constexpr int kThreads = 1024;

__global__ void __launch_bounds__(kThreads)
cp_encode_kernel(const float* __restrict__ x, const float* __restrict__ lines,
                 float* __restrict__ out, int n, int r_max, int feat) {
  extern __shared__ uint2 s_lines[];   // [3][r_max][feat/4] bf16 quads
  const int quads = feat / 4;
  const float4* l4 = reinterpret_cast<const float4*>(lines);
  for (int i = threadIdx.x; i < 3 * r_max * quads; i += blockDim.x) {
    const float4 v = __ldg(l4 + i);
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
    uint2 r;
    r.x = *reinterpret_cast<const uint32_t*>(&lo);
    r.y = *reinterpret_cast<const uint32_t*>(&hi);
    s_lines[i] = r;
  }
  __syncthreads();

  const long long total = (long long)n * quads;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       t < total; t += stride) {
    const int p = (int)(t / quads);
    const int q = (int)(t - (long long)p * quads);
    float e[4] = {1.f, 1.f, 1.f, 1.f};   // 1·fa_0 is exact: (fa_0·fa_1)·fa_2
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const CpTap tap = cp_tap(__ldg(x + 3 * (size_t)p + a), r_max);
      const int row = (a * r_max + tap.i0) * quads + q;   // quad index
      float l0[4], l1[4];
      unpack4(s_lines[row], l0);
      unpack4(s_lines[row + quads], l1);
#pragma unroll
      for (int k = 0; k < 4; ++k) e[k] *= fmaf(tap.w1, l1[k], tap.w0 * l0[k]);
    }
    reinterpret_cast<float4*>(out)[t] = make_float4(e[0], e[1], e[2], e[3]);
  }
}

}  // namespace

// x [n,3] f32, lines [3,r_max,feat] f32 (feat a multiple of 4, 16-byte
// aligned, 3·r_max·feat·2 bytes within a block's shared memory: the runtime
// refuses more in cudaFuncSetAttribute), out [n,feat] f32. Returns
// cudaGetLastError() after the launch (0 = success).
extern "C" int gbnerf_cp_encode(const void* x, const void* lines, void* out,
                                int n, int r_max, int feat, void* stream) {
  if (n == 0) return 0;
  const size_t smem = (size_t)3 * r_max * feat * 2;
  cudaError_t err = cudaFuncSetAttribute(
      cp_encode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  // persistent blocks: as many as are resident at once, so each stages the
  // lines once
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, cp_encode_kernel, kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = ((long long)n * (feat / 4) + kThreads - 1) / kThreads;
  const long long cap = (long long)sm_count() * (per_sm > 0 ? per_sm : 1);
  const int grid = (int)(tiles < cap ? tiles : cap);
  cp_encode_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(lines),
      static_cast<float*>(out), n, r_max, feat);
  return (int)cudaGetLastError();
}
