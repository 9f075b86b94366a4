// Bitonic merge of two sorted z halves for Hopper (sm_90a).
//
// Replaces the TPU kernel gbnerf_tpu/ops/resample.py::_merge128_kernel (K3):
// each row of [N, 128] f32 holds a sorted first part (positions < split,
// the coarse z) and a sorted second part (the fine samples). Reversing the
// second part makes the row bitonic, and 7 half-cleaner stages (compare
// position p with p ^ d, keep the min where p & d == 0, else the max;
// d = 64 … 1) sort it: O(S log S) compare-exchanges instead of a full sort.
//
// Layout: one warp per row, lane l holding the 4 contiguous values
// 4l … 4l+3. The reversal is folded into the load (each lane reads its
// 4 source positions). Stages d = 64 … 4 pair lane l with lane l ^ (d/4),
// the same slot, through __shfl_xor_sync; d = 2 and 1 stay inside a
// thread. The result goes out as one float4 per lane (a coalesced 512 B
// row store).
//
// What bounds it on the H100: memory. One 16384-ray block moves
// 16384 × 128 × 4 B in and out, ≈ 17 MB, against ≈ 7 × 4 min/max and
// 5 × 4 shuffles a value: the kernel reads and writes each value once and
// keeps all work in registers. Rows are walked by persistent warps.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;          // 8 rows (warps) per block
constexpr int kBlocksPerSm = 8;

__global__ void __launch_bounds__(kThreads)
merge128_kernel(const float* __restrict__ x, float* __restrict__ out,
                int n_rows, int split) {
  const int lane = threadIdx.x & 31;
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int n_warps = (gridDim.x * blockDim.x) >> 5;
  for (int row = warp; row < n_rows; row += n_warps) {   // warp-uniform
    const float* src = x + (size_t)row * 128;
    float v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int p = 4 * lane + k;
      v[k] = __ldg(src + (p < split ? p : 127 + split - p));
    }
#pragma unroll
    for (int d = 64; d >= 4; d >>= 1) {
      const bool keep_min = (lane & (d >> 2)) == 0;     // (4·lane+k) & d == 0
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float o = __shfl_xor_sync(0xffffffffu, v[k], d >> 2);
        v[k] = keep_min ? fminf(v[k], o) : fmaxf(v[k], o);
      }
    }
    const float a0 = fminf(v[0], v[2]), a2 = fmaxf(v[0], v[2]);   // d = 2
    const float a1 = fminf(v[1], v[3]), a3 = fmaxf(v[1], v[3]);
    reinterpret_cast<float4*>(out + (size_t)row * 128)[lane] =      // d = 1
        make_float4(fminf(a0, a1), fmaxf(a0, a1), fminf(a2, a3), fmaxf(a2, a3));
  }
}

}  // namespace

// x, out: [n_rows, 128] f32, contiguous; 0 < split < 128. Returns
// cudaGetLastError() after the launch (0 = success).
extern "C" int gbnerf_merge128(const void* x, void* out, int n_rows, int split,
                               void* stream) {
  if (n_rows == 0) return 0;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int rows_per_block = kThreads / 32;
  const int blocks = (n_rows + rows_per_block - 1) / rows_per_block;
  const int cap = sms * kBlocksPerSm;
  merge128_kernel<<<blocks < cap ? blocks : cap, kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), n_rows, split);
  return (int)cudaGetLastError();
}
