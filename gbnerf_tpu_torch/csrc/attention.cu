// Self-attention forward for Hopper (sm_90a): softmax(q·kᵀ) v per (batch·head).
//
// Replaces the TPU kernel gbnerf_tpu/ops/attention.py::_kernel (K7). The
// TPU keeps one head's whole K/V in VMEM (4096 × 512 bf16 = 4 MB at the VAE's
// mid block) and takes an exact softmax over each full score row. A block
// here has at most 227 KB of shared memory, so this is a flash-style forward:
// one block per (64 query rows, output column chunk, batch·head), a loop
// over 64-key K/V tiles staged in shared memory, a running row max and sum
// in f32, and the output accumulator rescaled per tile. Scores and p·v run
// on the tensor cores with mma.sync m16n8k16 (bf16 operands, f32 sums);
// each of the 4 warps owns 16 query rows, and the f32 score fragments of
// q·kᵀ are repacked in registers as the bf16 A operand of p·v.
//
// Inputs are bf16 [BH, N, D], contiguous, with q already scaled (the
// wrapper rounds q·scale to bf16, as the TPU wrapper does); the output is
// f32 [BH, N, D] (the wrapper casts it to q's dtype). D must be a multiple
// of 8 (16-byte row loads) and at most 512.
//
// Design points:
// - Head dims that are not a multiple of 16 (the UNet's D = 40) are padded
//   with zeros in shared memory to the next multiple (48) for q·kᵀ's depth;
//   D = 80 and 512 divide.
// - D = 512 (the VAE): a 64-row f32 output tile is 128 KB and does not fit
//   in registers. The output's columns are split across blocks, 256 at a
//   time (2 blocks per query tile), and each block recomputes the scores:
//   2× the q·kᵀ work of one pass, 1.5× the total FLOPs of an unsplit
//   kernel, for a kernel that keeps its accumulators in registers (128 f32
//   a thread). Shared memory then holds Q [64 × 520] and K [64 × 520] bf16
//   and Vᵀ [256 × 72]: 169,984 B, one block per SM. (With 128-column
//   chunks, 4 blocks and 4× the scores, it took 1.42 ms against the plain
//   version's 1.10 ms on the H100.)
// - Rounding: the TPU kernel normalises p before rounding it to bf16; an
//   online softmax rounds the unnormalised p (relative to the running max)
//   and divides by the f32 row sum at the end. Both round each p once, so
//   they agree to bf16 level relative to max|out|, not bit for bit.
// - A ragged N is masked on the last K/V tile (scores → −inf, K/V rows
//   zero-filled) and query rows past N are neither loaded nor stored.
// - Rows are padded by 8 bf16 in shared memory so that the fragment loads
//   (32-bit, 8 rows × 4 lanes) hit 32 distinct banks. V is stored
//   transposed (Vᵀ [d][key]) so that p·v's B fragments are 32-bit loads too.
//
// What bounds it on the H100: at D = 40 and N = 4096 the block reads each
// K/V tile once per 64 query rows (≈ 2.6 GB of L2 traffic per call at
// BH 16) for 51 GFLOP on the tensor cores; with single-buffered synchronous
// tile loads the loads and the mma.sync instructions do not overlap, so neither
// roofline is reached. cp.async double buffering, wgmma and TMA are later
// work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBQ = 64;        // query rows per block (4 warps × 16)
constexpr int kBK = 64;        // keys per K/V tile
constexpr int kThreads = 128;
constexpr int kPad = 8;        // bf16 padding per shared-memory row
constexpr int kVS = kBK + kPad;

__device__ __forceinline__ uint32_t lds32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // .x (lo) in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// c += a · b, m16n8k16, bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 64 rows [row0, row0 + 64) × DP columns of a [n, d] bf16 matrix into
// shared memory (row stride DP + kPad); rows ≥ n and columns ≥ d are zero.
template <int DP>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src,
                                          int row0, int n, int d) {
  constexpr int kChunks = DP / 8;                  // 16-byte chunks a row
  for (int i = threadIdx.x; i < 64 * kChunks; i += kThreads) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n && c < d)
      v = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * d + c);
    *reinterpret_cast<uint4*>(dst + r * (DP + kPad) + c) = v;
  }
}

// Vᵀ of the tile: keys [kv0, kv0 + 64) × columns [c0, c0 + DVC) of v into
// vt[col][key] (row stride kVS); zero outside [0, n) × [0, d). Consecutive
// threads take consecutive keys, so the 2-byte stores of a warp fall on
// consecutive addresses.
template <int DVC>
__device__ __forceinline__ void load_vt(bf16* vt, const bf16* v, int kv0,
                                        int c0, int n, int d) {
  for (int i = threadIdx.x; i < kBK * (DVC / 8); i += kThreads) {
    const int r = i % kBK, c = (i / kBK) * 8;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (kv0 + r < n && c0 + c < d)
      x = *reinterpret_cast<const uint4*>(v + (size_t)(kv0 + r) * d + c0 + c);
    const bf16* e = reinterpret_cast<const bf16*>(&x);
#pragma unroll
    for (int j = 0; j < 8; ++j) vt[(c + j) * kVS + r] = e[j];
  }
}

template <int DP, int DVC>
__global__ void __launch_bounds__(kThreads)
attention_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, float* __restrict__ out,
                     int n, int d) {
  constexpr int kQS = DP + kPad;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ks = qs + kBQ * kQS;
  bf16* vt = ks + kBK * kQS;

  const int q0 = blockIdx.x * kBQ, c0 = blockIdx.y * DVC;
  const size_t base = (size_t)blockIdx.z * n * d;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  load_rows<DP>(qs, q + base, q0, n, d);
  const bf16* qw = qs + warp * 16 * kQS;

  float o[DVC / 8][4];
#pragma unroll
  for (int j = 0; j < DVC / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};   // rows g and g + 8
  float l[2] = {0.f, 0.f};                       // this thread's partial sums

  for (int kv0 = 0; kv0 < n; kv0 += kBK) {
    __syncthreads();                 // the previous tile is consumed
    load_rows<DP>(ks, k + base, kv0, n, d);
    load_vt<DVC>(vt, v + base, kv0, c0, n, d);
    __syncthreads();

    // s = q · kᵀ for this warp's 16 rows × 64 keys
    float s[kBK / 8][4];
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      uint32_t a[4];
      const bf16* qa = qw + g * kQS + kk * 16 + 2 * t;
      a[0] = lds32(qa);
      a[1] = lds32(qa + 8 * kQS);
      a[2] = lds32(qa + 8);
      a[3] = lds32(qa + 8 * kQS + 8);
#pragma unroll
      for (int nt = 0; nt < kBK / 8; ++nt) {
        const bf16* kb = ks + (nt * 8 + g) * kQS + kk * 16 + 2 * t;
        const uint32_t b[2] = {lds32(kb), lds32(kb + 8)};
        mma_bf16(s[nt], a, b);
      }
    }
    if (kv0 + kBK > n) {             // ragged last tile: mask keys ≥ n
#pragma unroll
      for (int nt = 0; nt < kBK / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (kv0 + nt * 8 + 2 * t + (e & 1) >= n) s[nt][e] = -CUDART_INF_F;
    }

    // online softmax: new row max over the 4 lanes of a row, rescale
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) {
      mx[0] = fmaxf(mx[0], fmaxf(s[nt][0], s[nt][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[nt][2], s[nt][3]));
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    }
    // the first tile always holds key 0, so mx is finite from here on
    const float corr[2] = {__expf(m[0] - mx[0]), __expf(m[1] - mx[1])};
    m[0] = mx[0];
    m[1] = mx[1];
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) {
      s[nt][0] = __expf(s[nt][0] - mx[0]);
      s[nt][1] = __expf(s[nt][1] - mx[0]);
      s[nt][2] = __expf(s[nt][2] - mx[1]);
      s[nt][3] = __expf(s[nt][3] - mx[1]);
      rs[0] += s[nt][0] + s[nt][1];
      rs[1] += s[nt][2] + s[nt][3];
    }
    l[0] = l[0] * corr[0] + rs[0];
    l[1] = l[1] * corr[1] + rs[1];
#pragma unroll
    for (int j = 0; j < DVC / 8; ++j) {
      o[j][0] *= corr[0];
      o[j][1] *= corr[0];
      o[j][2] *= corr[1];
      o[j][3] *= corr[1];
    }

    // o += bf16(p) · v: the score fragments of two key octets form the
    // A fragment of one 16-key step
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int j = 0; j < DVC / 8; ++j) {
        const bf16* vb = vt + (j * 8 + g) * kVS + kk * 16 + 2 * t;
        const uint32_t b[2] = {lds32(vb), lds32(vb + 8)};
        mma_bf16(o[j], a, b);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  const float inv[2] = {1.f / l[0], 1.f / l[1]};
  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
#pragma unroll
  for (int j = 0; j < DVC / 8; ++j) {
    const int col = c0 + j * 8 + 2 * t;
    if (col >= d) continue;          // d is even: col + 1 < d too
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (row[r] < n)
        *reinterpret_cast<float2*>(out + base + (size_t)row[r] * d + col) =
            make_float2(o[j][2 * r] * inv[r], o[j][2 * r + 1] * inv[r]);
  }
}

template <int DP, int DVC>
int launch(const bf16* q, const bf16* k, const bf16* v, float* out, int bh,
           int n, int d, cudaStream_t stream) {
  const int smem = ((kBQ + kBK) * (DP + kPad) + DVC * kVS) * (int)sizeof(bf16);
  auto kernel = attention_fwd_kernel<DP, DVC>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n + kBQ - 1) / kBQ, (d + DVC - 1) / DVC, bh);
  kernel<<<grid, kThreads, smem, stream>>>(q, k, v, out, n, d);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v: [bh, n, d] bf16, contiguous (q pre-scaled); out: [bh, n, d] f32.
// d % 8 == 0, 8 ≤ d ≤ 512, bh ≤ 65535. Returns the cudaError_t of the
// launch (0 = success).
extern "C" int gbnerf_attention_fwd(const void* q, const void* k,
                                    const void* v, void* out, int bh, int n,
                                    int d, void* stream) {
  if (bh == 0 || n == 0) return 0;
  const bf16* Q = static_cast<const bf16*>(q);
  const bf16* K = static_cast<const bf16*>(k);
  const bf16* V = static_cast<const bf16*>(v);
  float* O = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int dp = (d + 15) / 16 * 16;
  switch (dp) {
    case 16: return launch<16, 16>(Q, K, V, O, bh, n, d, s);
    case 32: return launch<32, 32>(Q, K, V, O, bh, n, d, s);
    case 48: return launch<48, 48>(Q, K, V, O, bh, n, d, s);
    case 64: return launch<64, 64>(Q, K, V, O, bh, n, d, s);
    case 80: return launch<80, 80>(Q, K, V, O, bh, n, d, s);
    case 96: return launch<96, 96>(Q, K, V, O, bh, n, d, s);
    case 112: return launch<112, 112>(Q, K, V, O, bh, n, d, s);
    case 128: return launch<128, 128>(Q, K, V, O, bh, n, d, s);
    default: break;
  }
  if (dp <= 256) return launch<256, 128>(Q, K, V, O, bh, n, d, s);
  if (dp <= 384) return launch<384, 192>(Q, K, V, O, bh, n, d, s);
  if (dp <= 512) return launch<512, 256>(Q, K, V, O, bh, n, d, s);
  return (int)cudaErrorInvalidValue;
}
