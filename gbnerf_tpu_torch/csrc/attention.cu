// Self-attention forward for Hopper (sm_90a): softmax(q·kᵀ) v per (batch·head).
//
// Replaces the TPU kernel gbnerf_tpu/ops/attention.py::_kernel (K7). The
// TPU keeps one head's whole K/V in VMEM (4096 × 512 bf16 = 4 MB at the VAE's
// mid block) and takes an exact softmax over each full score row. A block
// here has at most 227 KB of shared memory, so this is a flash-style forward:
// a block owns 16·wm query rows, walks the keys in tiles staged in shared
// memory, keeps a running row max and sum in f32 and rescales its output
// accumulator per tile. Scores and p·v run on the tensor cores with
// mma.sync m16n8k16 and m16n8k8 (bf16 operands, f32 sums).
//
// What it computes, as the TPU kernel: q·scale rounded to bf16 (formed here
// as q is loaded: the product of a bf16 q and the bf16 scale is exact in f32
// and rounded once, as `q * bf16(scale)`; an f32 q is multiplied in f32 and
// rounded, as `(q * scale).to(bf16)`), k and v in bf16, scores and softmax
// in f32, p rounded to bf16 once, p·v summed in f32, the output in q's
// dtype (bf16 or f32), one rounding from the f32 accumulator. It rounds the
// unnormalised p of an online softmax where the TPU rounds the normalised
// p: both round each p once, so they agree to bf16 level relative to
// max|out|, not bit for bit.
//
// What bounds it on the H100 (bf16 tensor cores 989 TFLOP/s, 3.35 TB/s):
// the products, 4·BH·N²·D FLOP, at every main-path shape (16 × 4096 × 40:
// 0.043 ms; 16 × 1024 × 80: 0.005 ms; 1 × 4096 × 512: 0.035 ms), and beside
// them one exp a score on the SFU (16 × 4096² = 268 M exps at 16 a clock an
// SM: ≈ 0.07 ms at D 40). mma.sync reaches a fraction of the tensor peak
// (wgmma's), and a warp runs its products, exps and products in turn, so
// the two add up rather than overlap: the kernel sits at 16–22 % of the
// bound, and overlapping them needs warp specialisation (ROADMAP B).
//
// Design points, each against one loss of the first version (0.482 /
// 0.103 / 0.747 ms at the three shapes by CUDA events), with what they
// measured (device time by CUDA-graph replay, NVIDIA H100 80GB HBM3 at
// 700 W, tools/prof_attention.py): 0.196 / 0.027 / 0.213 ms, SDPA 0.165 /
// 0.019 / 0.330 ms in the same runs.
// 1. An asynchronous K/V pipeline: a ring of NST = 2 stages filled with
//    16-byte cp.async.cg. Tile j + 1 is in flight while tile j's products
//    run; one wait and one block barrier per tile. The ragged last tile is
//    zero-filled by the copy itself (src-size 0) and its keys are masked
//    to −∞. (Three stages: 0.2065 / 0.0297 ms, four 0.2107 / 0.0297,
//    against two's 0.2056 / 0.0286 at 64-key tiles.)
// 2. ldmatrix fragments: ldmatrix.x4 for Q and K, ldmatrix.x4.trans for V
//    straight from its natural [key][d] layout (no transposing stores).
//    Shared-memory rows hold an odd number of 16-byte chunks, so the eight
//    row addresses of each 8 × 8 matrix fall on distinct bank groups.
// 3. No wasted columns: p·v runs over exactly D/8 output n-tiles (5 at
//    D 40); q·kᵀ runs exactly D deep, an odd D/8's last 8 columns as one
//    m16n8k8 step (D 40: 2 × k16 + 1 × k8, 0.1964 ms against 0.2016 padded
//    to 48). log2(e) is folded in after the product: p = ex2(s·log2e −
//    m·log2e), one FMA and one ex2 a score.
// 4. Tiles per D. D ≤ 128: one warp per 16 query rows, each warp with all
//    output columns and its own scores (WN = 1). Keys a tile: 64 up to
//    D 64, 128 above (D 80: 0.0272 against 0.0286 at 64; D 40: 0.242 at
//    128, its registers). Up to D 64 the kernel is compiled for two blocks
//    an SM (__launch_bounds__(256, 2): 113 registers where ptxas chose 85,
//    0.1964 against 0.2084; three blocks 0.2075; two spill at D 80). The
//    query tile is 16·wm rows, wm chosen per shape by
//    gbnerf_attention_plan, from the card's SM count (128-row
//    blocks: 0.208 ms at D 40 against 0.233 for 64-row ones, 0.0296
//    against 0.0328 at D 80). D 512 (the VAE): a warp cannot hold a
//    16 × 512 f32 accumulator, so two warps share each 16-row group
//    (WN = 2): each computes the scores of half of a 32-key tile, the pair
//    exchanges row maxima and bf16 p through shared memory (a named
//    barrier of 64 threads), and each applies the whole p to its half of
//    the output columns. Every score is computed once (the first version
//    recomputed them once per 256-column chunk: 1.5× the FLOPs). The keys
//    are split across blocks (grid.y): each block writes its unnormalised
//    O, row max and row sum, and attn_merge combines them by log-sum-exp,
//    which gives the 64 query tiles of the VAE's 4096 rows a grid that
//    fills the card (0.216 ms against 0.427 unsplit).
// 5. No passes around the kernel: it scales q on load and writes q's dtype.
// Tried and measured slower (PERF.md): two 16-row m-tiles a warp; the
// scores of tile j + 1 issued before tile j's softmax; a tile's softmax in
// 2 or 4 sub-tiles (0.215 / 0.241 ms at D 40).
//
// Inputs: q [BH, N, D] bf16 or f32, k and v [BH, N, D] bf16, contiguous and
// 16-byte aligned; D a multiple of 8, 8 ≤ D ≤ 512.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "mma_common.cuh"

namespace {

using bf16 = __nv_bfloat16;

// One warp a 16-row group up to kSmallD, two above (design point 4).
constexpr int kSmallD = 128;
constexpr int kStages = 2;

// Keys a tile at head dim d, and blocks an SM the kernel is compiled for.
constexpr int key_tile(int d) { return d <= 64 ? 64 : d <= kSmallD ? 128 : 32; }
constexpr int min_blocks(int d) { return d <= 64 ? 2 : 1; }

// The key ranges of a split: ⌈T / split⌉ tiles each for T = ⌈n / bk⌉ key
// tiles, so every range holds a tile and there may be fewer than asked.
int key_ranges(int n, int bk, int split) {
  const int tiles = (n + bk - 1) / bk;
  const int s = split < 1 ? 1 : (split < tiles ? split : tiles);
  const int per = (tiles + s - 1) / s;
  return (tiles + per - 1) / per;
}

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// a barrier of `count` threads under id `id` (1…15; 0 is __syncthreads)
__device__ __forceinline__ void named_barrier(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// The kernel's shape parameters. DV8: output n-tiles of 8 columns (D/8 at
// D ≤ 128; 32/48/64 for D > 128, columns past D zero); WN: warps sharing a
// 16-row group (each with DV8·8/WN output columns and BK/WN keys of a tile);
// BK: keys a tile; NST: pipeline stages.
template <int DV8, int WN, int BK, int NST>
struct Cfg {
  static constexpr int DV = DV8 * 8;            // output columns (padded)
  static constexpr int DQK = DV8 * 8;           // q·kᵀ depth
  static constexpr int K16 = DQK / 16;          // its 16-deep mma steps,
  static constexpr bool K8 = DQK % 16 != 0;     // and an 8-deep last one
  static constexpr int QS = row_stride(DQK);    // Q and K row stride
  static constexpr int VS = row_stride(DV);     // V row stride
  static constexpr int PS = row_stride(BK);     // p exchange row stride
  static constexpr int NV = DV8 / WN;           // a warp's output n-tiles
  static constexpr int BKW = BK / WN;           // a warp's keys of a tile
  static constexpr int NS = BKW / 8;            // a warp's score n-tiles
  static constexpr bool QREG = DQK <= 128;      // Q fragments in registers
  static constexpr int STAGE = BK * (QS + VS);  // bf16 a stage (K then V)
  static_assert(NS % 2 == 0, "score n-tiles are loaded in pairs");
  static_assert(WN == 1 || BK % 16 == 0, "p is exchanged in 16-key steps");
  static_assert(!K8 || (WN == 1 && QREG && NS % 4 == 0),
                "the 8-deep step loads K in groups of 32 keys");

  static size_t smem_bytes(int wm) {
    size_t b = ((size_t)16 * wm * QS + (size_t)NST * STAGE) * sizeof(bf16);
    if (WN > 1)
      b += (size_t)16 * wm * PS * sizeof(bf16) + (size_t)16 * wm * WN * 4;
    return b;
  }
};

// q, out: [bh, n, d] (bf16, or f32 when q_f32); k, v: [bh, n, d] bf16.
// grid (⌈n / (16·wm)⌉, split, bh), 32·wm·WN threads. With split > 1 each
// block covers a range of key tiles and writes its unnormalised O to
// part [split, bh, n, d] f32 and (row max, row sum) to ml [split, bh, n, 2].
template <int DV8, int WN, int BK, int NST, int MINB>
__global__ void __launch_bounds__(256, MINB)
attn_fwd(const void* __restrict__ qv, const bf16* __restrict__ k,
         const bf16* __restrict__ v, void* __restrict__ outv,
         float* __restrict__ part, float* __restrict__ ml, int n, int d,
         int q_f32, float qscale) {
  using C = Cfg<DV8, WN, BK, NST>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int wm_count = blockDim.x / (32 * WN);
  const int bq = 16 * wm_count;
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* stages = qs + bq * C::QS;
  bf16* ps = stages + NST * C::STAGE;                       // WN > 1
  float* red = reinterpret_cast<float*>(ps + bq * C::PS);   // WN > 1

  const int tid = threadIdx.x, nt = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp / WN, wn = warp % WN;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * bq;
  const size_t base = (size_t)blockIdx.z * n * d;

  // this block's key tiles
  const int nkt = (n + BK - 1) / BK;
  const int per = (nkt + gridDim.y - 1) / gridDim.y;
  const int kt0 = blockIdx.y * per;
  const int kt1 = min(nkt, kt0 + per);
  const int ntiles = kt1 - kt0;

  auto load_tile = [&](int j) {
    bf16* ks = stages + (j % NST) * C::STAGE;
    bf16* vs = ks + BK * C::QS;
    const int key0 = (kt0 + j) * BK;
    constexpr int kc = C::DQK / 8, vc = C::DV / 8;   // 16-byte chunks a row
    for (int i = tid; i < BK * kc; i += nt) {
      const int r = i / kc, c = (i % kc) * 8;
      const bool ok = key0 + r < n && c < d;
      cp_async16(ks + r * C::QS + c,
                 k + base + (ok ? (size_t)(key0 + r) * d + c : 0), ok);
    }
    for (int i = tid; i < BK * vc; i += nt) {
      const int r = i / vc, c = (i % vc) * 8;
      const bool ok = key0 + r < n && c < d;
      cp_async16(vs + r * C::VS + c,
                 v + base + (ok ? (size_t)(key0 + r) * d + c : 0), ok);
    }
  };

#pragma unroll
  for (int s = 0; s < NST - 1; ++s) {
    if (s < ntiles) load_tile(s);
    cp_async_commit();
  }

  // Q: bf16(q · qscale) into shared memory, zero past n and d
  for (int i = tid; i < bq * (C::DQK / 8); i += nt) {
    const int r = i / (C::DQK / 8), c = (i % (C::DQK / 8)) * 8;
    uint4 w = make_uint4(0u, 0u, 0u, 0u);
    if (q0 + r < n && c < d) {
      const size_t off = base + (size_t)(q0 + r) * d + c;
      float f[8];
      if (q_f32) {
        const float4 a = *reinterpret_cast<const float4*>(
            static_cast<const float*>(qv) + off);
        const float4 b = *reinterpret_cast<const float4*>(
            static_cast<const float*>(qv) + off + 4);
        f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
        f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
      } else {
        const uint4 raw = *reinterpret_cast<const uint4*>(
            static_cast<const bf16*>(qv) + off);
        const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 x = __bfloat1622float2(h[e]);
          f[2 * e] = x.x;
          f[2 * e + 1] = x.y;
        }
      }
      w.x = pack_bf16(f[0] * qscale, f[1] * qscale);
      w.y = pack_bf16(f[2] * qscale, f[3] * qscale);
      w.z = pack_bf16(f[4] * qscale, f[5] * qscale);
      w.w = pack_bf16(f[6] * qscale, f[7] * qscale);
    }
    *reinterpret_cast<uint4*>(qs + r * C::QS + c) = w;
  }
  __syncthreads();

  // this warp's Q fragments (rows 16·wm …, all of q·kᵀ's depth; the
  // 8-deep last step's from lanes 0–15, one row each)
  const bf16* qw = qs + (wm * 16 + (lane & 15)) * C::QS + (lane >> 4) * 8;
  constexpr int QF = C::QREG && C::K16 > 0 ? C::K16 : 1;
  uint32_t qf[QF][4], qt[2];
  if (C::QREG) {
#pragma unroll
    for (int kk = 0; kk < C::K16; ++kk) ldm_x4(qf[kk], qw + kk * 16);
  }
  if (C::K8) ldm_x2(qt, qw + C::K16 * 16);

  float o[C::NV][4];
#pragma unroll
  for (int j = 0; j < C::NV; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};   // rows g and g + 8
  float l[2] = {0.f, 0.f};                       // this thread's partial sums

  // s = q · kᵀ for this warp's 16 rows × BKW keys of tile j, ragged keys
  // masked to −∞
  auto scores = [&](int j, float (&s)[C::NS][4]) {
    const bf16* ks = stages + (j % NST) * C::STAGE;
    const int key0 = (kt0 + j) * BK + wn * C::BKW;
#pragma unroll
    for (int i = 0; i < C::NS; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
    const bf16* kw = ks + (wn * C::BKW + (lane & 7) + ((lane >> 4) << 3)) * C::QS
                     + ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int kk = 0; kk < C::K16; ++kk) {
      uint32_t a[4];
      if (C::QREG) {
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = qf[C::QREG ? kk : 0][e];
      } else {
        ldm_x4(a, qw + kk * 16);
      }
#pragma unroll
      for (int np = 0; np < C::NS / 2; ++np) {
        uint32_t b[4];
        ldm_x4(b, kw + np * 16 * C::QS + kk * 16);
        mma_bf16(s[2 * np], a, b[0], b[1]);
        mma_bf16(s[2 * np + 1], a, b[2], b[3]);
      }
    }
    if (C::K8) {                    // lane i addresses key i of 32
      const bf16* kt = ks + (wn * C::BKW + lane) * C::QS + C::K16 * 16;
#pragma unroll
      for (int q4 = 0; q4 < C::NS / 4; ++q4) {
        uint32_t b[4];
        ldm_x4(b, kt + q4 * 32 * C::QS);
#pragma unroll
        for (int e = 0; e < 4; ++e) mma_bf16_k8(s[4 * q4 + e], qt, b[e]);
      }
    }
    if (key0 + C::BKW > n) {
#pragma unroll
      for (int i = 0; i < C::NS; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (key0 + i * 8 + 2 * t + (e & 1) >= n) s[i][e] = -CUDART_INF_F;
    }
  };

  // the online softmax of tile j's scores (in base 2), then o += bf16(p)·v
  auto softmax_pv = [&](int j, float (&s)[C::NS][4]) {
    const bf16* vs = stages + (j % NST) * C::STAGE + BK * C::QS;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < C::NS; ++i) {
      mx[0] = fmaxf(mx[0], fmaxf(s[i][0], s[i][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[i][2], s[i][3]));
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    }
    if (WN > 1) {                   // the maxima of the group's other warps
      if (t == 0) {
        red[(wm * 16 + g) * WN + wn] = mx[0];
        red[(wm * 16 + g + 8) * WN + wn] = mx[1];
      }
      named_barrier(1 + wm, 32 * WN);
#pragma unroll
      for (int w = 0; w < WN; ++w) {
        mx[0] = fmaxf(mx[0], red[(wm * 16 + g) * WN + w]);
        mx[1] = fmaxf(mx[1], red[(wm * 16 + g + 8) * WN + w]);
      }
    }
    // the group's first tile holds a valid key, so mx is finite from here
    const float ml0 = mx[0] * kLog2e, ml1 = mx[1] * kLog2e;
    const float corr0 = ex2(fmaf(m[0], kLog2e, -ml0));
    const float corr1 = ex2(fmaf(m[1], kLog2e, -ml1));
    m[0] = mx[0];
    m[1] = mx[1];
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int i = 0; i < C::NS; ++i) {
      s[i][0] = ex2(fmaf(s[i][0], kLog2e, -ml0));
      s[i][1] = ex2(fmaf(s[i][1], kLog2e, -ml0));
      s[i][2] = ex2(fmaf(s[i][2], kLog2e, -ml1));
      s[i][3] = ex2(fmaf(s[i][3], kLog2e, -ml1));
      rs0 += s[i][0] + s[i][1];
      rs1 += s[i][2] + s[i][3];
    }
    l[0] = l[0] * corr0 + rs0;
    l[1] = l[1] * corr1 + rs1;
#pragma unroll
    for (int i = 0; i < C::NV; ++i) {
      o[i][0] *= corr0;
      o[i][1] *= corr0;
      o[i][2] *= corr1;
      o[i][3] *= corr1;
    }
    if (WN > 1) {                   // the group's p through shared memory
      bf16* pw = ps + (wm * 16 + g) * C::PS + wn * C::BKW + 2 * t;
#pragma unroll
      for (int i = 0; i < C::NS; ++i) {
        *reinterpret_cast<uint32_t*>(pw + i * 8) = pack_bf16(s[i][0], s[i][1]);
        *reinterpret_cast<uint32_t*>(pw + 8 * C::PS + i * 8) =
            pack_bf16(s[i][2], s[i][3]);
      }
      named_barrier(1 + wm, 32 * WN);
    }
    const bf16* vw = vs + (lane & 15) * C::VS + wn * (C::NV * 8) + (lane >> 4) * 8;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[4];
      if (WN > 1) {
        ldm_x4(a, ps + (wm * 16 + (lane & 15)) * C::PS + kk * 16 + (lane >> 4) * 8);
      } else {                      // two key octets of s form one A fragment
        const int ia = (WN > 1) ? 0 : 2 * kk;
        a[0] = pack_bf16(s[ia][0], s[ia][1]);
        a[1] = pack_bf16(s[ia][2], s[ia][3]);
        a[2] = pack_bf16(s[ia + 1][0], s[ia + 1][1]);
        a[3] = pack_bf16(s[ia + 1][2], s[ia + 1][3]);
      }
#pragma unroll
      for (int jp = 0; jp < C::NV / 2; ++jp) {
        uint32_t b[4];
        ldm_x4_t(b, vw + kk * 16 * C::VS + jp * 16);
        mma_bf16(o[2 * jp], a, b[0], b[1]);
        mma_bf16(o[2 * jp + 1], a, b[2], b[3]);
      }
      if (C::NV % 2) {
        uint32_t b[2];
        ldm_x2_t(b, vs + (kk * 16 + (lane & 15)) * C::VS + wn * (C::NV * 8)
                        + (C::NV - 1) * 8);
        mma_bf16(o[C::NV - 1], a, b[0], b[1]);
      }
    }
  };

  for (int j = 0; j < ntiles; ++j) {
    cp_async_wait<NST - 2>();
    __syncthreads();                // tile j is here; tile j − 1 is consumed
    if (j + NST - 1 < ntiles) load_tile(j + NST - 1);
    cp_async_commit();
    float s[C::NS][4];
    scores(j, s);
    softmax_pv(j, s);
  }
  cp_async_wait<0>();

  // the row sums: over the 4 lanes of a row, then over the group's warps
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  if (WN > 1) {
    __syncthreads();                // every warp is done with red's maxima
    if (t == 0) {
      red[(wm * 16 + g) * WN + wn] = l[0];
      red[(wm * 16 + g + 8) * WN + wn] = l[1];
    }
    named_barrier(1 + wm, 32 * WN);
    l[0] = l[1] = 0.f;
#pragma unroll
    for (int w = 0; w < WN; ++w) {  // in warp order: the same in each warp
      l[0] += red[(wm * 16 + g) * WN + w];
      l[1] += red[(wm * 16 + g + 8) * WN + w];
    }
  }

  const int row[2] = {q0 + wm * 16 + g, q0 + wm * 16 + g + 8};
  const int col0 = wn * (C::NV * 8) + 2 * t;
  if (gridDim.y == 1) {             // normalised, in q's dtype
    const float inv[2] = {1.f / l[0], 1.f / l[1]};
#pragma unroll
    for (int i = 0; i < C::NV; ++i) {
      const int col = col0 + i * 8;
      if (col >= d) continue;       // d is even: col + 1 < d too
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (row[r] >= n) continue;
        const size_t off = base + (size_t)row[r] * d + col;
        const float x = o[i][2 * r] * inv[r], y = o[i][2 * r + 1] * inv[r];
        if (q_f32)
          *reinterpret_cast<float2*>(static_cast<float*>(outv) + off) =
              make_float2(x, y);
        else
          *reinterpret_cast<uint32_t*>(static_cast<bf16*>(outv) + off) =
              pack_bf16(x, y);
      }
    }
  } else {                          // this split's unnormalised O, max, sum
    const size_t pbase = (size_t)blockIdx.y * gridDim.z * n * d + base;
#pragma unroll
    for (int i = 0; i < C::NV; ++i) {
      const int col = col0 + i * 8;
      if (col >= d) continue;
#pragma unroll
      for (int r = 0; r < 2; ++r)
        if (row[r] < n)
          *reinterpret_cast<float2*>(part + pbase + (size_t)row[r] * d + col) =
              make_float2(o[i][2 * r], o[i][2 * r + 1]);
    }
    if (wn == 0 && t == 0) {
      const size_t mbase = ((size_t)blockIdx.y * gridDim.z + blockIdx.z) * n;
#pragma unroll
      for (int r = 0; r < 2; ++r)
        if (row[r] < n)
          *reinterpret_cast<float2*>(ml + 2 * (mbase + row[r])) =
              make_float2(m[r], l[r]);
    }
  }
}

// out[b, i, c] = Σ_s 2^((m_s − M)·log2e) O_s[b, i, c] / Σ_s 2^(…) l_s, M =
// max_s m_s, the splits summed in order; one thread per 8 columns.
__global__ void __launch_bounds__(256)
attn_merge(const float* __restrict__ part, const float* __restrict__ ml,
           void* __restrict__ outv, int split, int bh, int n, int d,
           int q_f32) {
  const int c8 = d / 8;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)bh * n * c8) return;
  const size_t rowi = idx / c8;                 // b·n + i
  const int c = (int)(idx % c8) * 8;
  const size_t rows = (size_t)bh * n;
  float mmax = -CUDART_INF_F;
  for (int s = 0; s < split; ++s) mmax = fmaxf(mmax, ml[2 * (s * rows + rowi)]);
  const float mlog = mmax * kLog2e;
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  float lsum = 0.f;
  for (int s = 0; s < split; ++s) {
    const float2 st = *reinterpret_cast<const float2*>(ml + 2 * (s * rows + rowi));
    const float w = ex2(fmaf(st.x, kLog2e, -mlog));
    lsum = fmaf(w, st.y, lsum);
    const float4* src = reinterpret_cast<const float4*>(
        part + (s * rows + rowi) * d + c);
    const float4 a = src[0], b = src[1];
    acc[0] = fmaf(w, a.x, acc[0]);
    acc[1] = fmaf(w, a.y, acc[1]);
    acc[2] = fmaf(w, a.z, acc[2]);
    acc[3] = fmaf(w, a.w, acc[3]);
    acc[4] = fmaf(w, b.x, acc[4]);
    acc[5] = fmaf(w, b.y, acc[5]);
    acc[6] = fmaf(w, b.z, acc[6]);
    acc[7] = fmaf(w, b.w, acc[7]);
  }
  const float inv = 1.f / lsum;
  const size_t off = rowi * d + c;
  if (q_f32) {
    float4* dst = reinterpret_cast<float4*>(static_cast<float*>(outv) + off);
    dst[0] = make_float4(acc[0] * inv, acc[1] * inv, acc[2] * inv, acc[3] * inv);
    dst[1] = make_float4(acc[4] * inv, acc[5] * inv, acc[6] * inv, acc[7] * inv);
  } else {
    uint4 w;
    w.x = pack_bf16(acc[0] * inv, acc[1] * inv);
    w.y = pack_bf16(acc[2] * inv, acc[3] * inv);
    w.z = pack_bf16(acc[4] * inv, acc[5] * inv);
    w.w = pack_bf16(acc[6] * inv, acc[7] * inv);
    *reinterpret_cast<uint4*>(static_cast<bf16*>(outv) + off) = w;
  }
}

template <int DV8, int WN, int BK, int NST, int MINB = 1>
int launch(const void* q, const bf16* k, const bf16* v, void* out,
           float* part, float* ml, int bh, int n, int d, int q_f32,
           float qscale, int wm, int split, cudaStream_t stream) {
  using C = Cfg<DV8, WN, BK, NST>;
  if (wm < 1 || 32 * wm * WN > 256 || split < 1 ||
      key_ranges(n, BK, split) != split)
    return (int)cudaErrorInvalidValue;
  const size_t smem = C::smem_bytes(wm);
  auto kernel = attn_fwd<DV8, WN, BK, NST, MINB>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n + 16 * wm - 1) / (16 * wm), split, bh);
  kernel<<<grid, 32 * wm * WN, smem, stream>>>(q, k, v, out, part, ml, n, d,
                                               q_f32, qscale);
  err = cudaGetLastError();
  if (err != cudaSuccess || split == 1) return (int)err;
  const size_t threads = (size_t)bh * n * (d / 8);
  attn_merge<<<(unsigned)((threads + 255) / 256), 256, 0, stream>>>(
      part, ml, out, split, bh, n, d, q_f32);
  return (int)cudaGetLastError();
}

}  // namespace

// q [bh, n, d] bf16 (f32 when q_f32), k, v [bh, n, d] bf16, out [bh, n, d]
// in q's dtype; all contiguous, 16-byte aligned. qscale: the softmax scale
// rounded to q's dtype. wm and split as gbnerf_attention_plan gives them:
// wm 16-row groups a block, one warp each at D ≤ 128 (1…8), two above
// (1…4); split key ranges across blocks, each holding a key tile. With
// split > 1, part [split, bh, n, d] f32 and ml [split, bh, n, 2] f32 are
// scratch. d % 8 == 0, 8 ≤ d ≤ 512, bh ≤ 65535. Returns the cudaError_t
// of the launches (0 = success).
extern "C" int gbnerf_attention_fwd(const void* q, const void* k,
                                    const void* v, void* out, void* part,
                                    void* ml, int bh, int n, int d, int q_f32,
                                    float qscale, int wm, int split,
                                    void* stream) {
  if (bh == 0 || n == 0) return 0;
  if (d % 8 || d < 8 || d > 512) return (int)cudaErrorInvalidValue;
  const bf16* K = static_cast<const bf16*>(k);
  const bf16* V = static_cast<const bf16*>(v);
  float* P = static_cast<float*>(part);
  float* M = static_cast<float*>(ml);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define GBNERF_ATTN_SMALL(D8)                                                 \
  case D8:                                                                    \
    return launch<D8, 1, key_tile(D8 * 8), kStages, min_blocks(D8 * 8)>(      \
        q, K, V, out, P, M, bh, n, d, q_f32, qscale, wm, split, s);
  switch (d / 8) {
    GBNERF_ATTN_SMALL(1)
    GBNERF_ATTN_SMALL(2)
    GBNERF_ATTN_SMALL(3)
    GBNERF_ATTN_SMALL(4)
    GBNERF_ATTN_SMALL(5)
    GBNERF_ATTN_SMALL(6)
    GBNERF_ATTN_SMALL(7)
    GBNERF_ATTN_SMALL(8)
    GBNERF_ATTN_SMALL(9)
    GBNERF_ATTN_SMALL(10)
    GBNERF_ATTN_SMALL(11)
    GBNERF_ATTN_SMALL(12)
    GBNERF_ATTN_SMALL(13)
    GBNERF_ATTN_SMALL(14)
    GBNERF_ATTN_SMALL(15)
    GBNERF_ATTN_SMALL(16)
    default:
      break;
  }
#undef GBNERF_ATTN_SMALL
  constexpr int bk = key_tile(512);
  if (d <= 256)
    return launch<32, 2, bk, kStages>(q, K, V, out, P, M, bh, n, d, q_f32,
                                      qscale, wm, split, s);
  if (d <= 384)
    return launch<48, 2, bk, kStages>(q, K, V, out, P, M, bh, n, d, q_f32,
                                      qscale, wm, split, s);
  return launch<64, 2, bk, kStages>(q, K, V, out, P, M, bh, n, d, q_f32,
                                    qscale, wm, split, s);
}

// K7's launch plan at [bh, n, d] on a card of sm_count SMs: plan[0] = wm,
// plan[1] = split, each taken as given where > 0 and chosen where 0.
// D ≤ 128: 128-row blocks (wm 8) where they give at least 90 % of the SMs
// one block, else 64-row ones (wm 4); keys unsplit. D > 128: 64-row
// blocks (wm 4, two warps a group); the keys split in two where the query
// tiles alone give no SM a second block (the VAE's 64 tiles → 128
// blocks). The split is then cut to its key ranges (key_ranges), so that
// every range holds a tile. Returns 0, or cudaErrorInvalidValue for a
// shape or wm the kernel does not take.
extern "C" int gbnerf_attention_plan(int bh, int n, int d, int sm_count,
                                     int* plan) {
  if (bh < 1 || n < 1 || d % 8 || d < 8 || d > 512)
    return (int)cudaErrorInvalidValue;
  const bool small = d <= kSmallD;
  int wm = plan[0], split = plan[1];
  if (wm <= 0)
    wm = small && 10 * ((n + 127) / 128) * bh >= 9 * sm_count ? 8 : 4;
  if (split <= 0)
    split = !small && ((n + 63) / 64) * bh <= sm_count ? 2 : 1;
  if (32 * wm * (small ? 1 : 2) > 256) return (int)cudaErrorInvalidValue;
  plan[0] = wm;
  plan[1] = key_ranges(n, key_tile(d), split);
  return 0;
}
