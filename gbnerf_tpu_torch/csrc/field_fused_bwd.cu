// Fused CP-field backward for Hopper (sm_90a): every cotangent in one pass.
//
// Replaces the TPU kernels gbnerf_tpu/ops/field_fused.py::_kernel_bwd (K4,
// the full field) and ::_kernel_bwd_sigma (K5, the σ-only variant), one
// templated source with SIGMA_ONLY as the flag, as K1/K2 are.
//
// What it computes, per point p, given the output cotangent g [N, 4]
// (rgb ⊕ σ): it recomputes K1's forward (2-tap encode, h0, h1, hc, h2, h3)
// and runs the head backward
//   dh3 = wc2·g_rgb ⊙ [h3>0]     dh2 = wc1·dh3 ⊙ [h2>0]   dhc = wc0·dh2
//   dsh = dhc[:16]                dh1 = [g_σ, dhc[16:]]
//   dh0 = ws1·dh1 ⊙ [h0>0]        dprod = ws0·dh0  [F]
// then the encode backward, per axis a: dfa = bf16(dprod ⊙ fa_b ⊙ fa_c);
// dlines[a] gets dfa·w at the two taps; du = Σ_taps (line·dfa)·sign(r − u)
// ·[|r − u| < 1]; dx_a = du·(R_max − 1)·[0 < x_a < 1]. The weight
// gradients are sums over points of outer products, dW = Σ_p a_p ⊗ b_p.
// The TPU kernel's rounding is kept: every matmul operand is bf16 (the
// cotangents and the activations of the outer products included), every
// sum f32; the ties are its ties (du = 0 at a grid node, dx = 0 for a
// clipped coordinate that still adds to dlines, K1's first-tap clamp).
// K5: dh1 = [g_σ, 0…]; no colour head, no dsh, no dwc*.
//
// What bounds it on the H100, at the stage-1 fine pass (131,072 points,
// F 80, R_max 257): per point ≈ 13 k FMAs of forward recompute, ≈ 12 k of
// head backward and ≈ 12 k of weight-gradient outer products, all scalar
// f32 on the CUDA cores; and 480 additions into dlines per point (2 taps ×
// F × 3 axes), which land on only 3·257·80 addresses.
//
// Design against that:
// - One thread per point for the per-point phases, weights read as
//   warp-uniform float4 loads through L1 (no room for them in shared
//   memory beside the tile buffer).
// - The weight gradients need the whole tile's activations and cotangents:
//   each thread writes its point's bf16 operands into a [row][point] tile
//   buffer in shared memory (516 rows × 128 points at F 80, 134 KB; the row
//   stride of 130 elements puts consecutive rows on consecutive banks), and
//   after a barrier every thread owns 4 × 4 blocks of the dW outputs and
//   sums them over the tile's points (two points per bf16x2 load). The
//   partial dW of a block lives in shared memory (50 KB) across all of the
//   block's tiles (blocks are persistent).
// - The encode backward runs after the dW phase, so its per-point dfa
//   (bf16-rounded, so exact in bf16) and tap weights can take the tile
//   buffer's freed rows.
//
// Determinism: every sum is taken in an order fixed by the inputs alone,
// so the same inputs give bit-equal dx, dsh, dlines and dW on every call.
// There is no atomic in this source.
// - dlines: each persistent block owns a [3, R_max, F] f32 slice of a
//   scratch buffer (≈ 32.6 MB at 132 blocks, which L2's 50 MB holds). Per
//   tile, the 256 (point, tap) contributions of each axis are sorted by
//   (row, tap, point) in shared memory (a bitonic network); each run of one
//   row is summed in that order and added to the block's slice, one owner
//   thread per (row, 4 features), so no two threads touch one address
//   within a tile and barriers order the tiles. The flush issues four
//   independent float4 read-add-writes at a time to hide L2 latency.
//   (Route (a) of the two fixed-order routes; the other, writing dfa
//   [3, N, F] to memory and bucketing the points by row with a counting
//   sort, moves ≈ 126 MB more a call and needs three more launches in a
//   step that is host-bound.)
// - dW: each block writes its shared-memory partial to its own row of the
//   same scratch buffer.
// - A second kernel (field_bwd_reduce) sums the blocks' rows in block
//   order into the outputs. The grid depends only on N, the SM count and
//   the occupancy, all fixed for one card and one shape.
// Cost (NVIDIA H100 80GB HBM3 at 700 W, chip_smoke.py): K4 at the fine pass
// 3.700 ms against 3.768 with the atomics, K5 at 65,536 points 0.389 ms
// against 0.598; the reduce ≈ 0.03 ms a call.

#include "field_common.cuh"

namespace {

constexpr int kT = 128;          // points per tile = threads per block
constexpr int kTP = kT + 2;      // tile-buffer row stride (bf16): 65 words
constexpr int kC = 2 * kT;       // (point, tap) contributions of an axis
constexpr unsigned kNoRow = 0xffffffffu;   // sort key of a point past N

// rows of the bf16 tile buffer and float offsets of the dW accumulators;
// the encode backward's region (byte offsets) reuses the buffer's rows
// once the dW phase has read them
struct Layout {
  int rP, rA0, rHC, rA2, rA3, rG, rD3, rD2, rD1, rD0, rows;
  int aWs0, aWs1, aWc0, aWc1, aWc2, acc;
  int dfs;                         // dfa row stride (bf16): [point][3F + 4]
  int eWt, eKeys, eHeads, eNseg;   // tap weights [3][2][kT] f32, sort keys
                                   // [3][kC] u32, run heads [3·kC] int, count
};

// the encode region after the dfa rows, and the rows that hold it all
__host__ __device__ inline Layout finish_layout(Layout L, int feat) {
  L.dfs = 3 * feat + 4;
  L.eWt = kT * L.dfs * 2;
  L.eKeys = L.eWt + 6 * kT * 4;
  L.eHeads = L.eKeys + 3 * kC * 4;
  L.eNseg = L.eHeads + 3 * kC * 4;
  const int rows = (L.eNseg + 16 + kTP * 2 - 1) / (kTP * 2);
  if (L.rows < rows) L.rows = rows;
  return L;
}

__host__ __device__ inline Layout make_layout(int feat, bool sigma_only) {
  Layout L{};
  L.rP = 0;                      // bf16(prod)            [F]
  L.rA0 = feat;                  // bf16(relu h0)         [64]
  L.aWs0 = 0;                    // dws0 [F][64]
  L.aWs1 = feat * 64;            // dws1 [64][16]
  if (sigma_only) {
    L.rD1 = feat + 64;           // bf16(dh1)             [16]
    L.rD0 = feat + 80;           // bf16(dh0)             [64]
    L.rows = feat + 144;
    L.acc = feat * 64 + 1024;
    return finish_layout(L, feat);
  }
  L.rHC = feat + 64;             // hc (SH ⊕ geo), row 31 zero   [32]
  L.rA2 = feat + 96;             // bf16(relu h2)         [64]
  L.rA3 = feat + 160;            // bf16(relu h3)         [64]
  L.rG = feat + 224;             // bf16(g_rgb), row 3 zero      [4]
  L.rD3 = feat + 228;            // bf16(dh3)             [64]
  L.rD2 = feat + 292;            // bf16(dh2)             [64]
  L.rD1 = feat + 356;            // bf16(dh1)             [16]
  L.rD0 = feat + 372;            // bf16(dh0)             [64]
  L.rows = feat + 436;
  L.aWc0 = L.aWs1 + 1024;        // dwc0 [32][64] (row 31 padding)
  L.aWc1 = L.aWc0 + 2048;        // dwc1 [64][64]
  L.aWc2 = L.aWc1 + 4096;        // dwc2 [64][4]  (column 3 padding)
  L.acc = L.aWc2 + 256;
  return finish_layout(L, feat);
}

__host__ __device__ inline size_t smem_bytes(const Layout& L) {
  return (size_t)L.rows * kTP * sizeof(__nv_bfloat16)
         + (size_t)L.acc * sizeof(float);
}

// One weight gradient: dW[i][o] = Σ_points A[i] · B[o], A and B rows of the
// tile buffer; I × O padded to multiples of 4 in the accumulator, I_real ×
// O_real in the output (Dense [in, out], at float offset `out`).
struct Mat {
  int a, I, b, O, acc, out, I_real, O_real;
};

__device__ __forceinline__ void put(__nv_bfloat16* S, int row, int t,
                                    float v) {
  S[row * kTP + t] = __float2bfloat16(v);   // v is bf16 already: exact
}

__device__ __forceinline__ float tie_sign(float d) {
  // sign(d)·[|d| < 1]: the derivative of relu(1 − |d|) in u, 0 at d = 0
  return fabsf(d) < 1.f ? (d > 0.f ? 1.f : (d < 0.f ? -1.f : 0.f)) : 0.f;
}

// floats of the dW outputs (the five weights, Dense [in, out], one after
// the other; the σ-net's two when sigma_only)
__host__ __device__ inline int dw_size(int feat, bool sigma_only) {
  const int sigma = feat * kSigmaWidth + kSigmaWidth * kGeo;
  return sigma_only ? sigma
                    : sigma + kColorIn * kColorWidth + kColorWidth * kColorWidth
                          + kColorWidth * 3;
}

// Add one tile's dlines to the block's slice, in a fixed order. keys[a][c]
// holds (row << 8) | (tap << 7) | point for the tile's 2·kT contributions
// to axis a (kNoRow for points past N); dfa [point][dfs] bf16 and the tap
// weights wt[a][tap][point] hold their values. The keys are sorted, each
// run of one row summed in key order, and each (axis, row, 4 features) of
// the slice gets one read-add-write by one thread.
__device__ void flush_dlines(unsigned* keys, int* heads, int* nseg,
                             const float* wt, const __nv_bfloat16* dfa,
                             int dfs, float* slice, int r_max, int feat) {
  const int t = threadIdx.x;
  // bitonic sort of the three axes' kC keys, ascending; kT threads each
  // compare-exchange one pair of every axis per step
  for (int k = 2; k <= kC; k <<= 1)
    for (int j = k >> 1; j > 0; j >>= 1) {
      const int i = 2 * t - (t & (j - 1)), l = i + j;
      const bool up = (i & k) == 0;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const unsigned u = keys[a * kC + i], v = keys[a * kC + l];
        if ((u > v) == up) {
          keys[a * kC + i] = v;
          keys[a * kC + l] = u;
        }
      }
      __syncthreads();
    }
  // the heads of the runs of equal rows, in order (one warp)
  if (t < 32) {
    int count = 0;
    for (int grp = 0; grp < 3 * kC / 32; ++grp) {
      const int a = grp / (kC / 32), i = (grp % (kC / 32)) * 32 + t;
      const unsigned row = keys[a * kC + i] >> 8;
      const bool head = row < (unsigned)r_max
                        && (i == 0 || (keys[a * kC + i - 1] >> 8) != row);
      const unsigned mask = __ballot_sync(0xffffffffu, head);
      if (head) heads[count + __popc(mask & ((1u << t) - 1u))] = a * kC + i;
      count += __popc(mask);
    }
    if (t == 0) *nseg = count;
  }
  __syncthreads();
  const int f4 = feat / 4, n_items = *nseg * f4;
  for (int b = t; b < n_items; b += 4 * kT) {
    float4 add[4];
    int off[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int it = b + u * kT;
      off[u] = -1;
      add[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (it < n_items) {
        const int h = heads[it / f4], c = it % f4;
        const int a = h / kC;
        const unsigned row = keys[h] >> 8;
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
        for (int i = h; i < (a + 1) * kC && (keys[i] >> 8) == row; ++i) {
          const unsigned key = keys[i];
          const int pt = key & (kT - 1), tap = (key >> 7) & 1;
          const float w = wt[(2 * a + tap) * kT + pt];
          float d[4];
          unpack4(*reinterpret_cast<const uint2*>(dfa + pt * dfs + a * feat
                                                  + 4 * c), d);
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[q] = fmaf(d[q], w, acc[q]);
        }
        off[u] = (a * r_max + (int)row) * feat + 4 * c;
        add[u] = make_float4(acc[0], acc[1], acc[2], acc[3]);
      }
    }
    float4 old[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (off[u] >= 0) old[u] = *reinterpret_cast<const float4*>(slice + off[u]);
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (off[u] >= 0)
        *reinterpret_cast<float4*>(slice + off[u]) =
            make_float4(old[u].x + add[u].x, old[u].y + add[u].y,
                        old[u].z + add[u].z, old[u].w + add[u].w);
  }
}

template <bool kSigmaOnly>
__global__ void __launch_bounds__(kT, 1)
field_bwd_kernel(const float* __restrict__ x, const float* __restrict__ sh,
                 const float* __restrict__ g,
                 const __nv_bfloat16* __restrict__ lines,
                 const float* __restrict__ wpack, float* __restrict__ dx,
                 float* __restrict__ dsh, float* __restrict__ scratch,
                 int n, int r_max, int feat) {
  extern __shared__ float4 smem4[];
  const Layout L = make_layout(feat, kSigmaOnly);
  __nv_bfloat16* S = reinterpret_cast<__nv_bfloat16*>(smem4);
  char* base = reinterpret_cast<char*>(smem4);
  float* acc = reinterpret_cast<float*>(base + (size_t)L.rows * kTP * 2);
  // the encode region (after the dW phase): dfa [point][3F + 4] bf16, tap
  // weights, sort keys, run heads
  __nv_bfloat16* dfa = S;
  float* wt = reinterpret_cast<float*>(base + L.eWt);
  unsigned* keys = reinterpret_cast<unsigned*>(base + L.eKeys);
  int* heads = reinterpret_cast<int*>(base + L.eHeads);
  int* nseg = reinterpret_cast<int*>(base + L.eNseg);
  const int t = threadIdx.x;
  for (int i = t; i < L.acc; i += kT) acc[i] = 0.f;
  // this block's rows of the scratch buffer: its dlines slice [3, R_max, F]
  // (summed into, so zeroed here), then its dW partial
  const int n_dl = 3 * r_max * feat;
  float* slice = scratch + (size_t)blockIdx.x * (n_dl + dw_size(feat, kSigmaOnly));
  for (int i = t; i < n_dl / 4; i += kT)
    reinterpret_cast<float4*>(slice)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  const float* ws0 = wpack;                     // [F][64]
  const float* ws1 = wpack + feat * kSigmaWidth;  // [64][16]
  const float* wc0 = ws1 + kOffWc0;             // [31][64]
  const float* wc1t = ws1 + kOffWc1;            // [64 out][64 in]
  const float4* wc2 = reinterpret_cast<const float4*>(ws1 + kOffWc2);

  Mat mats[5];
  mats[0] = {L.rP, feat, L.rD0, 64, L.aWs0, 0, feat, 64};
  mats[1] = {L.rA0, 64, L.rD1, 16, L.aWs1, feat * 64, 64, 16};
  const int n_mats = kSigmaOnly ? 2 : 5;
  if (!kSigmaOnly) {
    const int o = feat * 64 + 1024;
    mats[2] = {L.rHC, 32, L.rD2, 64, L.aWc0, o, 31, 64};
    mats[3] = {L.rA2, 64, L.rD3, 64, L.aWc1, o + 31 * 64, 64, 64};
    mats[4] = {L.rA3, 64, L.rG, 4, L.aWc2, o + 31 * 64 + 4096, 64, 3};
  }
  int n_jobs = 0;
  for (int m = 0; m < n_mats; ++m) n_jobs += (mats[m].I / 4) * (mats[m].O / 4);

  const int tiles = (n + kT - 1) / kT;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int p = tile * kT + t;
    const bool live = p < n;
    if (!kSigmaOnly) {    // the padding rows (the encode region overlaps them)
      put(S, L.rHC + 31, t, 0.f);
      put(S, L.rG + 3, t, 0.f);
    }
    // A thread past the end computes on x = 0.5, sh = 0, g = 0: every
    // cotangent row it writes is then 0, so its outer products add 0; it
    // stores nothing and adds nothing to dlines.

    // ---- forward recompute: encode taps as K1
    float xa[3], w0[3], w1[3], s0[3], s1[3];
    int i0[3];
    const __nv_bfloat16* row0[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      xa[a] = live ? x[3 * p + a] : 0.5f;
      const CpTap tap = cp_tap(xa[a], r_max);
      w0[a] = tap.w0;
      w1[a] = tap.w1;
      s0[a] = tie_sign(tap.d0);
      s1[a] = tie_sign(tap.d1);
      i0[a] = tap.i0;
      row0[a] = lines + ((size_t)a * r_max + tap.i0) * feat;
    }

    // ---- h0 = relu(bf16(prod) @ ws0); prod rows to the tile buffer
    float h0[kSigmaWidth];
#pragma unroll
    for (int j = 0; j < kSigmaWidth; ++j) h0[j] = 0.f;
    for (int f = 0; f < feat; f += 4) {
      float e[4] = {1.f, 1.f, 1.f, 1.f};
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        float l0[4], l1[4];
        unpack4(__ldg(reinterpret_cast<const uint2*>(row0[a] + f)), l0);
        unpack4(__ldg(reinterpret_cast<const uint2*>(row0[a] + feat + f)), l1);
#pragma unroll
        for (int k = 0; k < 4; ++k) e[k] *= fmaf(w1[a], l1[k], w0[a] * l0[k]);
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float pb = bf16_round(e[k]);
        put(S, L.rP + f + k, t, pb);
        axpy64(h0, pb, ws0 + (f + k) * kSigmaWidth);
      }
    }

    // ---- A0 = bf16(relu h0) and its mask; h1 = A0 @ ws1 (full field)
    uint64_t m0 = 0;
    float h1[kGeo];
#pragma unroll
    for (int j = 0; j < kGeo; ++j) h1[j] = 0.f;
#pragma unroll
    for (int j = 0; j < kSigmaWidth; ++j) {
      m0 |= (uint64_t)(h0[j] > 0.f) << j;
      const float a = bf16_round(fmaxf(h0[j], 0.f));
      put(S, L.rA0 + j, t, a);
      if (!kSigmaOnly) {
        const float4* w4 = reinterpret_cast<const float4*>(ws1 + j * kGeo);
#pragma unroll
        for (int q = 0; q < kGeo / 4; ++q) {
          const float4 v = w4[q];
          h1[4 * q + 0] = fmaf(a, v.x, h1[4 * q + 0]);
          h1[4 * q + 1] = fmaf(a, v.y, h1[4 * q + 1]);
          h1[4 * q + 2] = fmaf(a, v.z, h1[4 * q + 2]);
          h1[4 * q + 3] = fmaf(a, v.w, h1[4 * q + 3]);
        }
      }
    }

    const float4 gv = live ? reinterpret_cast<const float4*>(g)[p]
                           : make_float4(0.f, 0.f, 0.f, 0.f);
    float db0[kSigmaWidth];       // bf16(dh0)
    if (kSigmaOnly) {
      // ---- K5 head backward: dh1 = [g_σ, 0…], dh0 = ws1[:, 0]·g_σ ⊙ mask
      const float gb = bf16_round(gv.w);
      put(S, L.rD1, t, gb);
#pragma unroll
      for (int o = 1; o < kGeo; ++o) put(S, L.rD1 + o, t, 0.f);
#pragma unroll
      for (int i = 0; i < kSigmaWidth; ++i) {
        const float d = ((m0 >> i) & 1) ? ws1[i * kGeo] * gb : 0.f;
        db0[i] = bf16_round(d);
        put(S, L.rD0 + i, t, db0[i]);
      }
    } else {
      // ---- hc = bf16(SH) ⊕ bf16(h1[1:]); h2 = relu(hc @ wc0)
      float h2[kColorWidth];
#pragma unroll
      for (int j = 0; j < kColorWidth; ++j) h2[j] = 0.f;
      const float4* sh4 = reinterpret_cast<const float4*>(sh + (size_t)p * kSh);
#pragma unroll
      for (int q = 0; q < kSh / 4; ++q) {
        const float4 s4 = live ? __ldg(sh4 + q)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
        const float sv[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float v = bf16_round(sv[k]);
          put(S, L.rHC + 4 * q + k, t, v);
          axpy64(h2, v, wc0 + (4 * q + k) * kColorWidth);
        }
      }
#pragma unroll
      for (int i = 1; i < kGeo; ++i) {
        const float v = bf16_round(h1[i]);
        put(S, L.rHC + kSh + i - 1, t, v);
        axpy64(h2, v, wc0 + (kSh + i - 1) * kColorWidth);
      }
      uint64_t m2 = 0;
#pragma unroll
      for (int j = 0; j < kColorWidth; ++j) {
        m2 |= (uint64_t)(h2[j] > 0.f) << j;
        h2[j] = bf16_round(fmaxf(h2[j], 0.f));
        put(S, L.rA2 + j, t, h2[j]);
      }

      // ---- h3 = relu(A2 @ wc1), one output at a time (K1's order)
      uint64_t m3 = 0;
#pragma unroll 2
      for (int k = 0; k < kColorWidth; ++k) {
        const float h3 = dot64(wc1t + k * kColorWidth, h2);
        m3 |= (uint64_t)(h3 > 0.f) << k;
        put(S, L.rA3 + k, t, bf16_round(fmaxf(h3, 0.f)));
      }

      // ---- head backward: dh3 = wc2·bf16(g_rgb) ⊙ mask, folded at once
      // into dh2 += bf16(dh3_k)·wc1[:, k]
      const float gr0 = bf16_round(gv.x), gr1 = bf16_round(gv.y),
                  gr2 = bf16_round(gv.z);
      put(S, L.rG + 0, t, gr0);
      put(S, L.rG + 1, t, gr1);
      put(S, L.rG + 2, t, gr2);
      float dh2[kColorWidth];
#pragma unroll
      for (int j = 0; j < kColorWidth; ++j) dh2[j] = 0.f;
#pragma unroll 2
      for (int k = 0; k < kColorWidth; ++k) {
        const float4 c = wc2[k];
        float d = fmaf(c.z, gr2, fmaf(c.y, gr1, c.x * gr0));
        d = ((m3 >> k) & 1) ? d : 0.f;
        const float db = bf16_round(d);
        put(S, L.rD3 + k, t, db);
        axpy64(dh2, db, wc1t + k * kColorWidth);
      }
#pragma unroll
      for (int i = 0; i < kColorWidth; ++i) {
        dh2[i] = bf16_round(((m2 >> i) & 1) ? dh2[i] : 0.f);
        put(S, L.rD2 + i, t, dh2[i]);
      }

      // ---- dhc = wc0·bf16(dh2): dsh = dhc[:16], dh1 = [g_σ, dhc[16:]]
      float dh1[kGeo];
      dh1[0] = bf16_round(gv.w);
#pragma unroll
      for (int q = 0; q < kSh / 4; ++q) {
        float v[4];
#pragma unroll
        for (int k = 0; k < 4; ++k)
          v[k] = dot64(wc0 + (4 * q + k) * kColorWidth, dh2);
        if (dsh != nullptr && live)
          reinterpret_cast<float4*>(dsh + (size_t)p * kSh)[q] =
              make_float4(v[0], v[1], v[2], v[3]);
      }
#pragma unroll
      for (int i = 1; i < kGeo; ++i)
        dh1[i] = bf16_round(dot64(wc0 + (kSh + i - 1) * kColorWidth, dh2));
#pragma unroll
      for (int o = 0; o < kGeo; ++o) put(S, L.rD1 + o, t, dh1[o]);

      // ---- dh0 = ws1·bf16(dh1) ⊙ mask
#pragma unroll
      for (int i = 0; i < kSigmaWidth; ++i) {
        const float4* w4 = reinterpret_cast<const float4*>(ws1 + i * kGeo);
        float d = 0.f;
#pragma unroll
        for (int q = 0; q < kGeo / 4; ++q) {
          const float4 v = w4[q];
          d = fmaf(v.x, dh1[4 * q + 0], d);
          d = fmaf(v.y, dh1[4 * q + 1], d);
          d = fmaf(v.z, dh1[4 * q + 2], d);
          d = fmaf(v.w, dh1[4 * q + 3], d);
        }
        db0[i] = bf16_round(((m0 >> i) & 1) ? d : 0.f);
        put(S, L.rD0 + i, t, db0[i]);
      }
    }

    __syncthreads();

    // ---- weight gradients: each thread owns fixed 4 × 4 output blocks and
    // sums them over the tile's points; rows of a block are I/4 apart, so
    // neighbouring threads read neighbouring rows (distinct banks)
    for (int job = t; job < n_jobs; job += kT) {
      int m = 0, jj = job;
      while (jj >= (mats[m].I / 4) * (mats[m].O / 4)) {
        jj -= (mats[m].I / 4) * (mats[m].O / 4);
        ++m;
      }
      const Mat M = mats[m];
      const int I4 = M.I / 4, O4 = M.O / 4;
      const int ia = jj % I4, ob = jj / I4;
      const __nv_bfloat162* ar[4];
      const __nv_bfloat162* br[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        ar[q] = reinterpret_cast<const __nv_bfloat162*>(
            S + (M.a + ia + I4 * q) * kTP);
        br[q] = reinterpret_cast<const __nv_bfloat162*>(
            S + (M.b + ob + O4 * q) * kTP);
      }
      float c[16];
#pragma unroll
      for (int q = 0; q < 16; ++q) c[q] = 0.f;
#pragma unroll 4
      for (int pp = 0; pp < kT / 2; ++pp) {
        float2 av[4], bv[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          av[q] = __bfloat1622float2(ar[q][pp]);
          bv[q] = __bfloat1622float2(br[q][pp]);
        }
#pragma unroll
        for (int ii = 0; ii < 4; ++ii)
#pragma unroll
          for (int oo = 0; oo < 4; ++oo) {
            c[4 * ii + oo] = fmaf(av[ii].x, bv[oo].x, c[4 * ii + oo]);
            c[4 * ii + oo] = fmaf(av[ii].y, bv[oo].y, c[4 * ii + oo]);
          }
      }
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int oo = 0; oo < 4; ++oo)
          acc[M.acc + (ia + I4 * ii) * M.O + ob + O4 * oo] += c[4 * ii + oo];
    }
    __syncthreads();

    // ---- encode backward, feature by feature: dprod_f = ws0[f]·bf16(dh0).
    // Every thread takes its dh0 back from the tile buffer before the dfa
    // rows overwrite it.
#pragma unroll
    for (int i = 0; i < kSigmaWidth; ++i)
      db0[i] = __bfloat162float(S[(L.rD0 + i) * kTP + t]);
    __syncthreads();
    float dm0[3] = {0.f, 0.f, 0.f}, dm1[3] = {0.f, 0.f, 0.f};
    for (int f = 0; f < feat; f += 4) {
      float dp[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) dp[k] = dot64(ws0 + (f + k) * kSigmaWidth, db0);
      float l0[3][4], l1[3][4], fa[3][4];
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        unpack4(__ldg(reinterpret_cast<const uint2*>(row0[a] + f)), l0[a]);
        unpack4(__ldg(reinterpret_cast<const uint2*>(row0[a] + feat + f)), l1[a]);
#pragma unroll
        for (int k = 0; k < 4; ++k)
          fa[a][k] = fmaf(w1[a], l1[a][k], w0[a] * l0[a][k]);
      }
      float dfv[3][4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        dfv[0][k] = bf16_round((dp[k] * fa[1][k]) * fa[2][k]);
        dfv[1][k] = bf16_round((dp[k] * fa[0][k]) * fa[2][k]);
        dfv[2][k] = bf16_round((dp[k] * fa[0][k]) * fa[1][k]);
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          dm0[a] = fmaf(l0[a][k], dfv[a][k], dm0[a]);
          dm1[a] = fmaf(l1[a][k], dfv[a][k], dm1[a]);
        }
      }
#pragma unroll
      for (int a = 0; a < 3; ++a) {   // bf16 values already: exact
        const __nv_bfloat162 lo = __floats2bfloat162_rn(dfv[a][0], dfv[a][1]);
        const __nv_bfloat162 hi = __floats2bfloat162_rn(dfv[a][2], dfv[a][3]);
        uint2 raw;
        raw.x = *reinterpret_cast<const unsigned*>(&lo);
        raw.y = *reinterpret_cast<const unsigned*>(&hi);
        *reinterpret_cast<uint2*>(dfa + t * L.dfs + a * feat + f) = raw;
      }
    }
    if (dx != nullptr && live) {
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const float du = dm0[a] * s0[a] + dm1[a] * s1[a];
        const bool in01 = xa[a] > 0.f && xa[a] < 1.f;
        dx[3 * p + a] = du * (in01 ? (float)(r_max - 1) : 0.f);
      }
    }
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      wt[(2 * a) * kT + t] = w0[a];
      wt[(2 * a + 1) * kT + t] = w1[a];
      keys[a * kC + t] = live ? ((unsigned)i0[a] << 8) | t : kNoRow;
      keys[a * kC + kT + t] = live ? ((unsigned)(i0[a] + 1) << 8) | kT | t
                                   : kNoRow;
    }
    __syncthreads();
    flush_dlines(keys, heads, nseg, wt, dfa, L.dfs, slice, r_max, feat);
    __syncthreads();
  }

  // ---- this block's dW partial → its scratch row, once
  float* dw = slice + n_dl;
  for (int m = 0; m < n_mats; ++m) {
    const Mat M = mats[m];
    for (int e = t; e < M.I * M.O; e += kT) {
      const int i = e / M.O, o = e % M.O;
      if (i < M.I_real && o < M.O_real)
        dw[M.out + i * M.O_real + o] = acc[M.acc + e];
    }
  }
}

// dst[i] = Σ_b src[b][i] over the blocks' scratch rows, in block order.
__global__ void __launch_bounds__(256)
field_bwd_reduce(const float4* __restrict__ src, float4* __restrict__ dst,
                 int blocks, int row4) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= row4) return;
  float4 s = src[i];
  for (int b = 1; b < blocks; ++b) {
    const float4 v = src[(size_t)b * row4 + i];
    s.x += v.x;
    s.y += v.y;
    s.z += v.z;
    s.w += v.w;
  }
  dst[i] = s;
}

// The persistent grid for n points: every SM full, no more blocks than
// tiles, at least one. Depends on n, the SM count and the occupancy only.
template <bool kSigmaOnly>
int bwd_grid(int n, int feat) {
  const size_t smem = smem_bytes(make_layout(feat, kSigmaOnly));
  cudaError_t err = cudaFuncSetAttribute(
      field_bwd_kernel<kSigmaOnly>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return -(int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, field_bwd_kernel<kSigmaOnly>, kT, smem);
  if (err != cudaSuccess) return -(int)err;
  const int tiles = (n + kT - 1) / kT;
  const int cap = sm_count() * (per_sm > 0 ? per_sm : 1);
  return tiles < 1 ? 1 : (tiles < cap ? tiles : cap);
}

template <bool kSigmaOnly>
int launch_bwd(const float* x, const float* sh, const float* g,
               const __nv_bfloat16* lines, const float* wpack, float* dx,
               float* dsh, float* scratch, float* out, int n, int r_max,
               int feat, int grid, cudaStream_t stream) {
  const int row = 3 * r_max * feat + dw_size(feat, kSigmaOnly);
  if (n == 0)
    return (int)cudaMemsetAsync(out, 0, (size_t)row * sizeof(float), stream);
  if (grid < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(make_layout(feat, kSigmaOnly));
  cudaError_t err = cudaFuncSetAttribute(
      field_bwd_kernel<kSigmaOnly>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  field_bwd_kernel<kSigmaOnly><<<grid, kT, smem, stream>>>(
      x, sh, g, lines, wpack, dx, dsh, scratch, n, r_max, feat);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int row4 = row / 4;
  field_bwd_reduce<<<(row4 + 255) / 256, 256, 0, stream>>>(
      reinterpret_cast<const float4*>(scratch), reinterpret_cast<float4*>(out),
      grid, row4);
  return (int)cudaGetLastError();
}

}  // namespace

// The number of persistent blocks K4 (K5 when sigma_only) runs for n points,
// the first dimension of its scratch buffer; negative: -cudaError_t.
extern "C" int gbnerf_field_fused_bwd_grid(int n, int feat, int sigma_only) {
  return sigma_only ? bwd_grid<true>(n, feat) : bwd_grid<false>(n, feat);
}

// x [n,3] f32, sh [n,16] f32 (unused when sigma_only), g [n,4] f32 (16-byte
// aligned), lines [3,r_max,feat] bf16, wpack the packed bf16-rounded f32
// weights (ops/field_fused.py::pack_weights). Outputs: dx [n,3] and dsh
// [n,16] (each may be null: not stored), and out = dlines [3,r_max,feat] f32
// followed by dw (the five weight gradients, Dense [in,out], one after the
// other) f32, written whole. scratch: [grid, 3·r_max·feat + |dw|] f32,
// uninitialised; grid: gbnerf_field_fused_bwd_grid(n, feat, sigma_only)
// (any grid ≥ 1 gives a right result; the sums' order follows the grid).
// feat % 4 == 0. Returns the cudaError_t of the launches (0 = success).
extern "C" int gbnerf_field_fused_bwd(const void* x, const void* sh,
                                      const void* g, const void* lines,
                                      const void* wpack, void* dx, void* dsh,
                                      void* scratch, void* out, int n,
                                      int r_max, int feat, int sigma_only,
                                      int grid, void* stream) {
  const auto* xl = static_cast<const float*>(x);
  const auto* sl = static_cast<const float*>(sh);
  const auto* gl = static_cast<const float*>(g);
  const auto* ll = static_cast<const __nv_bfloat16*>(lines);
  const auto* wl = static_cast<const float*>(wpack);
  auto* dxl = static_cast<float*>(dx);
  auto* dsl = static_cast<float*>(dsh);
  auto* scl = static_cast<float*>(scratch);
  auto* ol = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  return sigma_only
             ? launch_bwd<true>(xl, sl, gl, ll, wl, dxl, dsl, scl, ol, n,
                                r_max, feat, grid, st)
             : launch_bwd<false>(xl, sl, gl, ll, wl, dxl, dsl, scl, ol, n,
                                 r_max, feat, grid, st);
}
