// Fused CP-field backward for Hopper (sm_90a): every cotangent in one pass.
//
// Replaces the TPU kernels gbnerf_tpu/ops/field_fused.py::_kernel_bwd (K4,
// the full field) and ::_kernel_bwd_sigma (K5, the σ-only variant), one
// templated source with SIGMA_ONLY as the flag, as K1/K2 are.
//
// What it computes, given the output cotangent g [N, 4] (rgb ⊕ σ): it
// recomputes K1's forward (field_tile.cuh, the same code) and runs the
// head backward
//   dh3 = g_rgb·wc2ᵀ ⊙ [h3>0]     dh2 = dh3·wc1ᵀ ⊙ [h2>0]   dhc = dh2·wc0ᵀ
//   dsh = dhc[:16]                dh1 = [g_σ, dhc[16:]]
//   dh0 = dh1·ws1ᵀ ⊙ [h0>0]       dprod = dh0·ws0ᵀ  [F]
// then the encode backward, per axis a: dfa = bf16(dprod ⊙ fa_b ⊙ fa_c);
// dlines[a] += maskᵀ · dfa (the bf16 triangle mask); du = Σ_taps (line ·
// dfa)·sign(r − u)·[|r − u| < 1]; dx_a = du·(R_max − 1)·[0 < x_a < 1]; and
// the weight gradients dW = Σ_p a_p ⊗ b_p. The TPU kernel's rounding is
// kept: every product's operands are bf16 (the cotangents, the activations
// and the mask included), every sum f32; the ties are its ties (du = 0 at
// a grid node, dx = 0 for a clipped coordinate that still adds to dlines,
// K1's first-tap clamp: cp_tap and tie_sign in field_common.cuh). K5:
// dh1 = [g_σ, 0…]; no colour head, no dsh, no dwc*.
//
// What bounds it on the H100, at the stage-1 fine pass (131,072 points,
// F 80, R_max 257): the products, 3 × 12,416 multiply-adds a point (the
// recomputed forward and the two products of each layer's backward),
// 0.0099 ms on the bf16 tensor cores; the dense dlines contraction the
// TPU does adds 3 × 272 × 80 × 2 FLOP a point (17 GFLOP). The previous
// design did all of it as scalar f32 FMAs at 4 warps an SM and sorted each
// tile's dlines contributions (3.664 ms).
//
// Design: persistent blocks of 8 warps (one an SM: the shared memory), a
// tile of 128 points a step, four phases a tile with a barrier after each:
// 1. Heads (each warp its 16 points): the forward and the head backward
//    as mma.sync chains in registers; each layer's bf16 operands (the
//    activations and the cotangents) go to tile buffers [point][column] in
//    shared memory, as the weight gradients need them. Where the order of
//    a forward sum could decide a relu mask or a bf16 rounding (its value
//    within 2^-17·Σ|a·w| of a boundary), the sum is taken again in
//    sequential f32 order from those buffers (field_tile.cuh::seq_fixup):
//    a flipped mask moves a point's cotangents by a whole term, and the
//    masks must be the plain version's (≈ 0.09 ms at the fine pass).
// 2. dW on the tensor cores: dW = Actᵀ·Cot with the tile's 128 points as
//    the k dimension, both operands by ldmatrix.trans from the buffers.
//    Each (matrix, 16 inputs, 16 outputs) unit belongs to one warp for
//    good; it adds its tile sum to the block's dW row of the scratch buffer
//    (all its loads, then all its stores: one round trip to L2).
// 3. Encode backward (each warp its 16 points): dprod = dh0·ws0ᵀ one
//    k-chunk of features at a time, dfa, du and dx; dfa goes to shared
//    memory [axis][point][feature], over the buffers phase 2 has read. A
//    lane's entries of a k-chunk are four neighbouring features (the
//    chunk order of field_tile.cuh), so each tap row is one 8-byte load.
// 4. dlines as the TPU computes it: per axis, maskᵀ [R_max × 128] · dfa
//    [128 × F] on the tensor cores. The A fragments of the mask are made
//    in registers from the tile's taps (each entry w0, w1 or 0); a 16-row
//    block of rows that no point of a 16-point k-step touches is skipped
//    (the test reads the k-step's range of taps: the inputs alone decide
//    it). Each (axis, 16 rows) unit belongs to one warp for good and adds
//    its 16 × F sum to the block's dlines slice of the scratch buffer,
//    float4 read-add-writes. Points along rays touch few rows a k-step;
//    independent uniform points touch them all (0.31 of 0.74 ms).
// Shared memory 187,328 bytes a block at F 80 (the weights 29 KB, the
// tile buffers 152 KB, the taps); ≈ 210 registers, no spills (K5: 113,088
// bytes, ≈ 160 registers); chip_smoke.py's "kernel info" lines print them.
//
// Determinism: no atomics. Every sum runs in an order fixed by the inputs,
// the SM count and the occupancy: within a tile in the mma's order, over a
// block's tiles in tile order (one owner a scratch address), and over the
// blocks in block order (field_bwd_reduce, a second launch). So the same
// inputs give bit-equal dx, dsh, dlines and dW on every call.

#include "field_tile.cuh"

namespace {

constexpr int kTile = 16 * kWarps;   // points a tile: one m-tile a warp
constexpr int kNG = 10;              // dlines n-tiles a pass (80 features)
constexpr int kNoTap = -4;           // i0 of a point past n: no row matches

// Element offsets (bf16) in shared memory of the tile buffers [kTile][stride]
// after the weights; dfa [3][kTile][ps] reuses prod and what follows it
// once phase 2 has read them. Byte offsets of the taps int4 [3][kTile]
// {i0, w0, w1, 0} and the k-steps' tap ranges int2 [3][kWarps].
struct BwdLayout {
  int dh0, dh1, g, prod, a0, hc, a2, a3, dh3, dh2, ps, dfa, taps_b, range_b;
  size_t bytes;
};

__host__ __device__ inline BwdLayout bwd_layout(int feat, bool sigma_only) {
  BwdLayout B{};
  B.ps = row_stride(feat_pad(feat));
  int o = weight_layout(feat, sigma_only).total;
  B.dh0 = o;
  o += kTile * kS64;
  B.dh1 = o;
  o += kTile * kS16;
  if (!sigma_only) {
    B.g = o;
    o += kTile * kS8;
  }
  B.prod = o;
  o += kTile * B.ps;
  B.a0 = o;
  o += kTile * kS64;
  if (!sigma_only) {
    B.hc = o;
    o += kTile * kS32;
    B.a2 = o;
    B.a3 = B.a2 + kTile * kS64;
    B.dh3 = B.a3 + kTile * kS64;
    B.dh2 = B.dh3 + kTile * kS64;
    o = B.dh2 + kTile * kS64;
  }
  B.dfa = B.prod;
  if (o < B.dfa + 3 * kTile * B.ps) o = B.dfa + 3 * kTile * B.ps;
  B.taps_b = o * 2;
  B.range_b = B.taps_b + 3 * kTile * 16;
  B.bytes = (size_t)B.range_b + 3 * kWarps * 8;
  return B;
}

// floats of the dW outputs (the five weights, Dense [in, out], one after
// the other; the σ-net's two when sigma_only)
__host__ __device__ inline int dw_size(int feat, bool sigma_only) {
  const int sigma = feat * kSigmaWidth + kSigmaWidth * kGeo;
  return sigma_only ? sigma
                    : sigma + kColorIn * kColorWidth + kColorWidth * kColorWidth
                          + kColorWidth * 3;
}

// One weight gradient: dW [in][out] += Σ_points act[p][in] · cot[p][out],
// act and cot tile buffers (strides as, cs); in_t 16-input tiles, out_t
// 8-output tiles; its output at float offset off of the dW row, rows × cols
// (wc0's packed row 16 is its zero row: rows above it move up one).
struct DwMat {
  int act, as, cot, cs, in_t, out_t, off, rows, cols;
  bool wc0, perm;       // wc0's zero row; ws0's k-chunk feature order
};

// The weight gradients in order: ws0, ws1 (σ-only stops here), wc0, wc1,
// wc2
__device__ __forceinline__ DwMat dw_mat(int m, const BwdLayout& B, int feat) {
  const int o = feat * 64 + 1024;
  switch (m) {
    case 0:
      return {B.prod, B.ps, B.dh0, kS64, feat_pad(feat) / 16, 8, 0, feat, 64,
              false, true};
    case 1:
      return {B.a0, kS64, B.dh1, kS16, 4, 2, feat * 64, 64, 16, false, false};
    case 2:
      return {B.hc, kS32, B.dh2, kS64, 2, 8, o, 32, 64, true, false};
    case 3:
      return {B.a2, kS64, B.dh3, kS64, 4, 8, o + 31 * 64, 64, 64, false, false};
    default:
      return {B.a3, kS64, B.g, kS8, 4, 1, o + 31 * 64 + 4096, 64, 3, false, false};
  }
}

// Phase 2's units of weight gradient m: 16 inputs × 16 outputs each
__device__ __forceinline__ int dw_units(int m, int feat) {
  switch (m) {
    case 0: return feat_pad(feat) / 16 * 4;
    case 3: return 16;
    case 2: return 8;
    default: return 4;
  }
}

// Phase 2, one unit: 16 inputs × (up to) 16 outputs of one dW over the tile
__device__ __forceinline__ void dw_unit(const bf16* S, const DwMat& M,
                                        int it, int np, float* dw) {
  const int l = lane_id(), g = l >> 2, c = 2 * (l & 3);
  const bool pair = M.out_t > 1;
  float acc[2][4];
  zero<2>(acc);
#pragma unroll 2
  for (int ks = 0; ks < kTile / 16; ++ks) {
    uint32_t a[4], b[4];
    lda_t(a, S + M.act, M.as, it, ks);
    if (pair) {
      ldb_w(b, S + M.cot, M.cs, ks, 2 * np);
      mma_bf16(acc[0], a, b[0], b[1]);
      mma_bf16(acc[1], a, b[2], b[3]);
    } else {
      ldm_x2_t(b, S + M.cot + (ks * 16 + (l & 7) + ((l >> 3) & 1) * 8) * M.cs);
      mma_bf16(acc[0], a, b[0], b[1]);
    }
  }
  // add to the block's dW row: every load first, then the stores (one
  // round trip to L2, not one an entry)
  int at[2][2][2];
  float old[2][2][2];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int row = it * 16 + g + 8 * h;
      if (M.wc0) row = row < 16 ? row : (row == 16 ? -1 : row - 1);
      if (M.perm)     // position g + 8h of the chunk holds this feature
        row = it * 16 + 4 * (g >> 1) + 2 * h + (g & 1);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = (2 * np + j) * 8 + c + e;
        const bool ok = (j == 0 || pair) && row >= 0 && row < M.rows
                        && col < M.cols;
        at[j][h][e] = ok ? M.off + row * M.cols + col : -1;
        old[j][h][e] = ok ? dw[at[j][h][e]] : 0.f;
      }
    }
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (at[j][h][e] >= 0) dw[at[j][h][e]] = old[j][h][e] + acc[j][2 * h + e];
}

__device__ __forceinline__ float tap_val(int4 t, int r) {
  return t.x == r ? __int_as_float(t.y)
                  : (t.x + 1 == r ? __int_as_float(t.z) : 0.f);
}

// The A fragment of maskᵀ [rows ra … ra + 15 × the 16 points of tp]
__device__ __forceinline__ void mask_frag(uint32_t a[4], const int4* tp,
                                          int ra) {
  const int c = 2 * (lane_id() & 3), rb = ra + 8;
  const int4 t0 = tp[c], t1 = tp[c + 1], t8 = tp[c + 8], t9 = tp[c + 9];
  a[0] = pack_bf16(tap_val(t0, ra), tap_val(t1, ra));
  a[1] = pack_bf16(tap_val(t0, rb), tap_val(t1, rb));
  a[2] = pack_bf16(tap_val(t8, ra), tap_val(t9, ra));
  a[3] = pack_bf16(tap_val(t8, rb), tap_val(t9, rb));
}

template <bool kSigmaOnly>
__global__ void __launch_bounds__(kBlock, 1)
field_bwd_kernel(const float* __restrict__ x, const float* __restrict__ sh,
                 const float* __restrict__ g, const bf16* __restrict__ lines,
                 const bf16* __restrict__ wpack, float* __restrict__ dx,
                 float* __restrict__ dsh, float* __restrict__ scratch, int n,
                 int r_max, int feat) {
  extern __shared__ __align__(16) unsigned char smem[];
  const WLayout W = weight_layout(feat, kSigmaOnly);
  const BwdLayout B = bwd_layout(feat, kSigmaOnly);
  bf16* S = reinterpret_cast<bf16*>(smem);
  int4* taps = reinterpret_cast<int4*>(smem + B.taps_b);
  int2* ranges = reinterpret_cast<int2*>(smem + B.range_b);
  copy16(S, wpack, W.total);
  // this block's row of the scratch buffer: its dlines slice [3, R_max, F]
  // and its dW partial, both summed into, so zeroed here
  const int n_dl = 3 * r_max * feat;
  const int row = n_dl + dw_size(feat, kSigmaOnly);
  float* slice = scratch + (size_t)blockIdx.x * row;
  for (int i = threadIdx.x; i < row / 4; i += kBlock)
    reinterpret_cast<float4*>(slice)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();

  const int warp = threadIdx.x >> 5, l = lane_id(), gq = l >> 2, tig = l & 3;
  const int kcs = feat_pad(feat) / 16, mts = (r_max + 15) / 16;
  int n_units = 0;
#pragma unroll
  for (int m = 0; m < (kSigmaOnly ? 2 : 5); ++m) n_units += dw_units(m, feat);

  const int tiles = (n + kTile - 1) / kTile;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int p0 = tile * kTile + warp * 16;   // this warp's 16 points
    const int r0 = warp * 16;                  // and their buffer rows

    // ---- 1. forward recompute and head backward (registers → buffers)
    {
      LaneTaps t;
      lane_taps(t, x, p0, n, r_max, feat);
      float h1[2][4];
      const uint32_t m0 = sigma_net<!kSigmaOnly, true>(
          h1, t, lines, feat, feat, S, W, S + B.prod + r0 * B.ps, B.ps,
          S + B.a0 + r0 * kS64);
      float4 gv[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = p0 + gq + 8 * h;
        gv[h] = p < n ? reinterpret_cast<const float4*>(g)[p]
                      : make_float4(0.f, 0.f, 0.f, 0.f);
      }
      uint32_t d1[1][4];
      if (kSigmaOnly) {           // dh1 = [g_σ, 0…]
        d1[0][0] = tig == 0 ? pack_bf16(gv[0].w, 0.f) : 0u;
        d1[0][1] = tig == 0 ? pack_bf16(gv[1].w, 0.f) : 0u;
        d1[0][2] = d1[0][3] = 0u;
      } else {
        uint32_t hc[2][4];
        hc_frags(hc, h1, sh, p0, n);
        st_a<2>(S + B.hc + r0 * kS32, kS32, hc);
        float rgb[4];
        uint32_t m2, m3;
        color_net<false, true>(rgb, m2, m3, hc, S, W, S + B.hc + r0 * kS32,
                               S + B.a2 + r0 * kS64, S + B.a3 + r0 * kS64);
        // bf16(g_rgb) as the A fragment of an 8-deep step (columns 3–7 0)
        uint32_t ga[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          ga[h] = tig == 0 ? pack_bf16(gv[h].x, gv[h].y)
                           : (tig == 1 ? pack_bf16(gv[h].z, 0.f) : 0u);
          *reinterpret_cast<uint32_t*>(S + B.g + (r0 + gq + 8 * h) * kS8
                                       + 2 * tig) = ga[h];
        }
        float c[8][4];
        zero<8>(c);
#pragma unroll
        for (int nt = 0; nt < 8; nt += 4) {   // wc2ᵀ: 4 n-tiles a load
          uint32_t b[4];
          ldm_x4(b, S + W.wc2 + ((nt + (l >> 3)) * 8 + (l & 7)) * kS8);
#pragma unroll
          for (int j = 0; j < 4; ++j) mma_bf16_k8(c[nt + j], ga, b[j]);
        }
        apply_mask<8>(c, m3);                      // dh3
        uint32_t a[4][4];
        c_to_a<8>(a, c);
        st_a<4>(S + B.dh3 + r0 * kS64, kS64, a);
        zero<8>(c);
        mm_wt<4, 8>(c, a, S + W.wc1, kS64);
        apply_mask<8>(c, m2);                      // dh2
        c_to_a<8>(a, c);
        st_a<4>(S + B.dh2 + r0 * kS64, kS64, a);
        float dhc[4][4];
        zero<4>(dhc);
        mm_wt<4, 4>(dhc, a, S + W.wc0, kS64);
        if (dsh != nullptr) {                      // dsh = dhc[:, :16]
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int p = p0 + gq + 8 * h;
            if (p < n) {
              float* d = dsh + (size_t)p * kSh + 2 * tig;
              *reinterpret_cast<float2*>(d) =
                  make_float2(dhc[0][2 * h], dhc[0][2 * h + 1]);
              *reinterpret_cast<float2*>(d + 8) =
                  make_float2(dhc[1][2 * h], dhc[1][2 * h + 1]);
            }
          }
        }
        if (tig == 0) {           // column 16 (wc0's zero row) takes g_σ
          dhc[2][0] = gv[0].w;
          dhc[2][2] = gv[1].w;
        }
        d1[0][0] = pack_bf16(dhc[2][0], dhc[2][1]);
        d1[0][1] = pack_bf16(dhc[2][2], dhc[2][3]);
        d1[0][2] = pack_bf16(dhc[3][0], dhc[3][1]);
        d1[0][3] = pack_bf16(dhc[3][2], dhc[3][3]);
      }
      st_a<1>(S + B.dh1 + r0 * kS16, kS16, d1);
      float c[8][4];
      zero<8>(c);
      mm_wt<1, 8>(c, d1, S + W.ws1, kS16);
      apply_mask<8>(c, m0);                        // dh0
      uint32_t a[4][4];
      c_to_a<8>(a, c);
      st_a<4>(S + B.dh0 + r0 * kS64, kS64, a);
    }
    __syncthreads();

    // ---- 2. weight gradients over the tile's points
    for (int u = warp; u < n_units; u += kWarps) {
      int m = 0, v = u;
      while (v >= dw_units(m, feat)) v -= dw_units(m++, feat);
      const DwMat M = dw_mat(m, B, feat);
      const int pairs = (M.out_t + 1) / 2;
      dw_unit(S, M, v / pairs, v % pairs, slice + n_dl);
    }
    __syncthreads();

    // ---- 3. encode backward (this warp's 16 points): dfa, du, dx; taps
    {
      uint32_t ad[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        ld_a(ad[kk], S + B.dh0 + r0 * kS64, kS64, kk);
      CpTap ct[2][3];
      float xa[2][3];
      LaneTaps t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = p0 + gq + 8 * h;
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          xa[h][a] = p < n ? x[3 * p + a] : 0.5f;
          ct[h][a] = cp_tap(xa[h][a], r_max);
          t.off[h][a] = (a * r_max + ct[h][a].i0) * feat;
          t.w0[h][a] = ct[h][a].w0;
          t.w1[h][a] = ct[h][a].w1;
        }
      }
      float dm0[2][3], dm1[2][3];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int a = 0; a < 3; ++a) dm0[h][a] = dm1[h][a] = 0.f;
      for (int kc = 0; kc < kcs; ++kc) {
        float c[2][4];
        zero<2>(c);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {       // dprod, 16 features
          uint32_t b[4];
          ldb_wt(b, S + W.ws0, kS64, kk, 2 * kc);
          mma_bf16(c[0], ad[kk], b[0], b[1]);
          mma_bf16(c[1], ad[kk], b[2], b[3]);
        }
        // lane tig's features 16kc + 4tig … + 3: C entries (j, e) of its
        // two n-tiles are feature 4tig + 2j + e (field_tile.cuh's order)
        const int f = kc * 16 + 4 * tig;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          uint32_t d[3][2] = {{0u, 0u}, {0u, 0u}, {0u, 0u}};
          if (f < feat) {
            float fa[3][4], l0[3][4], l1[3][4];
            lerp3x4(fa, l0, l1, t, h, lines, feat, f);
            float dv[3][4];
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const float dp = c[q >> 1][2 * h + (q & 1)];
              dv[0][q] = bf16_round((dp * fa[1][q]) * fa[2][q]);
              dv[1][q] = bf16_round((dp * fa[0][q]) * fa[2][q]);
              dv[2][q] = bf16_round((dp * fa[0][q]) * fa[1][q]);
#pragma unroll
              for (int a = 0; a < 3; ++a) {
                dm0[h][a] = fmaf(l0[a][q], dv[a][q], dm0[h][a]);
                dm1[h][a] = fmaf(l1[a][q], dv[a][q], dm1[h][a]);
              }
            }
#pragma unroll
            for (int a = 0; a < 3; ++a) {
              d[a][0] = pack_bf16(dv[a][0], dv[a][1]);
              d[a][1] = pack_bf16(dv[a][2], dv[a][3]);
            }
          }
#pragma unroll
          for (int a = 0; a < 3; ++a) {   // positions 2tig (+1) and 8 + 2tig
            uint32_t* r = reinterpret_cast<uint32_t*>(
                S + B.dfa + (a * kTile + r0 + gq + 8 * h) * B.ps + kc * 16
                + 2 * tig);
            r[0] = d[a][0];
            r[4] = d[a][1];
          }
        }
      }
      // each point's sums over its features: the quad's four lanes
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          dm0[h][a] += __shfl_xor_sync(0xffffffffu, dm0[h][a], 1);
          dm0[h][a] += __shfl_xor_sync(0xffffffffu, dm0[h][a], 2);
          dm1[h][a] += __shfl_xor_sync(0xffffffffu, dm1[h][a], 1);
          dm1[h][a] += __shfl_xor_sync(0xffffffffu, dm1[h][a], 2);
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = p0 + gq + 8 * h;
        const bool live = p < n;
        if (dx != nullptr && live && tig == h) {
#pragma unroll
          for (int a = 0; a < 3; ++a) {
            const float du = dm0[h][a] * tie_sign(ct[h][a].d0)
                             + dm1[h][a] * tie_sign(ct[h][a].d1);
            const bool in01 = xa[h][a] > 0.f && xa[h][a] < 1.f;
            dx[3 * p + a] = du * (in01 ? (float)(r_max - 1) : 0.f);
          }
        }
        if (tig == 0) {
#pragma unroll
          for (int a = 0; a < 3; ++a)
            taps[a * kTile + r0 + gq + 8 * h] =
                make_int4(live ? ct[h][a].i0 : kNoTap,
                          __float_as_int(ct[h][a].w0),
                          __float_as_int(ct[h][a].w1), 0);
        }
      }
      // the rows this warp's points touch, per axis (a range: the skip
      // test of phase 4)
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        int lo = 0x7fffffff, hi = -0x7fffffff;
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if (p0 + gq + 8 * h < n) {
            lo = min(lo, ct[h][a].i0);
            hi = max(hi, ct[h][a].i0 + 1);
          }
        lo = __reduce_min_sync(0xffffffffu, lo);
        hi = __reduce_max_sync(0xffffffffu, hi);
        if (l == 0) ranges[a * kWarps + warp] = make_int2(lo, hi);
      }
    }
    __syncthreads();

    // ---- 4. dlines += maskᵀ · dfa, per axis and 16 rows
    for (int u = warp; u < 3 * mts; u += kWarps) {
      const int a = u / mts, rlo = (u % mts) * 16;
      unsigned ks_mask = 0;
#pragma unroll
      for (int ks = 0; ks < kWarps; ++ks) {
        const int2 rg = ranges[a * kWarps + ks];
        if (rg.x <= rlo + 15 && rg.y >= rlo) ks_mask |= 1u << ks;
      }
      if (ks_mask == 0) continue;
      const int4* tp = taps + a * kTile;
      const bf16* dfa = S + B.dfa + a * kTile * B.ps;
      float* dl = slice + (size_t)a * r_max * feat;
      const int ra = rlo + gq, rb = ra + 8;
      for (int nb = 0; nb < 2 * kcs; nb += kNG) {
        float c[kNG][4];
        zero<kNG>(c);
        for (int ks = 0; ks < kWarps; ++ks) {
          if (!((ks_mask >> ks) & 1u)) continue;
          uint32_t am[4];
          mask_frag(am, tp + ks * 16, ra);
#pragma unroll
          for (int j = 0; j < kNG; j += 2) {
            if (nb + j < 2 * kcs) {
              uint32_t b[4];
              ldb_w(b, dfa, B.ps, ks, nb + j);
              mma_bf16(c[j], am, b[0], b[1]);
              mma_bf16(c[j + 1], am, b[2], b[3]);
            }
          }
        }
        // n-tiles (nb + j, nb + j + 1) are k-chunk (nb + j) / 2: lane tig's
        // entries there are features 4tig … 4tig + 3, one float4 a row
        float4 old[kNG / 2][2];
#pragma unroll
        for (int j = 0; j < kNG; j += 2) {
          const int f = (nb + j) / 2 * 16 + 4 * tig;
          const bool ok = nb + j < 2 * kcs && f < feat;
          old[j / 2][0] = ok && ra < r_max
                              ? *reinterpret_cast<const float4*>(dl + ra * feat + f)
                              : make_float4(0.f, 0.f, 0.f, 0.f);
          old[j / 2][1] = ok && rb < r_max
                              ? *reinterpret_cast<const float4*>(dl + rb * feat + f)
                              : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int j = 0; j < kNG; j += 2) {
          const int f = (nb + j) / 2 * 16 + 4 * tig;
          if (nb + j < 2 * kcs && f < feat) {
            const float4 o0 = old[j / 2][0], o1 = old[j / 2][1];
            if (ra < r_max)
              *reinterpret_cast<float4*>(dl + ra * feat + f) =
                  make_float4(o0.x + c[j][0], o0.y + c[j][1],
                              o0.z + c[j + 1][0], o0.w + c[j + 1][1]);
            if (rb < r_max)
              *reinterpret_cast<float4*>(dl + rb * feat + f) =
                  make_float4(o1.x + c[j][2], o1.y + c[j][3],
                              o1.z + c[j + 1][2], o1.w + c[j + 1][3]);
          }
        }
      }
    }
    __syncthreads();
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

template <bool kSigmaOnly>
const void* bwd_fn() {
  return (const void*)field_bwd_kernel<kSigmaOnly>;
}

// The persistent grid for n points: every SM full, no more blocks than
// tiles, at least one. Depends on n, the SM count and the occupancy only.
int bwd_grid(int n, int feat, bool sigma_only) {
  const void* fn = sigma_only ? bwd_fn<true>() : bwd_fn<false>();
  const size_t smem = bwd_layout(feat, sigma_only).bytes;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return -(int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kBlock,
                                                      smem);
  if (err != cudaSuccess) return -(int)err;
  if (per_sm < 1) return -(int)cudaErrorInvalidConfiguration;
  const int tiles = (n + kTile - 1) / kTile;
  const int cap = sm_count() * per_sm;
  return tiles < 1 ? 1 : (tiles < cap ? tiles : cap);
}

template <bool kSigmaOnly>
int launch_bwd(const float* x, const float* sh, const float* g,
               const bf16* lines, const bf16* wpack, float* dx, float* dsh,
               float* scratch, float* out, int n, int r_max, int feat,
               int grid, cudaStream_t stream) {
  const int row = 3 * r_max * feat + dw_size(feat, kSigmaOnly);
  if (n == 0)
    return (int)cudaMemsetAsync(out, 0, (size_t)row * sizeof(float), stream);
  if (grid < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = bwd_layout(feat, kSigmaOnly).bytes;
  cudaError_t err = cudaFuncSetAttribute(
      field_bwd_kernel<kSigmaOnly>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  field_bwd_kernel<kSigmaOnly><<<grid, kBlock, smem, stream>>>(
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
  return bwd_grid(n, feat, sigma_only != 0);
}

// x [n,3] f32, sh [n,16] f32 (unused when sigma_only), g [n,4] f32 (16-byte
// aligned), lines [3,r_max,feat] bf16, wpack the packed bf16 weights
// (ops/field_fused.py::pack_weights). Outputs: dx [n,3] and dsh [n,16] (each
// may be null: not stored), and out = dlines [3,r_max,feat] f32 followed by
// dw (the five weight gradients, Dense [in,out], one after the other) f32,
// written whole. scratch: [grid, 3·r_max·feat + |dw|] f32, uninitialised;
// grid: gbnerf_field_fused_bwd_grid(n, feat, sigma_only) (any grid ≥ 1
// gives a right result; the sums' order follows the grid). feat % 4 == 0.
// Returns the cudaError_t of the launches (0 = success).
extern "C" int gbnerf_field_fused_bwd(const void* x, const void* sh,
                                      const void* g, const void* lines,
                                      const void* wpack, void* dx, void* dsh,
                                      void* scratch, void* out, int n,
                                      int r_max, int feat, int sigma_only,
                                      int grid, void* stream) {
  const auto* xl = static_cast<const float*>(x);
  const auto* sl = static_cast<const float*>(sh);
  const auto* gl = static_cast<const float*>(g);
  const auto* ll = static_cast<const bf16*>(lines);
  const auto* wl = static_cast<const bf16*>(wpack);
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

// Registers, local (spill) bytes a thread, dynamic shared memory and blocks
// an SM of K4 (K5 when sigma_only) at this feature width → info[4].
extern "C" int gbnerf_field_fused_bwd_info(int feat, int sigma_only,
                                           int* info) {
  const void* fn = sigma_only ? bwd_fn<true>() : bwd_fn<false>();
  const size_t smem = bwd_layout(feat, sigma_only != 0).bytes;
  cudaFuncAttributes attr{};
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
  int per_sm = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kBlock,
                                                        smem);
  info[0] = attr.numRegs;
  info[1] = (int)attr.localSizeBytes;
  info[2] = (int)smem;
  info[3] = per_sm;
  return (int)err;
}
