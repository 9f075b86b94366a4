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
// F 80, R_max 257): by its operations, the products, 3 × 12,416
// multiply-adds a point (the recomputed forward and the two products of
// each layer's backward), 0.0099 ms on the bf16 tensor cores; the dense
// dlines contraction the TPU does adds 3 × 272 × 80 × 2 FLOP a point.
// What holds it is latency: one block of 8 warps an SM (the shared
// memory), each warp's chains of dependent products, gathers and
// sequential sums. tools/prof_field_bwd_parts.py times it with one part
// taken out at a time. On the design before this one (each tile's block
// partials read, added and written back in the scratch buffer) it gave,
// by graph at uniform points / along rays (PERF.md §6): the partial sums'
// traffic and the reduce 0.276 / 0.111 of 0.537 / 0.348 ms (dlines 0.195
// / 0.029, dW 0.113 / 0.057, the reduce 0.030 / 0.026), the heads 0.156 /
// 0.146, seq_fixup 0.090 / 0.092, the products 0.04–0.09. So this design
// keeps the partial sums on the chip where it can and shortens the serial
// parts; the products stay on mma.sync (wgmma would move a part that
// holds 0.02–0.05 ms).
//
// Design: persistent blocks of 8 warps (one an SM), a tile of 128 points a
// step, four phases a tile with a barrier after each:
// 1. Heads (each warp its 16 points): the forward and the head backward
//    as mma.sync chains in registers; each layer's bf16 operands (the
//    activations and the cotangents) go to tile buffers [point][column] in
//    shared memory, as the weight gradients need them. The tap rows of the
//    encode are loaded two k-chunks ahead of their products, g and SH at
//    the tile's start. Where the order of a forward sum could decide a
//    relu mask or a bf16 rounding (its value within 2^-17·Σ|a·w| of a
//    boundary), the sum is taken again in sequential f32 order from those
//    buffers (field_tile.cuh::seq_fixup): a flipped mask moves a point's
//    cotangents by a whole term, and the masks must be the plain
//    version's. A small share of a layer's entries is redone; the warp
//    shares them out, 32 a pass, whichever lane owns them.
// 2. dW on the tensor cores: dW = Actᵀ·Cot with the tile's 128 points as
//    the k dimension, both operands by ldmatrix.trans from the buffers.
//    Each (matrix, 16 inputs, 16 outputs) unit belongs to one warp for
//    good, which adds its tile sum to the block's partial sum: in shared
//    memory across all the block's tiles (each lane's C fragments as two
//    float4s), copied to the block's scratch row once at the end. A matrix
//    that does not fit beside the rest (at F 160 ws0 and wc1) is summed in
//    the scratch row every tile instead (all loads, then all stores).
// 3. Encode backward (each warp its 16 points): dprod = dh0·ws0ᵀ one
//    k-chunk of features at a time, dfa, du and dx; dfa goes to shared
//    memory [axis][point][feature], over the buffers phase 2 has read, and
//    the taps after it. A lane's entries of a k-chunk are four
//    neighbouring features (the chunk order of field_tile.cuh), so each tap
//    row is one 8-byte load, issued before the k-chunk's dprod products.
// 4. dlines as the TPU computes it: per axis, maskᵀ [R_max × 128] · dfa
//    [128 × F] on the tensor cores. The A fragments of the mask are made
//    in registers from the tile's taps (each entry w0, w1 or 0); a 16-row
//    block of rows that no point of a 16-point k-step touches is skipped
//    (the test reads the k-step's range of taps: the inputs alone decide
//    it). Each (axis, 16 rows) unit belongs to one warp for good and adds
//    its 16 × F sum to the block's dlines slice of the scratch buffer
//    (247 KB at F 80: no SM holds it beside the rest), float4
//    read-add-writes whose loads go out before the products; a unit's
//    first touch writes without reading, and a unit no tile of the block
//    touches is never written: its flag tells the reduce to skip it.
//    Points along rays touch few rows a k-step; uniform points touch all.
// A second launch sums the blocks' rows in block order (16 rows' loads in
// flight a thread, the touched flags staged in shared memory). Shared
// memory 232,256 bytes a block at F 80 (the weights 29 KB, the tile
// buffers 148 KB, dW 50 KB), ≈ 210 registers, no spills (K5: 137,728
// bytes, ≈ 190 registers); chip_smoke.py's "kernel info" lines print them.
//
// Determinism: no atomics. Every sum runs in an order fixed by the inputs,
// the SM count and the occupancy: within a tile in the mma's order, over a
// block's tiles in tile order (one owner a partial sum), and over the
// blocks in block order (field_bwd_reduce, a second launch). So the same
// inputs give bit-equal dx, dsh, dlines and dW on every call, and the
// design before this one's bits.

#include "field_tile.cuh"

namespace {

constexpr int kTile = 16 * kWarps;   // points a tile: one m-tile a warp
constexpr int kNG = 10;              // dlines n-tiles a pass (80 features)
constexpr int kNoTap = -4;           // i0 of a point past n: no row matches

// Element offsets (bf16) in shared memory of the tile buffers [kTile][stride]
// after the weights; dfa [3][kTile][ps] reuses prod and what follows it
// once phase 2 has read them, and the taps int4 [3][kTile] {i0, w0, w1, 0}
// and the k-steps' tap ranges int2 [3][kWarps] follow dfa (byte offsets),
// in buffers phase 2 has read too where they are long enough. Then the
// dlines units' touched flags (a byte a unit, [3][mts]) and the block's dW
// partial sums held in shared memory (f32, dw_smem_off).
struct BwdLayout {
  int dh0, dh1, g, prod, a0, hc, a2, a3, dh3, dh2, ps, dfa, taps_b, range_b,
      touch_b, dw_b;
  size_t base;      // bytes without the dW partial sums
};

__host__ __device__ inline BwdLayout bwd_layout(int feat, int r_max,
                                                bool sigma_only) {
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
  B.taps_b = (B.dfa + 3 * kTile * B.ps) * 2;
  B.range_b = B.taps_b + 3 * kTile * 16;
  B.touch_b = B.range_b + 3 * kWarps * 8;
  if (B.touch_b < o * 2) B.touch_b = o * 2;
  B.dw_b = B.touch_b + ((3 * ((r_max + 15) / 16) + 15) & ~15);
  B.base = (size_t)B.dw_b;
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

// floats of a block's scratch row: its dlines slice [3, R_max, F], its dW
// partial and the dlines units' touched flags (an int a unit, [3][mts]),
// padded to whole float4s
__host__ __device__ inline int bwd_row(int r_max, int feat, bool sigma_only) {
  return 3 * r_max * feat + dw_size(feat, sigma_only)
         + ((3 * ((r_max + 15) / 16) + 3) & ~3);
}

// The weight gradients' floats (rows × cols) and their offset in the dW
// row, in order: ws0, ws1 (σ-only stops here), wc0, wc1, wc2
__host__ __device__ inline int dw_mat_size(int m, int feat) {
  switch (m) {
    case 0: return feat * kSigmaWidth;
    case 1: return kSigmaWidth * kGeo;
    case 2: return kColorIn * kColorWidth;
    case 3: return kColorWidth * kColorWidth;
    default: return kColorWidth * 3;
  }
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
__host__ __device__ inline int dw_units(int m, int feat) {
  switch (m) {
    case 0: return feat_pad(feat) / 16 * 4;
    case 3: return 16;
    case 2: return 8;
    default: return 4;
  }
}

// The floats a lane holds of one unit's sum: its C fragments, two n-tiles
// (one for wc2, 8 outputs wide)
__host__ __device__ inline int dw_slot(int m) { return m == 4 ? 4 : 8; }

// Where the block keeps weight gradient m's partial sum: the float offset
// in shared memory of its units, each unit's lanes' fragments one after
// the other (lane l's at (unit · 32 + l) · dw_slot: float4 loads without
// bank conflicts), each matrix whole while the budget (floats) holds it,
// in order; -1: in the block's scratch row. used: the floats taken.
__host__ __device__ inline int dw_smem_off(int m, int feat, bool sigma_only,
                                           int budget, int* used = nullptr) {
  int at = 0, off = -1;
  for (int k = 0; k < (sigma_only ? 2 : 5); ++k) {
    const int sz = dw_units(k, feat) * 32 * dw_slot(k);
    const bool in = at + sz <= budget;
    if (k == m) off = in ? at : -1;
    if (in) at += sz;
  }
  if (used != nullptr) *used = at;
  return off;
}

// The offsets in its matrix of the outputs of unit (it, np) this lane
// holds (C fragment entries [j][2h + e]; -1: none)
__device__ __forceinline__ void dw_at(int at[2][2][2], const DwMat& M, int it,
                                      int np) {
  const int l = lane_id(), g = l >> 2, c = 2 * (l & 3);
  const bool pair = M.out_t > 1;
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
        at[j][h][e] = ok ? row * M.cols + col : -1;
      }
    }
}

// Phase 2, one unit: 16 inputs × (up to) 16 outputs of one dW over the
// tile, added to the block's partial sum: this lane's fragment slot in
// shared memory (at sdw + fr, float4s; fr ≥ 0), or its outputs in the
// matrix's part of the block's dW row (dw; every load first, then the
// stores: one round trip to L2)
__device__ __forceinline__ void dw_unit(const bf16* S, const DwMat& M,
                                        int it, int np, float* sdw, int fr,
                                        float* dw) {
  const int l = lane_id();
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
  if (fr >= 0) {
    float4* f4 = reinterpret_cast<float4*>(sdw + fr);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if (j == 1 && !pair) break;
      const float4 o = f4[j];
      f4[j] = make_float4(o.x + acc[j][0], o.y + acc[j][1], o.z + acc[j][2],
                          o.w + acc[j][3]);
    }
    return;
  }
  int at[2][2][2];
  dw_at(at, M, it, np);
  dw += M.off;
  float old[2][2][2];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        old[j][h][e] = at[j][h][e] >= 0 ? dw[at[j][h][e]] : 0.f;
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
                 int r_max, int feat, int dw_budget) {
  extern __shared__ __align__(16) unsigned char smem[];
  const WLayout W = weight_layout(feat, kSigmaOnly);
  const BwdLayout B = bwd_layout(feat, r_max, kSigmaOnly);
  bf16* S = reinterpret_cast<bf16*>(smem);
  int4* taps = reinterpret_cast<int4*>(smem + B.taps_b);
  int2* ranges = reinterpret_cast<int2*>(smem + B.range_b);
  unsigned char* touched = smem + B.touch_b;
  float* sdw = reinterpret_cast<float*>(smem + B.dw_b);
  copy16(S, wpack, W.total);
  const int kcs = feat_pad(feat) / 16, mts = (r_max + 15) / 16;
  // this block's row of the scratch buffer (bwd_row): its dlines slice
  // [3, R_max, F], written at a unit's first touch and summed into after
  // (untouched units are never written), its dW partial (the matrices
  // dw_smem_off places summed in shared memory and copied here at the end,
  // the others summed into here) and the units' touched flags
  const int n_dl = 3 * r_max * feat;
  const int n_mats = kSigmaOnly ? 2 : 5;
  const int row = bwd_row(r_max, feat, kSigmaOnly);
  float* slice = scratch + (size_t)blockIdx.x * row;
  int dw_off[5];
  for (int m = 0, o = 0; m < n_mats; o += dw_mat_size(m++, feat))
    dw_off[m] = o;
  int dw_used = 0;
  dw_smem_off(0, feat, kSigmaOnly, dw_budget, &dw_used);
  for (int i = threadIdx.x; i < dw_used / 4; i += kBlock)
    reinterpret_cast<float4*>(sdw)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int m = 0; m < n_mats; ++m) {
    if (dw_smem_off(m, feat, kSigmaOnly, dw_budget) >= 0) continue;
    float4* sum = reinterpret_cast<float4*>(slice + n_dl + dw_off[m]);
    for (int i = threadIdx.x; i < dw_mat_size(m, feat) / 4; i += kBlock)
      sum[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  for (int i = threadIdx.x; i < 3 * mts; i += kBlock) touched[i] = 0;
  __syncthreads();

  const int warp = threadIdx.x >> 5, l = lane_id(), gq = l >> 2, tig = l & 3;
  int n_units = 0;
  for (int m = 0; m < n_mats; ++m) n_units += dw_units(m, feat);

  const int tiles = (n + kTile - 1) / kTile;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int p0 = tile * kTile + warp * 16;   // this warp's 16 points
    const int r0 = warp * 16;                  // and their buffer rows

    // ---- 1. forward recompute and head backward (registers → buffers)
    {
      LaneTaps t;
      lane_taps(t, x, p0, n, r_max, feat);
      float4 gv[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = p0 + gq + 8 * h;
        gv[h] = p < n ? reinterpret_cast<const float4*>(g)[p]
                      : make_float4(0.f, 0.f, 0.f, 0.f);
      }
      uint32_t shf[4];
      if (!kSigmaOnly) sh_frag(shf, sh, p0, n);
      float h1[2][4];
      const uint32_t m0 = sigma_net<!kSigmaOnly>(
          h1, t, lines, feat, feat, S, W, S + B.prod + r0 * B.ps, B.ps,
          S + B.a0 + r0 * kS64);
      uint32_t d1[1][4];
      if (kSigmaOnly) {           // dh1 = [g_σ, 0…]
        d1[0][0] = tig == 0 ? pack_bf16(gv[0].w, 0.f) : 0u;
        d1[0][1] = tig == 0 ? pack_bf16(gv[1].w, 0.f) : 0u;
        d1[0][2] = d1[0][3] = 0u;
      } else {
        uint32_t hc[2][4];
#pragma unroll
        for (int i = 0; i < 4; ++i) hc[0][i] = shf[i];
        h1_frag(hc[1], h1);
        st_a<2>(S + B.hc + r0 * kS32, kS32, hc);
        uint32_t m2, m3;
        color_net(m2, m3, hc, S, W, S + B.hc + r0 * kS32,
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
      const int so = dw_smem_off(m, feat, kSigmaOnly, dw_budget);
      dw_unit(S, M, v / pairs, v % pairs, sdw,
              so < 0 ? -1 : so + (v * 32 + l) * dw_slot(m), slice + n_dl);
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
        LaneRows rows;     // out before the products, back after them
        load_rows(rows, t, lines, feat, feat, kc);
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
            lerp3x4(fa, l0, l1, rows, t, h);
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
      const bool first = touched[u] == 0;   // this warp's alone: no race
      const int4* tp = taps + a * kTile;
      const bf16* dfa = S + B.dfa + a * kTile * B.ps;
      float* dl = slice + (size_t)a * r_max * feat;
      const int ra = rlo + gq, rb = ra + 8;
      for (int nb = 0; nb < 2 * kcs; nb += kNG) {
        // the block's sums so far, loaded before the products so that
        // their round trip to L2 overlaps them (none at the first touch)
        // n-tiles (nb + j, nb + j + 1) are k-chunk (nb + j) / 2: lane tig's
        // entries there are features 4tig … 4tig + 3, one float4 a row
        float4 old[kNG / 2][2];
#pragma unroll
        for (int j = 0; j < kNG; j += 2) {
          const int f = (nb + j) / 2 * 16 + 4 * tig;
          const bool ok = !first && nb + j < 2 * kcs && f < feat;
          old[j / 2][0] = ok && ra < r_max
                              ? *reinterpret_cast<const float4*>(dl + ra * feat + f)
                              : make_float4(0.f, 0.f, 0.f, 0.f);
          old[j / 2][1] = ok && rb < r_max
                              ? *reinterpret_cast<const float4*>(dl + rb * feat + f)
                              : make_float4(0.f, 0.f, 0.f, 0.f);
        }
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
      if (l == 0) touched[u] = 1;
    }
    __syncthreads();
  }

  // ---- the block's dW partial sums held in shared memory (each warp its
  // own units' fragments), and the units' touched flags, into its scratch
  // row
  for (int u = warp; u < n_units; u += kWarps) {
    int m = 0, v = u;
    while (v >= dw_units(m, feat)) v -= dw_units(m++, feat);
    const int so = dw_smem_off(m, feat, kSigmaOnly, dw_budget);
    if (so < 0) continue;
    const DwMat M = dw_mat(m, B, feat);
    const int pairs = (M.out_t + 1) / 2;
    const float* fr = sdw + so + (v * 32 + l) * dw_slot(m);
    int at[2][2][2];
    dw_at(at, M, v / pairs, v % pairs);
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (at[j][h][e] >= 0)
            slice[n_dl + M.off + at[j][h][e]] = fr[4 * j + 2 * h + e];
  }
  int* flags =
      reinterpret_cast<int*>(slice + n_dl + dw_size(feat, kSigmaOnly));
  for (int i = threadIdx.x; i < 3 * mts; i += kBlock) flags[i] = touched[i];
}

constexpr int kReduceThreads = 128;

// the units (a byte a block each) a reduce block's flags take: its floats
// span at most this many dlines units
__host__ __device__ inline int reduce_units(int feat) {
  return 4 * kReduceThreads / feat + 2;
}

__global__ void __launch_bounds__(kReduceThreads)
field_bwd_reduce(const float* __restrict__ src, float* __restrict__ dst,
                 int blocks, int row, int out_len, int r_max, int feat) {
  extern __shared__ unsigned char fl[];   // [units of this block][blocks]
  constexpr int kAhead = 16;
  const int n_dl = 3 * r_max * feat, mts = (r_max + 15) / 16;
  const int i_first = 4 * blockIdx.x * blockDim.x;
  const int i_last = min(i_first + 4 * (int)blockDim.x, min(out_len, n_dl)) - 1;
  int u0 = 0, nu = 0;
  if (i_first < n_dl) {
    const int a0 = i_first / feat, a1 = i_last / feat;
    u0 = a0 / r_max * mts + a0 % r_max / 16;
    nu = a1 / r_max * mts + a1 % r_max / 16 - u0 + 1;
  }
  for (int k = threadIdx.x; k < nu * blocks; k += blockDim.x) {
    const int u = k / blocks, b = k % blocks;
    fl[k] = reinterpret_cast<const int*>(src + (size_t)b * row + out_len)[u0 + u]
            != 0;
  }
  __syncthreads();
  const int i = i_first + 4 * threadIdx.x;
  if (i >= out_len) return;
  const unsigned char* f = nullptr;
  if (i < n_dl) {
    const int ar = i / feat;
    f = fl + (ar / r_max * mts + ar % r_max / 16 - u0) * blocks;
  }
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int b0 = 0; b0 < blocks; b0 += kAhead) {
    float4 v[kAhead];
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      const bool use = b0 + k < blocks && (f == nullptr || f[b0 + k]);
      v[k] = use ? *reinterpret_cast<const float4*>(src + (size_t)(b0 + k) * row + i)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      s.x += v[k].x;
      s.y += v[k].y;
      s.z += v[k].z;
      s.w += v[k].w;
    }
  }
  *reinterpret_cast<float4*>(dst + i) = s;
}

template <bool kSigmaOnly>
const void* bwd_fn() {
  return (const void*)field_bwd_kernel<kSigmaOnly>;
}

// The dW budget a block has in shared memory (the floats the card's
// shared memory a block takes holds beside the rest of the layout), the
// floats dw_smem_off places there and the dynamic shared memory.
struct BwdSmem {
  int dw_budget, dw_used;
  size_t bytes;
};

BwdSmem bwd_smem(int r_max, int feat, bool sigma_only) {
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  const size_t base = bwd_layout(feat, r_max, sigma_only).base;
  const int budget = optin > (int)base ? (optin - (int)base) / 4 : 0;
  int used = 0;
  dw_smem_off(0, feat, sigma_only, budget, &used);
  return {budget, used, base + (size_t)used * sizeof(float)};
}

// The persistent grid for n points: every SM full, no more blocks than
// tiles, at least one. Depends on n, the SM count and the occupancy only.
int bwd_grid(int n, int r_max, int feat, bool sigma_only) {
  const void* fn = sigma_only ? bwd_fn<true>() : bwd_fn<false>();
  const size_t smem = bwd_smem(r_max, feat, sigma_only).bytes;
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
  const int out_len = 3 * r_max * feat + dw_size(feat, kSigmaOnly);
  if (n == 0)
    return (int)cudaMemsetAsync(out, 0, (size_t)out_len * sizeof(float),
                                stream);
  if (grid < 1) return (int)cudaErrorInvalidValue;
  const BwdSmem sm = bwd_smem(r_max, feat, kSigmaOnly);
  cudaError_t err = cudaFuncSetAttribute(
      field_bwd_kernel<kSigmaOnly>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sm.bytes);
  if (err != cudaSuccess) return (int)err;
  field_bwd_kernel<kSigmaOnly><<<grid, kBlock, sm.bytes, stream>>>(
      x, sh, g, lines, wpack, dx, dsh, scratch, n, r_max, feat, sm.dw_budget);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int out4 = out_len / 4;
  field_bwd_reduce<<<(out4 + kReduceThreads - 1) / kReduceThreads,
                     kReduceThreads,
                     (size_t)reduce_units(feat) * grid, stream>>>(
      scratch, out, grid, bwd_row(r_max, feat, kSigmaOnly), out_len, r_max,
      feat);
  return (int)cudaGetLastError();
}

}  // namespace

// The number of persistent blocks K4 (K5 when sigma_only) runs for n points,
// the first dimension of its scratch buffer; negative: -cudaError_t.
extern "C" int gbnerf_field_fused_bwd_grid(int n, int r_max, int feat,
                                           int sigma_only) {
  return bwd_grid(n, r_max, feat, sigma_only != 0);
}

// Floats a block's row of the scratch buffer takes: its second dimension.
extern "C" int gbnerf_field_fused_bwd_row(int r_max, int feat,
                                          int sigma_only) {
  return bwd_row(r_max, feat, sigma_only != 0);
}

// x [n,3] f32, sh [n,16] f32 (unused when sigma_only), g [n,4] f32 (16-byte
// aligned), lines [3,r_max,feat] bf16, wpack the packed bf16 weights
// (ops/field_fused.py::pack_weights). Outputs: dx [n,3] and dsh [n,16] (each
// may be null: not stored), and out = dlines [3,r_max,feat] f32 followed by
// dw (the five weight gradients, Dense [in,out], one after the other) f32,
// written whole. scratch: [grid, gbnerf_field_fused_bwd_row(r_max, feat,
// sigma_only)] f32, uninitialised; grid: gbnerf_field_fused_bwd_grid(n,
// r_max, feat, sigma_only) (any grid ≥ 1 gives a right result; the sums'
// order follows the grid). feat % 4 == 0. Returns the cudaError_t of the
// launches (0 = success).
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

// K4's (K5's when sigma_only) build and launch at this shape → info[8]:
// registers and local (spill) bytes a thread, dynamic shared memory a
// block, blocks an SM, warps a block, blocks a cluster (1: none), dW floats
// held in shared memory, points a tile.
extern "C" int gbnerf_field_fused_bwd_info(int r_max, int feat,
                                           int sigma_only, int* info) {
  const void* fn = sigma_only ? bwd_fn<true>() : bwd_fn<false>();
  const BwdSmem sm = bwd_smem(r_max, feat, sigma_only != 0);
  cudaFuncAttributes attr{};
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)sm.bytes);
  int per_sm = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kBlock,
                                                        sm.bytes);
  info[0] = attr.numRegs;
  info[1] = (int)attr.localSizeBytes;
  info[2] = (int)sm.bytes;
  info[3] = per_sm;
  info[4] = kWarps;
  info[5] = 1;
  info[6] = sm.dw_used;
  info[7] = kTile;
  return (int)err;
}
