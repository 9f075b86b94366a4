// The CP field's heads on the tensor cores, one 16-point m-tile a warp:
// field_fused_bwd.cu's (K4/K5) recompute of the forward and its backward.
// field_fused.cu (K1/K2, the forward, on warpgroup products) shares the
// encode and fragment code (lane_taps' taps, enc_frag, sh_frag, h1_frag,
// c_to_a, the weights' packed layout), so that the two cannot drift.
//
// Every product is mma.sync.m16n8k16 (an m16n8k8 for the 8-deep g_rgb):
// bf16 operands, f32 sums, as the TPU kernels' dots with
// preferred_element_type=f32. A warp holds 16 points as the rows of each
// layer; a layer's f32 C fragments become the next layer's bf16 A fragments
// in registers (the two layouts line up: the C fragments of n-tiles 2j and
// 2j + 1 are the A fragment of k-chunk j), with relu and its mask applied in
// place. The weights live in shared memory, bf16, row-major [in][out] with
// padded rows (ops/field_fused.py::pack_weights writes this layout): x @ W
// reads B fragments with ldmatrix.trans, x @ Wᵀ with ldmatrix, from the one
// copy.
//
// The colour input hc = SH ⊕ h1[1:] is h1 itself in its second k-chunk,
// with the σ column zeroed in the A fragment and wc0 packed as 32 rows:
// wc0[0:16] (SH), a zero row, wc0[16:31]. So no column shift is needed,
// and in the backward dhc's column 16 (a zero column of wc0ᵀ) takes g_σ:
// dh1 = [g_σ, dhc[16:]] is dhc's second half as it stands.
#pragma once

#include "field_common.cuh"
#include "mma_common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 8;                 // warps a block (K4/K5)
constexpr int kBlock = 32 * kWarps;
constexpr int kS64 = row_stride(64);      // 72: rows of 64 columns
constexpr int kS32 = row_stride(32);      // 40
constexpr int kS16 = row_stride(16);      // 24
constexpr int kS8 = row_stride(8);        // 8

// F rounded up to the 16-deep k-chunks of the encode (padding features 0)
__host__ __device__ inline int feat_pad(int feat) { return (feat + 15) & ~15; }

// Row stride (bf16) of lines staged in shared memory: 4·odd words, so that
// 8 random rows fall on 8 distinct bank quads as often as they can
__host__ __device__ inline int line_stride(int feat) {
  return row_stride((feat + 7) & ~7);
}

// Element offsets of the packed bf16 weights: ws0 [Fp][72], ws1 [64][24],
// wc0 [32][72] (rows SH 0–15, zero, geo 1–15), wc1 [64][72], wc2 [64][8]
// (columns 3–7 zero); σ-only stops after ws1. Each padding entry is 0.
struct WLayout {
  int ws0, ws1, wc0, wc1, wc2, total;
};

__host__ __device__ inline WLayout weight_layout(int feat, bool sigma_only) {
  WLayout w;
  w.ws0 = 0;
  w.ws1 = feat_pad(feat) * kS64;
  w.wc0 = w.ws1 + 64 * kS16;
  w.wc1 = w.wc0 + 32 * kS64;
  w.wc2 = w.wc1 + 64 * kS64;
  w.total = sigma_only ? w.wc0 : w.wc2 + 64 * kS8;
  return w;
}

__device__ __forceinline__ int lane_id() { return threadIdx.x & 31; }

// n bf16 (a multiple of 8) global → shared, 16 bytes a thread and step
__device__ __forceinline__ void copy16(bf16* dst, const bf16* src, int n) {
  const uint4* s = reinterpret_cast<const uint4*>(src);
  uint4* d = reinterpret_cast<uint4*>(dst);
  for (int i = threadIdx.x; i < n / 8; i += blockDim.x) d[i] = s[i];
}

// The two taps of each axis for this lane's two points of an m-tile (rows
// g and g + 8 of the tile, p0 its first point): element offsets of the tap
// rows i0 in lines of row stride ls, and the bf16 tap weights. A point past
// n is computed at x = 0.5 (its cotangents are zero).
struct LaneTaps {
  int off[2][3];
  float w0[2][3], w1[2][3];
};

__device__ __forceinline__ void lane_taps(LaneTaps& t, const float* x, int p0,
                                          int n, int r_max, int ls) {
  const int g = lane_id() >> 2;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int p = p0 + g + 8 * h;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const CpTap c = cp_tap(p < n ? x[3 * p + a] : 0.5f, r_max);
      t.off[h][a] = (a * r_max + c.i0) * ls;
      t.w0[h][a] = c.w0;
      t.w1[h][a] = c.w1;
    }
  }
}

// The feature order of a 16-deep k-chunk: position k holds feature
// 4·((k & 7) >> 1) + 2·(k >> 3) + (k & 1) of the chunk, so that the four A
// (and C) entries of lane tig, k = 2tig, 2tig + 1, 2tig + 8, 2tig + 9, are
// its features 4tig … 4tig + 3: one 8-byte load a tap row. ws0's rows are
// packed in this order (ops/field_fused.py::pack_weights); feat_pos maps a
// feature back to its position.
__host__ __device__ inline int feat_pos(int f) {
  const int r = f & 15;
  return (f & ~15) + 2 * (r >> 2) + (r & 1) + 8 * ((r >> 1) & 1);
}

// The tap rows of this lane's two points at k-chunk kc: each axis's two
// rows at the lane's features 16kc + 4tig … + 3 (0 past F; F is a
// multiple of 4), raw bf16, so that they can be loaded ahead of their use
struct LaneRows {
  uint2 r[2][3][2];
};

__device__ __forceinline__ void load_rows(LaneRows& R, const LaneTaps& t,
                                          const bf16* lines, int ls, int feat,
                                          int kc) {
  const int f = kc * 16 + 4 * (lane_id() & 3);
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const bf16* r = lines + t.off[h][a] + f;
      R.r[h][a][0] = f < feat ? *reinterpret_cast<const uint2*>(r)
                              : make_uint2(0u, 0u);
      R.r[h][a][1] = f < feat ? *reinterpret_cast<const uint2*>(r + ls)
                              : make_uint2(0u, 0u);
    }
}

// The three axes' 2-tap lerps fa_a of point half h at the four features
// of R, and the tap rows' values l0, l1
__device__ __forceinline__ void lerp3x4(float fa[3][4], float l0[3][4],
                                        float l1[3][4], const LaneRows& R,
                                        const LaneTaps& t, int h) {
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    unpack4(R.r[h][a][0], l0[a]);
    unpack4(R.r[h][a][1], l1[a]);
#pragma unroll
    for (int q = 0; q < 4; ++q)
      fa[a][q] = fmaf(t.w1[h][a], l1[a][q], t.w0[h][a] * l0[a][q]);
  }
}

// The A fragment of bf16(enc) [16 points × 16 features] at k-chunk kc:
// enc = fa_0 · fa_1 · fa_2 of lane tig's features 16kc + 4tig … + 3 from
// its tap rows R (0 past F)
__device__ __forceinline__ void enc_from_rows(uint32_t a[4], const LaneRows& R,
                                              const LaneTaps& t, int feat,
                                              int kc) {
  const int f = kc * 16 + 4 * (lane_id() & 3);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (f >= feat) {
      a[h] = a[2 + h] = 0u;
      continue;
    }
    float fa[3][4], l0[3][4], l1[3][4];
    lerp3x4(fa, l0, l1, R, t, h);
    float e[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) e[q] = (fa[0][q] * fa[1][q]) * fa[2][q];
    a[h] = pack_bf16(e[0], e[1]);
    a[2 + h] = pack_bf16(e[2], e[3]);
  }
}

// enc_from_rows with each point half's rows loaded just before its lerps
// (K1/K2's encode when their lines are read through L1/L2; from staged
// lines they take field_fused.cu::enc_frag_s, the same values)
__device__ __forceinline__ void enc_frag(uint32_t a[4], const LaneTaps& t,
                                         const bf16* lines, int ls, int feat,
                                         int kc) {
  const int f = kc * 16 + 4 * (lane_id() & 3);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (f >= feat) {
      a[h] = a[2 + h] = 0u;
      continue;
    }
    float fa[3][4], l0[3][4], l1[3][4];
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) {
      const bf16* r = lines + t.off[h][ax] + f;
      unpack4(*reinterpret_cast<const uint2*>(r), l0[ax]);
      unpack4(*reinterpret_cast<const uint2*>(r + ls), l1[ax]);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        fa[ax][q] = fmaf(t.w1[h][ax], l1[ax][q], t.w0[h][ax] * l0[ax][q]);
    }
    float e[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) e[q] = (fa[0][q] * fa[1][q]) * fa[2][q];
    a[h] = pack_bf16(e[0], e[1]);
    a[2 + h] = pack_bf16(e[2], e[3]);
  }
}

// B fragments of n-tiles nt, nt + 1 at k-chunk kc of W [K][N] (stride s),
// for x @ W (ldmatrix.trans of the row-major rows)
__device__ __forceinline__ void ldb_w(uint32_t b[4], const bf16* w, int s,
                                      int kc, int nt) {
  const int l = lane_id();
  ldm_x4_t(b, w + (kc * 16 + (l & 7) + ((l >> 3) & 1) * 8) * s
                  + (nt + (l >> 4)) * 8);
}

// ... of Wᵀ for x @ Wᵀ, W [N][K] (stride s): n-tiles are W's rows
__device__ __forceinline__ void ldb_wt(uint32_t b[4], const bf16* w, int s,
                                       int kc, int nt) {
  const int l = lane_id();
  ldm_x4(b, w + ((nt + (l >> 4)) * 8 + (l & 7)) * s + kc * 16
                + ((l >> 3) & 1) * 8);
}

// c[NT] += A[KC] @ W, W [16·KC][8·NT] (stride s)
template <int KC, int NT>
__device__ __forceinline__ void mm_w(float c[NT][4], const uint32_t a[KC][4],
                                     const bf16* w, int s) {
#pragma unroll
  for (int kc = 0; kc < KC; ++kc)
#pragma unroll
    for (int nt = 0; nt < NT; nt += 2) {
      uint32_t b[4];
      ldb_w(b, w, s, kc, nt);
      mma_bf16(c[nt], a[kc], b[0], b[1]);
      mma_bf16(c[nt + 1], a[kc], b[2], b[3]);
    }
}

// c[NT] += A[KC] @ Wᵀ, W [8·NT][16·KC] (stride s)
template <int KC, int NT>
__device__ __forceinline__ void mm_wt(float c[NT][4], const uint32_t a[KC][4],
                                      const bf16* w, int s) {
#pragma unroll
  for (int kc = 0; kc < KC; ++kc)
#pragma unroll
    for (int nt = 0; nt < NT; nt += 2) {
      uint32_t b[4];
      ldb_wt(b, w, s, kc, nt);
      mma_bf16(c[nt], a[kc], b[0], b[1]);
      mma_bf16(c[nt + 1], a[kc], b[2], b[3]);
    }
}

template <int NT>
__device__ __forceinline__ void zero(float c[NT][4]) {
#pragma unroll
  for (int i = 0; i < NT; ++i) c[i][0] = c[i][1] = c[i][2] = c[i][3] = 0.f;
}

// The A fragments of the C fragments of n-tiles (2j, 2j + 1), as they are
template <int NT>
__device__ __forceinline__ void c_to_a(uint32_t a[NT / 2][4],
                                       const float c[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT / 2; ++j) {
    a[j][0] = pack_bf16(c[2 * j][0], c[2 * j][1]);
    a[j][1] = pack_bf16(c[2 * j][2], c[2 * j][3]);
    a[j][2] = pack_bf16(c[2 * j + 1][0], c[2 * j + 1][1]);
    a[j][3] = pack_bf16(c[2 * j + 1][2], c[2 * j + 1][3]);
  }
}

// relu in place; bit 4·nt + i of the mask: c[nt][i] > 0
template <int NT>
__device__ __forceinline__ uint32_t relu_mask(float c[NT][4]) {
  uint32_t m = 0;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      m |= (uint32_t)(c[nt][i] > 0.f) << (4 * nt + i);
      c[nt][i] = fmaxf(c[nt][i], 0.f);
    }
  return m;
}

// c ⊙ [mask] (the backward through a relu), as a select
template <int NT>
__device__ __forceinline__ void apply_mask(float c[NT][4], uint32_t m) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      c[nt][i] = ((m >> (4 * nt + i)) & 1u) ? c[nt][i] : 0.f;
}

// Store A fragments [KC] as rows g, g + 8 of buf [16 points][stride s]
template <int KC>
__device__ __forceinline__ void st_a(bf16* buf, int s, const uint32_t a[KC][4]) {
  const int l = lane_id(), g = l >> 2, c = 2 * (l & 3);
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
    uint32_t* r0 = reinterpret_cast<uint32_t*>(buf + g * s + kc * 16 + c);
    uint32_t* r1 = reinterpret_cast<uint32_t*>(buf + (g + 8) * s + kc * 16 + c);
    r0[0] = a[kc][0];
    r1[0] = a[kc][1];
    r0[4] = a[kc][2];
    r1[4] = a[kc][3];
  }
}

// The A fragment [16 rows × 16] at k-chunk kc of rows [16][stride s]
__device__ __forceinline__ void ld_a(uint32_t a[4], const bf16* buf, int s,
                                     int kc) {
  const int l = lane_id();
  ldm_x4(a, buf + ((l & 7) + ((l >> 3) & 1) * 8) * s + kc * 16 + (l >> 4) * 8);
}

// The A fragment of Actᵀ [16 in × 16 points] at in-tile it and point
// chunk ks, from Act [points][stride s] (ldmatrix.trans): the left operand
// of a weight gradient dW = Σ_points act ⊗ cot
__device__ __forceinline__ void lda_t(uint32_t a[4], const bf16* act, int s,
                                      int it, int ks) {
  const int l = lane_id(), j = l >> 3;
  ldm_x4_t(a, act + (ks * 16 + (l & 7) + (j >> 1) * 8) * s + it * 16
                  + (j & 1) * 8);
}

// c[NT] += |A[KC]| @ |W|: Σ_k |a_k·w_k| of every entry, the scale of the
// f32 sum's rounding error (the sign bits of both operands cleared)
template <int KC, int NT>
__device__ __forceinline__ void mm_w_abs(float c[NT][4],
                                         const uint32_t a[KC][4],
                                         const bf16* w, int s) {
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
    uint32_t aa[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) aa[i] = a[kc][i] & 0x7fff7fffu;
#pragma unroll
    for (int nt = 0; nt < NT; nt += 2) {
      uint32_t b[4];
      ldb_w(b, w, s, kc, nt);
#pragma unroll
      for (int i = 0; i < 4; ++i) b[i] &= 0x7fff7fffu;
      mma_bf16(c[nt], aa, b[0], b[1]);
      mma_bf16(c[nt + 1], aa, b[2], b[3]);
    }
  }
}

// The relative size of the tensor cores' f32 sum against a sequential one,
// in units of Σ|a·w|: a bound on their difference (both are within a few
// 2^-24·Σ|a·w| of the exact sum), with room to spare.
constexpr float kSeqTol = 1.0f / (1 << 17);

// Σ_f x[k_f]·w[k_f·sw] over f = 0 … K − 1 in f order with f32 FMAs, k_f =
// feat_pos(f) when kPerm (else f), leaving out position skip; K % 4 == 0.
// Four features a step: their x entries by one 8-byte load (two 4-byte
// loads of positions b, b + 1, b + 8, b + 9 when kPerm) and their w
// entries all loaded before the step's FMAs, so that the loads of the
// unrolled steps run ahead of the chain.
template <bool kPerm>
__device__ __forceinline__ float seq_dot(const bf16* xr, const bf16* wc,
                                         int sw, int K, int skip) {
  float acc = 0.f;
#pragma unroll 4
  for (int f = 0; f < K; f += 4) {
    float xv[4];
    int k[4];
    if (kPerm) {
      const int b = (f & ~15) + 2 * ((f & 15) >> 2);
      const __nv_bfloat162 x0 = *reinterpret_cast<const __nv_bfloat162*>(xr + b);
      const __nv_bfloat162 x1 =
          *reinterpret_cast<const __nv_bfloat162*>(xr + b + 8);
      xv[0] = __low2float(x0);
      xv[1] = __high2float(x0);
      xv[2] = __low2float(x1);
      xv[3] = __high2float(x1);
      k[0] = b;
      k[1] = b + 1;
      k[2] = b + 8;
      k[3] = b + 9;
    } else {
      unpack4(*reinterpret_cast<const uint2*>(xr + f), xv);
#pragma unroll
      for (int i = 0; i < 4; ++i) k[i] = f + i;
    }
    float wv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) wv[i] = __bfloat162float(wc[k[i] * sw]);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (k[i] != skip) acc = fmaf(xv[i], wv[i], acc);
  }
  return acc;
}

// The index of the j-th set bit (from 0) of m, j < popc(m): a popc
// bisection, with no loop of j steps
__device__ __forceinline__ int nth_bit(uint32_t m, int j) {
  int pos = 0;
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) {
    const uint32_t lower = m & ((1u << w) - 1u);
    const int c = __popc(lower);
    if (j >= c) {
      j -= c;
      m >>= w;
      pos += w;
    } else {
      m = lower;
    }
  }
  return pos;
}

// Where the order of an f32 sum can decide a discrete outcome, take it in
// sequential order. c: a layer's sums of products x[row] · W[:, col] (16
// rows of x at stride sx, bf16, in shared memory; W [K][·] at stride sw),
// s: their Σ|x·w|. An entry whose bf16 rounding (after relu when kRelu,
// which also decides the relu mask) could change within ±kSeqTol·s is
// recomputed as Σ_k x_k·w_k in k order with f32 FMAs, skipping row `skip`
// of W (wc0's zero row), over the features in their own order where the k
// positions are kPerm's (h0): the sum an f32 matrix product takes, so that
// the backward's masks and bf16 activations are those of the plain version.
// Elsewhere the two sums round alike.
template <int NT, bool kRelu, bool kPerm = false>
__device__ __forceinline__ void seq_fixup(float c[NT][4], const float s[NT][4],
                                          const bf16* x, int sx, int K,
                                          const bf16* w, int sw, int skip) {
  static_assert(NT * 4 <= 32, "one bit an entry");
  uint32_t todo = 0;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float e = s[nt][i] * kSeqTol;
      float lo = c[nt][i] - e, hi = c[nt][i] + e;
      if (kRelu) {
        lo = fmaxf(lo, 0.f);
        hi = fmaxf(hi, 0.f);
      }
      if (bf16_round(lo) != bf16_round(hi)) todo |= 1u << (4 * nt + i);
    }
  // The warp's entries to redo, in lane order (lane L's from excl on), are
  // shared out 32 a pass: lane L of a pass takes entry base + L, whoever
  // owns it, and the owners collect their sums by shuffles.
  const unsigned full = 0xffffffffu;
  const int l = lane_id();
  const int cnt = __popc(todo);
  int excl = cnt;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(full, excl, o);
    if (l >= o) excl += v;
  }
  const int total = __shfl_sync(full, excl, 31);
  excl -= cnt;
  uint32_t pending = todo;    // this lane's entries not collected yet
  for (int base = 0; base < total; base += 32) {
    const int q = base + l;
    int own = 0;      // the last lane whose entries start at or before q
#pragma unroll
    for (int step = 16; step > 0; step >>= 1)
      if (__shfl_sync(full, excl, own + step) <= q) own += step;
    const int e = nth_bit(__shfl_sync(full, todo, own),
                          q - __shfl_sync(full, excl, own));
    const int nt = e >> 2, i = e & 3;
    const bf16* xr = x + ((own >> 2) + 8 * (i >> 1)) * sx;
    const bf16* wc = w + nt * 8 + 2 * (own & 3) + (i & 1);
    const float acc = q < total ? seq_dot<kPerm>(xr, wc, sw, K, skip) : 0.f;
    // this lane's entries in the pass: its j = lo … hi − 1
    const int lo = max(excl, base) - excl;
    const int hi = min(excl + cnt, base + 32) - excl;
    const int mine = max(hi - lo, 0);
    const int rounds = __reduce_max_sync(full, mine);
    for (int r = 0; r < rounds; ++r) {
      const float v = __shfl_sync(full, acc, (excl + lo + r - base) & 31);
      if (r < mine) {       // entries are collected in rank order
        const int e2 = __ffs(pending) - 1;
        pending &= pending - 1u;
#pragma unroll
        for (int n2 = 0; n2 < NT; ++n2)
#pragma unroll
          for (int i2 = 0; i2 < 4; ++i2)
            if (e2 == 4 * n2 + i2) c[n2][i2] = v;
      }
    }
  }
}

// The backward's recompute of a warp's 16 points, up to h1 (the σ-net).
// h0 = relu(bf16(enc) @ ws0); A0 = bf16(h0); h1 = A0 @ ws1 (h1 only when
// kH1). bf16(enc) goes to the prod rows and A0 to a0buf. h0 and h1 take
// seq_fixup, so the masks and bf16 activations are the plain version's.
// Returns the mask of h0 > 0.
template <bool kH1>
__device__ __forceinline__ uint32_t sigma_net(
    float h1[2][4], const LaneTaps& t, const bf16* lines, int ls, int feat,
    const bf16* sw, const WLayout& W, bf16* prod, int ps, bf16* a0buf) {
  float c[8][4], sa[8][4];
  zero<8>(c);
  zero<8>(sa);
  const int kcs = feat_pad(feat) / 16;
  // the tap rows two k-chunks ahead of their use
  LaneRows R, R2;
  load_rows(R, t, lines, ls, feat, 0);
  if (kcs > 1) load_rows(R2, t, lines, ls, feat, 1);
  for (int kc = 0; kc < kcs; ++kc) {
    uint32_t a[1][4];
    enc_from_rows(a[0], R, t, feat, kc);
    R = R2;
    if (kc + 2 < kcs) load_rows(R2, t, lines, ls, feat, kc + 2);
    st_a<1>(prod + kc * 16, ps, a);
#pragma unroll
    for (int nt = 0; nt < 8; nt += 2) {
      uint32_t b[4];
      ldb_w(b, sw + W.ws0, kS64, kc, nt);
      mma_bf16(c[nt], a[0], b[0], b[1]);
      mma_bf16(c[nt + 1], a[0], b[2], b[3]);
    }
    uint32_t aa[1][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) aa[0][i] = a[0][i];
    float sk[8][4];
    zero<8>(sk);
    mm_w_abs<1, 8>(sk, aa, sw + W.ws0 + kc * 16 * kS64, kS64);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) sa[nt][i] += sk[nt][i];
  }
  __syncwarp();
  seq_fixup<8, true, true>(c, sa, prod, ps, feat, sw + W.ws0, kS64, -1);
  const uint32_t m0 = relu_mask<8>(c);
  uint32_t a0[4][4];
  c_to_a<8>(a0, c);
  st_a<4>(a0buf, kS64, a0);
  if (kH1) {
    zero<2>(h1);
    mm_w<4, 2>(h1, a0, sw + W.ws1, kS16);
    float s1[2][4];
    zero<2>(s1);
    mm_w_abs<4, 2>(s1, a0, sw + W.ws1, kS16);
    __syncwarp();
    seq_fixup<2, false>(h1, s1, a0buf, kS64, 64, sw + W.ws1, kS16, -1);
  }
  return m0;
}

// k-chunk 0 of hc's A fragments: bf16(SH) of this lane's two points of
// the m-tile at p0 (zero past n)
__device__ __forceinline__ void sh_frag(uint32_t a[4], const float* sh, int p0,
                                        int n) {
  const int l = lane_id(), g = l >> 2, c = 2 * (l & 3);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int p = p0 + g + 8 * h;
    float2 lo = make_float2(0.f, 0.f), hi = lo;
    if (p < n) {
      lo = *reinterpret_cast<const float2*>(sh + (size_t)p * kSh + c);
      hi = *reinterpret_cast<const float2*>(sh + (size_t)p * kSh + 8 + c);
    }
    a[h] = pack_bf16(lo.x, lo.y);
    a[2 + h] = pack_bf16(hi.x, hi.y);
  }
}

// k-chunk 1 of hc's A fragments: bf16(h1) with the σ column zeroed
__device__ __forceinline__ void h1_frag(uint32_t a[4], const float h1[2][4]) {
  const bool col0 = (lane_id() & 3) == 0;
  a[0] = pack_bf16(col0 ? 0.f : h1[0][0], h1[0][1]);
  a[1] = pack_bf16(col0 ? 0.f : h1[0][2], h1[0][3]);
  a[2] = pack_bf16(h1[1][0], h1[1][1]);
  a[3] = pack_bf16(h1[1][2], h1[1][3]);
}

// The backward's recompute of the colour net after hc (hcbuf holding hc):
// A2 = bf16(relu(hc @ wc0)) to a2buf, A3 = bf16(relu(A2 @ wc1)) to a3buf;
// h2 and h3 take seq_fixup. Returns the masks of h2 > 0 and h3 > 0.
__device__ __forceinline__ void color_net(uint32_t& m2, uint32_t& m3,
                                          const uint32_t hc[2][4],
                                          const bf16* sw, const WLayout& W,
                                          const bf16* hcbuf, bf16* a2buf,
                                          bf16* a3buf) {
  float c[8][4], sa[8][4];
  zero<8>(c);
  mm_w<2, 8>(c, hc, sw + W.wc0, kS64);
  zero<8>(sa);
  mm_w_abs<2, 8>(sa, hc, sw + W.wc0, kS64);
  __syncwarp();
  seq_fixup<8, true>(c, sa, hcbuf, kS32, 32, sw + W.wc0, kS64, kSh);
  m2 = relu_mask<8>(c);
  uint32_t a[4][4];
  c_to_a<8>(a, c);
  st_a<4>(a2buf, kS64, a);
  zero<8>(c);
  mm_w<4, 8>(c, a, sw + W.wc1, kS64);
  zero<8>(sa);
  mm_w_abs<4, 8>(sa, a, sw + W.wc1, kS64);
  __syncwarp();
  seq_fixup<8, true>(c, sa, a2buf, kS64, 64, sw + W.wc1, kS64, -1);
  m3 = relu_mask<8>(c);
  c_to_a<8>(a, c);
  st_a<4>(a3buf, kS64, a);
}

}  // namespace
