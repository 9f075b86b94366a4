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
// GFLOP in all: 0.053 ms on the bf16 tensor cores (989 TFLOP/s). The bytes
// (x, SH in, raw out: ≈ 0.058 ms at 3.35 TB/s) set the bound. What holds
// it is the encode's instruction stream: 6 line values gathered, unpacked
// and lerped, and ≈ 11 f32 operations a feature and point (≈ 0.08 ms of
// issue at F 80), and each warpgroup's chain of dependent products.
//
// Design: each warpgroup (4 warps) takes 64 points a step and runs every
// layer as warpgroup products m64nNk16 with A from registers: ws0, wc0 and
// wc1 at N 64, ws1 at N 16, wc2 at N 8. Each warp's A fragments are those
// of mma.sync for its 16 rows, and a product's accumulators are its C
// fragments, so the encode's values (field_tile.cuh::enc_frag's: the A
// fragment of bf16(enc), one 8-byte load a tap row) and the layer-to-layer
// conversion (c_to_a's layout) are the mma.sync design's. B is read by the
// tensor cores from a copy of the weights that each persistent block
// stages once in shared memory, in the products' no-swizzle K-major layout
// (b_layout): once per 64 points, where the earlier mma.sync design
// read every B fragment with ldmatrix for every 16 (1,600 B a point at F
// 80). The products are asynchronous: the encode of k-chunk kc + 1 runs
// while chunk kc's product is in flight (two A buffers). The unified lines
// (3 × 257 × 88 bf16 = 136 KB at F 80, rows padded to 4·odd words) are
// staged in shared memory by cp.async when they fit (one block of 4
// warpgroups an SM), else read through L1/L2; the kernel is templated on
// which, so that staged tap rows are read by LDS at 32-bit addresses
// computed once a tile (a pointer that may be either makes every read a
// generic load with 64-bit address arithmetic). x is loaded a tile ahead
// and SH at a tile's start; relu is folded into the bf16 conversion.
// tools/prof_field_fwd_parts.py times copies of this kernel with one part
// taken out, and a clock64 timeline of a tile; PERF.md §6 has both
// designs' parts.

#include <mutex>

#include "field_tile.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kFwdWG = 4;                    // warpgroups a block
constexpr int kFwdBlock = 128 * kFwdWG;
constexpr int kFwdTile = 64;                 // points a warpgroup step

// Element offsets of the weights as the products read B: each weight
// W [K][N] (K rows in the packed buffer's order: ws0's in feat_pos's chunk
// order, wc0's SH, zero, geo) as core matrices of 8 columns × 8 rows,
// 128 bytes each, k-rows contiguous (K-major), core matrix (k/8, n/8) at
// ((k/8)·(N/8) + n/8)·64. σ-only stops after ws1.
struct BLayout {
  int ws0, ws1, wc0, wc1, wc2, total;
};

__host__ __device__ inline BLayout b_layout(int feat, bool sigma_only) {
  BLayout b;
  b.ws0 = 0;
  b.ws1 = feat_pad(feat) * kSigmaWidth;
  b.wc0 = b.ws1 + kSigmaWidth * kGeo;
  b.wc1 = b.wc0 + 32 * kColorWidth;
  b.wc2 = b.wc1 + kColorWidth * kColorWidth;
  b.total = sigma_only ? b.wc0 : b.wc2 + kColorWidth * 8;
  return b;
}

// W [K][N] from the packed buffer (row stride s) into its B layout at dst:
// 8 columns of a row a 16-byte load (the loads of a thread all in flight
// before its stores), each element to its core-matrix row
__device__ __forceinline__ void stage_b(bf16* dst, const bf16* src, int s,
                                        int K, int N) {
  const int q = N / 8;
#pragma unroll 4
  for (int i = threadIdx.x; i < K * q; i += blockDim.x) {
    const int k = i / q, c0 = (i % q) * 8;
    const uint4 v = *reinterpret_cast<const uint4*>(src + k * s + c0);
    const bf16* e = reinterpret_cast<const bf16*>(&v);
    bf16* d = dst + ((k >> 3) * q + (c0 >> 3)) * 64 + (k & 7);
#pragma unroll
    for (int j = 0; j < 8; ++j) d[j * 8] = e[j];
  }
}

// 8 bytes global → shared, asynchronously (cp.async.ca)
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

// x of this lane's two points (rows g and g + 8 of the 16 at p0; 0.5 past
// n), loaded a tile ahead of lane_taps_of
__device__ __forceinline__ void load_x(float (&xr)[2][3], const float* x,
                                       int p0, int n) {
  const int g = lane_id() >> 2;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int p = p0 + g + 8 * h;
#pragma unroll
    for (int a = 0; a < 3; ++a) xr[h][a] = p < n ? x[3 * p + a] : 0.5f;
  }
}

// SH of this lane's two points (field_tile.cuh::sh_frag's entries, raw,
// so that they load at a tile's start and pack at wc0, their latency under
// the encode): [h][0] columns 2·tig, + 1 and [h][1] columns 8 + 2·tig,
// + 1 of row g + 8h (zero past n)
__device__ __forceinline__ void load_sh(float2 (&r)[2][2], const float* sh,
                                        int p0, int n) {
  const int l = lane_id(), g = l >> 2, c = 2 * (l & 3);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int p = p0 + g + 8 * h;
    r[h][0] = r[h][1] = make_float2(0.f, 0.f);
    if (p < n) {
      r[h][0] = *reinterpret_cast<const float2*>(sh + (size_t)p * kSh + c);
      r[h][1] = *reinterpret_cast<const float2*>(sh + (size_t)p * kSh + 8 + c);
    }
  }
}

// field_tile.cuh::lane_taps from x in registers, each tap row's offset
// obase + row·ostride (a shared byte address when the lines are staged,
// else an element offset)
__device__ __forceinline__ void lane_taps_of(LaneTaps& t,
                                             const float (&xr)[2][3],
                                             int r_max, int obase,
                                             int ostride) {
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const CpTap c = cp_tap(xr[h][a], r_max);
      t.off[h][a] = obase + (a * r_max + c.i0) * ostride;
      t.w0[h][a] = c.w0;
      t.w1[h][a] = c.w1;
    }
}

// 8 bytes of shared memory at byte address a
__device__ __forceinline__ uint2 lds64(uint32_t a) {
  uint2 v;
  asm("ld.shared.v2.u32 {%0, %1}, [%2];\n" : "=r"(v.x), "=r"(v.y) : "r"(a));
  return v;
}

// field_tile.cuh::enc_frag from staged lines: t.off the tap rows' shared
// byte addresses, ls2 the row stride in bytes, fo the byte offset of this
// lane's four features (clamped into the row; valid: they are < F). The
// same values, with one instruction a bf16 → f32 and no 64-bit address
// arithmetic.
__device__ __forceinline__ void enc_frag_s(uint32_t a[4], const LaneTaps& t,
                                           int ls2, int fo, bool valid) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float fa[3][4];
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) {
      const uint32_t r = t.off[h][ax] + fo;
      const uint2 r0 = lds64(r), r1 = lds64(r + ls2);
      const float l0[4] = {__uint_as_float(r0.x << 16),
                           __uint_as_float(r0.x & 0xffff0000u),
                           __uint_as_float(r0.y << 16),
                           __uint_as_float(r0.y & 0xffff0000u)};
      const float l1[4] = {__uint_as_float(r1.x << 16),
                           __uint_as_float(r1.x & 0xffff0000u),
                           __uint_as_float(r1.y << 16),
                           __uint_as_float(r1.y & 0xffff0000u)};
#pragma unroll
      for (int q = 0; q < 4; ++q)
        fa[ax][q] = fmaf(t.w1[h][ax], l1[q], t.w0[h][ax] * l0[q]);
    }
    float e[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) e[q] = (fa[0][q] * fa[1][q]) * fa[2][q];
    a[h] = valid ? pack_bf16(e[0], e[1]) : 0u;
    a[2 + h] = valid ? pack_bf16(e[2], e[3]) : 0u;
  }
}

// The A fragment of bf16(enc) at k-chunk kc: from the staged lines, or
// through L1/L2 (field_tile.cuh::enc_frag)
template <bool kStaged>
__device__ __forceinline__ void encode(uint32_t a[4], const LaneTaps& t,
                                       const bf16* lines, int ls, int feat,
                                       int kc) {
  if (kStaged) {
    const int f = kc * 16 + 4 * (lane_id() & 3);
    enc_frag_s(a, t, 2 * ls, 2 * min(f, feat - 4), f < feat);
  } else {
    enc_frag(a, t, lines, ls, feat, kc);
  }
}

// The descriptor of k-chunk kc of a staged weight of N columns at shared
// byte address w: no swizzle, K-major; the leading byte offset steps to the
// next 8 k-rows (N/8 core matrices on), the stride byte offset to the next
// 8 columns (one core matrix on)
__device__ __forceinline__ uint64_t b_desc(uint32_t w, int n, int kc) {
  const uint32_t a = w + kc * n * 32, lbo = n * 16, sbo = 128;
  return (uint64_t)((a & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}

// d (+)= a · B_kc for the warpgroup's 64 points, asynchronously (acc = 0:
// d = a · B_kc)
template <int N>
__device__ __forceinline__ void head_mma(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint32_t w,
                                         int kc, int acc) {
  wgmma_rs<N, 0>(d, a, b_desc(w, N, kc), acc);
}

// keeps the compiler from moving accesses of an A fragment across a wgmma
// issue or wait
__device__ __forceinline__ void fence_a(uint32_t (&a)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[e])::"memory");
}

// bf16(relu(lo)), bf16(relu(hi)) packed as pack_bf16 packs (one
// instruction; a NaN stays NaN, as the plain version's relu keeps it)
__device__ __forceinline__ uint32_t pack_relu(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.relu.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// The next layer's A fragments of relu(c): c_to_a's with the relu in the
// conversion
__device__ __forceinline__ void relu_to_a(uint32_t (&a)[4][4],
                                          const float (&c)[32]) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      a[j][e] = pack_relu(c[8 * j + 2 * e], c[8 * j + 2 * e + 1]);
}

// c = A[0..3] · B for a 64-deep layer of N columns at w
template <int N>
__device__ __forceinline__ void layer64(float (&c)[N / 2],
                                        uint32_t (&a)[4][4], uint32_t w) {
  fence_regs(c);
  fence_regs(a);
  wg_fence();
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) head_mma<N>(c, a[kc], w, kc, kc);
  wg_commit();
  wg_wait<0>();
  fence_regs(c);
}

// kStaged: the lines in shared memory, read by shared-memory loads (a
// pointer that may be either would make every tap-row read a generic load
// with 64-bit address arithmetic)
template <bool kSigmaOnly, bool kStaged>
__global__ void __launch_bounds__(kFwdBlock, 1)
field_fused_kernel(const float* __restrict__ x, const float* __restrict__ sh,
                   const bf16* __restrict__ lines,
                   const bf16* __restrict__ wpack, float* __restrict__ out,
                   int n, int r_max, int feat) {
  extern __shared__ __align__(128) unsigned char smem[];
  const WLayout W = weight_layout(feat, kSigmaOnly);
  const BLayout B = b_layout(feat, kSigmaOnly);
  bf16* sb = reinterpret_cast<bf16*>(smem);
  const bf16* L = lines;
  int ls = feat;
  if (kStaged) {       // [3·R_max][line_stride] bf16, 8 B a copy, async
    bf16* sl = sb + B.total;
    ls = line_stride(feat);
    const int q = feat / 4;
    for (int i = threadIdx.x; i < 3 * r_max * q; i += blockDim.x)
      cp_async8(sl + (i / q) * ls + (i % q) * 4, lines + 4 * i);
    cp_async_commit();
    L = sl;
  }
  stage_b(sb + B.ws0, wpack + W.ws0, kS64, feat_pad(feat), kSigmaWidth);
  stage_b(sb + B.ws1, wpack + W.ws1, kS16, kSigmaWidth, kGeo);
  if (!kSigmaOnly) {
    stage_b(sb + B.wc0, wpack + W.wc0, kS64, 32, kColorWidth);
    stage_b(sb + B.wc1, wpack + W.wc1, kS64, kColorWidth, kColorWidth);
    stage_b(sb + B.wc2, wpack + W.wc2, kS8, kColorWidth, 8);
  }
  cp_async_wait<0>();
  // the products read the staged weights through the async proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  const uint32_t sbase = smem_addr(sb);
  const uint32_t w_ws0 = sbase + 2 * B.ws0, w_ws1 = sbase + 2 * B.ws1;
  const uint32_t w_wc0 = sbase + 2 * B.wc0, w_wc1 = sbase + 2 * B.wc1;
  const uint32_t w_wc2 = sbase + 2 * B.wc2;
  const int l = lane_id(), tig = l & 3;
  const int kcs = feat_pad(feat) / 16;
  const int tiles = (n + kFwdTile - 1) / kFwdTile;
  const int row0 = 16 * ((threadIdx.x >> 5) & 3);   // this warp's 16 rows
  const int step = gridDim.x * kFwdWG;
  int tile = blockIdx.x * kFwdWG + (threadIdx.x >> 7);
  // x of the warp's points a tile ahead, SH (K1) at the tile's start:
  // their loads run under the encode
  float xr[2][3];
  load_x(xr, x, tile * kFwdTile + row0, n);
  for (; tile < tiles; tile += step) {
    const int p0 = tile * kFwdTile + row0;
    LaneTaps t;
    lane_taps_of(t, xr, r_max, kStaged ? (int)smem_addr(L) : 0,
                 kStaged ? 2 * ls : ls);
    load_x(xr, x, (tile + step) * kFwdTile + row0, n);
    float2 shr[2][2];
    if (!kSigmaOnly) load_sh(shr, sh, p0, n);
    // h0 = bf16(enc) @ ws0: the encode of k-chunk kc + 1 into the other A
    // buffer while chunk kc's product runs
    float c[32] = {};
    uint32_t ea[4], eb[4];
    encode<kStaged>(ea, t, L, ls, feat, 0);
    for (int kc = 0; kc < kcs; kc += 2) {
      __syncwarp();
      fence_regs(c);
      fence_a(ea);
      wg_fence();
      head_mma<64>(c, ea, w_ws0, kc, kc);
      wg_commit();
      if (kc + 1 < kcs) {
        wg_wait<1>();              // chunk kc − 1's product is done with eb
        fence_a(eb);
        encode<kStaged>(eb, t, L, ls, feat, kc + 1);
        __syncwarp();
        fence_a(eb);
        wg_fence();
        head_mma<64>(c, eb, w_ws0, kc + 1, 1);
        wg_commit();
      }
      if (kc + 2 < kcs) {
        wg_wait<1>();              // chunk kc's product is done with ea
        fence_a(ea);
        encode<kStaged>(ea, t, L, ls, feat, kc + 2);
      }
    }
    __syncwarp();
    wg_wait<0>();
    fence_regs(c);
    // h1 = bf16(h0) @ ws1
    uint32_t a[4][4];
    relu_to_a(a, c);
    float h1[8] = {};
    fence_regs(h1);
    fence_regs(a);
    wg_fence();
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) head_mma<16>(h1, a[kc], w_ws1, kc, kc);
    wg_commit();
    wg_wait<0>();
    fence_regs(h1);
    // σ = h1[:, 0]: entries 0 (row g) and 2 (row g + 8) of lanes tig 0
    const int pa = p0 + (l >> 2), pb = pa + 8;
    if (kSigmaOnly) {
      if (tig == 0) {
        if (pa < n)
          reinterpret_cast<float4*>(out)[pa] = make_float4(0.f, 0.f, 0.f, h1[0]);
        if (pb < n)
          reinterpret_cast<float4*>(out)[pb] = make_float4(0.f, 0.f, 0.f, h1[2]);
      }
      continue;
    }
    // the colour net: hc = [bf16(SH), bf16(h1) with the σ column zeroed]
    uint32_t hc[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      hc[0][h] = pack_bf16(shr[h][0].x, shr[h][0].y);
      hc[0][2 + h] = pack_bf16(shr[h][1].x, shr[h][1].y);
    }
    h1_frag(hc[1], reinterpret_cast<const float(*)[4]>(h1));
    fence_regs(c);
    fence_regs(hc);
    wg_fence();
#pragma unroll
    for (int kc = 0; kc < 2; ++kc) head_mma<64>(c, hc[kc], w_wc0, kc, kc);
    wg_commit();
    wg_wait<0>();
    fence_regs(c);
    relu_to_a(a, c);
    layer64<64>(c, a, w_wc1);
    relu_to_a(a, c);
    float rgb[4] = {};
    layer64<8>(rgb, a, w_wc2);
    // rgb: lane tig 0 holds columns 0, 1 and tig 1 columns 2, 3 (3 is the
    // zero padding of wc2), which takes σ from its tig-0 neighbour
    const float sa = __shfl_sync(0xffffffffu, h1[0], l & ~3);
    const float sb2 = __shfl_sync(0xffffffffu, h1[2], l & ~3);
    if (tig < 2) {
      if (pa < n)
        reinterpret_cast<float2*>(out)[2 * pa + tig] =
            make_float2(rgb[0], tig ? sa : rgb[1]);
      if (pb < n)
        reinterpret_cast<float2*>(out)[2 * pb + tig] =
            make_float2(rgb[2], tig ? sb2 : rgb[3]);
    }
  }
}

// Shared memory of a block: the weights in B layout, and the lines when
// stage_lines
size_t fwd_smem(int r_max, int feat, bool sigma_only, bool stage_lines) {
  size_t b = (size_t)b_layout(feat, sigma_only).total * sizeof(bf16);
  if (stage_lines) b += (size_t)3 * r_max * line_stride(feat) * sizeof(bf16);
  return b;
}

// K1's (K2's when kSigmaOnly) launch setup at (card, R_max, F): the kernel
// (lines staged when they fit), its dynamic shared memory with the attribute
// set, and its blocks an SM
struct FwdSetup {
  int dev = -1, r_max = 0, feat = 0;
  const void* fn = nullptr;
  size_t smem = 0;
  int per_sm = 0;
};

// The setup for this shape, kept per host thread (16 shapes, the oldest
// replaced), so that a call after the first asks the runtime only for the
// current device before it launches. A kernel's shared-memory limit on a
// card is raised and never lowered (under one lock), so that a setup kept
// for a larger shape still launches after a smaller one.
template <bool kSigmaOnly>
cudaError_t setup(int r_max, int feat, FwdSetup* out) {
  constexpr int kSlots = 16, kCards = 64;
  thread_local FwdSetup cache[kSlots];
  thread_local int next = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  for (const FwdSetup& c : cache)
    if (c.dev == dev && c.r_max == r_max && c.feat == feat) {
      *out = c;
      return cudaSuccess;
    }
  if (dev >= kCards) return cudaErrorInvalidDevice;
  static std::mutex mu;
  static int allowed[2][kCards];      // [staged][card]: the limit set
  std::lock_guard<std::mutex> lock(mu);
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return err;
  FwdSetup s;
  s.dev = dev;
  s.r_max = r_max;
  s.feat = feat;
  const bool stage = fwd_smem(r_max, feat, kSigmaOnly, true) <= (size_t)optin;
  s.smem = fwd_smem(r_max, feat, kSigmaOnly, stage);
  s.fn = stage ? (const void*)field_fused_kernel<kSigmaOnly, true>
               : (const void*)field_fused_kernel<kSigmaOnly, false>;
  int& limit = allowed[stage][dev];
  if ((int)s.smem > limit) {
    err = cudaFuncSetAttribute(s.fn,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)s.smem);
    if (err != cudaSuccess) return err;
    limit = (int)s.smem;
  }
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&s.per_sm, s.fn,
                                                      kFwdBlock, s.smem);
  if (err != cudaSuccess) return err;
  cache[next] = s;
  next = (next + 1) % kSlots;
  *out = s;
  return cudaSuccess;
}

template <bool kSigmaOnly>
int launch(const float* x, const float* sh, const bf16* lines,
           const bf16* wpack, float* out, int n, int r_max, int feat,
           cudaStream_t stream) {
  FwdSetup s;
  cudaError_t err = setup<kSigmaOnly>(r_max, feat, &s);
  if (err != cudaSuccess) return (int)err;
  // persistent blocks: exactly as many as are resident at once, so each
  // stages the weights (and lines) once
  const int blocks = (n + kFwdTile * kFwdWG - 1) / (kFwdTile * kFwdWG);
  const int cap = sm_count() * (s.per_sm > 0 ? s.per_sm : 1);
  const int grid = blocks < cap ? blocks : cap;
  void* args[] = {&x, &sh, &lines, &wpack, &out, &n, &r_max, &feat};
  err = cudaLaunchKernel(s.fn, dim3(grid), dim3(kFwdBlock), args, s.smem,
                         stream);
  if (err != cudaSuccess) return (int)err;
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
// an SM of K1 (K2 when sigma_only) at this shape, its warpgroups a block
// and points a warpgroup step → info[6]; 0 = success.
extern "C" int gbnerf_field_fused_info(int r_max, int feat, int sigma_only,
                                       int* info) {
  FwdSetup s;
  cudaError_t err = sigma_only ? setup<true>(r_max, feat, &s)
                               : setup<false>(r_max, feat, &s);
  cudaFuncAttributes attr = {};
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, s.fn);
  info[0] = attr.numRegs;
  info[1] = (int)attr.localSizeBytes;
  info[2] = (int)s.smem;
  info[3] = s.per_sm;
  info[4] = kFwdWG;
  info[5] = kFwdTile;
  return (int)err;
}
