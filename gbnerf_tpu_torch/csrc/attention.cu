// Self-attention forward for Hopper (sm_90a): softmax(q·kᵀ) v per (batch·head).
//
// Replaces the TPU kernel gbnerf_tpu/ops/attention.py::_kernel (K7). The
// TPU keeps one head's whole K/V in VMEM (4096 × 512 bf16 = 4 MB at the VAE's
// mid block) and takes an exact softmax over each full score row. A block
// here has at most 227 KB of shared memory, so this is a flash-style forward:
// a block owns a tile of query rows, walks the keys in tiles staged in
// shared memory, keeps a running row max and sum in f32 and rescales its
// output accumulator per tile.
//
// What it computes, as the TPU kernel: q·scale rounded to bf16 (formed here
// as q is loaded: the product of a bf16 q and the bf16 scale is exact in f32
// and rounded once, as `q * bf16(scale)`; an f32 q is multiplied in f32 and
// rounded, as `(q * scale).to(bf16)`), k and v in bf16, scores and softmax
// in f32, p rounded to bf16 once, p·v summed in f32, the output in q's
// dtype (bf16 or f32), one rounding from the f32 accumulator. It rounds the
// unnormalised p of an online softmax where the TPU rounds the normalised
// p: both round each p once, so they agree to bf16 level relative to
// max|out|, not bit for bit. The softmax is taken in base 2: p = ex2(s·log2e
// − m·log2e), one FMA and one ex2 a score.
//
// Two designs, by head dim (a plan, not a fallback):
//
// D ≤ 128 (the UNet's 40 and 80, the tiny prior's 16 and 32): attn_fwd_wg.
// Its bound on the H100 (chip_smoke.py::attention_bound): the exps, one a
// score on the SFU at 16 a clock an SM (16 × 4096 × 40: 268 M exps, 0.064
// ms at 1.98 GHz), above the products (4·BH·N²·D FLOP at 989 TFLOP/s, 0.048
// ms at the padded depth below); at D 80 the products (0.0054 ms against
// 0.0040 for the exps at 16 × 1024 × 80). The design:
// 1. Warp specialisation: one producer warp keeps TMA loads in flight; NC
//    consumer warpgroups own 64 query rows each. setmaxnreg gives the
//    producer warpgroup 24 registers a thread and the consumers the rest:
//    240 with two, 160 with three, 112 with four. NC is as many as the
//    consumers' registers allow (max_consumers()), or two where the larger
//    blocks would not leave fewer waves of blocks: each K/V tile serves
//    64·NC rows, so the K/V reloads from L2 fall as NC grows (16 × 4096 ×
//    40: 0.133 ms with three, 0.161 with two, by graph, NVIDIA H100 80GB
//    HBM3 at 700 W, tools/prof_attention_parts.py).
// 2. TMA with mbarriers: K and V tiles of BK keys (128; 64 up to D 16, for
//    the registers of four consumers) in a ring of NST stages (4 up to D 64,
//    2 above: shared memory), each with its own full and empty barrier for
//    K and for V, so that K is released as soon as its scores are taken and
//    V after p·v. Q is loaded once a block (bf16, or f32 through an f32
//    tensor map). The tensor maps are 3-D over [BH, N, D] (a 2-D map over
//    [BH·N, D] would let a ragged last tile read the next head's keys),
//    encoded on the host by cuTensorMapEncodeTiled, reached through
//    cudaGetDriverEntryPoint. K and V land in the 128-byte swizzle, in
//    blocks of 64 columns: TMA's out-of-bounds zero fill pads D up to the
//    block (and a ragged N's last tile, whose keys are masked to −∞).
// 3. wgmma for both products. S = q·kᵀ takes A from registers (q scaled
//    and rounded to bf16 once, from shared memory into the consumer's
//    fragments) and K as a K-major operand; it runs 16·⌈D/16⌉ deep (D 40:
//    48, 1.2× the products' depth; the columns past D are TMA's zeros).
//    O += p·v takes p straight from S's accumulator, packed into bf16 A
//    fragments in registers, and V in its natural [key][d] layout as an
//    MN-major operand (the transpose bit): no transposing stores; its N is
//    D itself.
// 4. Overlap. Within a warpgroup, tile j + 1's q·kᵀ is issued before tile
//    j's p·v, and tile j + 1's softmax runs while p·v is on the tensor
//    cores (wgmma is asynchronous, which mma.sync was not); the rescale of
//    O runs while q·kᵀ does. The loop has no branch around the products
//    (the last tile's p·v is peeled): ptxas serialises every wgmma
//    otherwise. Across the warpgroups, named barriers take turns at
//    issuing products, in group order, so that one group's softmax runs
//    while another's products do. Only the last tile's step carries the
//    ragged-key mask (a predicated select a score in every step before).
// 5. The keys may be split across blocks (grid.y) where the query tiles
//    alone give fewer than half the SMs a block: each block writes its
//    unnormalised O, row max and row sum, and attn_merge combines them by
//    log-sum-exp. At the main-path shapes no split pays (prof_attention).
// What holds it now (tools/prof_attention_parts.py, the kernel with one
// part taken out, NVIDIA H100 80GB HBM3 at 700 W; PERF.md): at 16 × 4096 × 40 the
// softmax and its loop, 0.117 of 0.133 ms with neither loads nor
// products; the exps alone 0.012. Timed against this kernel by the same
// tool and not taken: 64-key tiles above D 16 (13 % slower at 16 × 4096 ×
// 40, 10 % at 64 × 1024 × 80: twice the turns and barriers a key), a
// 6-stage ring up to D 64 (within ± 1.5 %: the loads do not hold it); by
// prof_attention, key splits (slower at every main-path shape). K/V
// shared by a 2-block cluster through TMA multicast was tried only on an
// earlier version of this kernel (no timing kept) and not on this one.
// mbar_wait has no time-out trap: a path that can trap keeps ptxas from
// giving the code after setmaxnreg.inc its budget (it spilled at 168).
//
// D > 128 (the VAE's 512): attn_fwd_wide, the mma.sync design of the
// previous version, unchanged: a warp cannot hold a 16 × 512 f32
// accumulator, so two warps share each 16-row group (WN = 2): each computes
// the scores of half of a 32-key tile, the pair exchanges row maxima and
// bf16 p through shared memory, and each applies the whole p to its half of
// the output columns. K/V arrive in a two-stage cp.async ring, fragments by
// ldmatrix (ldmatrix.trans for V). The keys are split in two across blocks
// where the query tiles alone give no SM a second block. It beats SDPA at
// the VAE's shape (PERF.md).
//
// Inputs: q [BH, N, D] bf16 or f32, k and v [BH, N, D] bf16, contiguous and
// 16-byte aligned; D a multiple of 8, 8 ≤ D ≤ 512.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <atomic>

#include "mma_common.cuh"
#include "wgmma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kSmallD = 128;   // the wgmma design up to here
constexpr int kStages = 2;     // the wide design's cp.async stages

// Keys a tile at head dim d.
constexpr int key_tile(int d) { return d <= 16 ? 64 : d <= kSmallD ? 128 : 32; }

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

// ===========================================================================
// D ≤ 128: TMA, wgmma, a producer warp and NC consumer warpgroups
// ===========================================================================

constexpr int kProducerRegs = 24;
constexpr int kTurnBar = 1;             // named barriers 1 … NC: the turns

// The most consumer warpgroups (64 query rows each) a block can have at
// head dim d, as many as the registers that their count leaves them allow:
// four up to D 16 (112 registers a thread, with 64-key tiles), three up to
// D 48 (160), two above (240). Each K/V tile then serves 64·NC rows. Up to
// D 48 the kernel is also built with two, which the plan takes where the
// larger blocks would not leave fewer waves of blocks (a short grid).
constexpr int max_consumers(int d) { return d <= 16 ? 4 : d <= 48 ? 3 : 2; }

template <int D8, int NC_>
struct WgCfg {
  static constexpr int D = 8 * D8;
  static constexpr int NC = NC_;
  static constexpr int ROWS = 64 * NC;           // query rows a block
  static constexpr int THREADS = 128 * (NC + 1); // + the producer group
  // setmaxnreg's budgets: the producer group's 24 a thread go to the
  // consumers (65,536 registers an SM, one block)
  static constexpr int CONSUMER_REGS =
      ((65536 / THREADS) / 8 * 8 * THREADS - 128 * kProducerRegs) / (128 * NC)
      / 8 * 8;
  static_assert(CONSUMER_REGS == (NC == 2 ? 240 : NC == 3 ? 160 : 112),
                "register budgets");
  static constexpr int BK = key_tile(D);         // keys a tile
  static constexpr int NST = D <= 64 ? 4 : 2;    // ring stages of K and V
  static constexpr int K16 = (D + 15) / 16;      // q·kᵀ k-steps (16 deep)
  static constexpr int DC = (D + 63) / 64;       // 64-column blocks a row
  static constexpr int TILE = BK * 128 * DC;     // bytes of a K or V tile
  static constexpr int NS = BK / 2;              // S accumulator, a thread
  static constexpr int NO = D / 2;               // O accumulator, a thread
  static constexpr int KP = BK / 16;             // p·v k-steps
  static_assert(BK % 64 == 0 && BK <= 256, "wgmma n and TMA box");

  static size_t smem_bytes(int q_f32) {
    return 1024 + (size_t)2 * NST * TILE +
           (size_t)ROWS * D * (q_f32 ? 4 : 2) + 8 * (4 * NST + 1);
  }
};

// q·kᵀ's B for k-step kk of the K tile at shared address `tile`: rows of 64
// columns, 128 bytes, 8-row groups 1024 bytes apart; k-steps advance 32
// bytes within a row, and the second 64-column block follows the first.
template <int BK>
__device__ __forceinline__ uint64_t k_desc(uint32_t tile, int kk) {
  return sw128_desc(tile + (kk / 4) * BK * 128 + (kk % 4) * 32, 16, 1024);
}

// p·v's B for k-step kk (16 keys) of the V tile, MN-major: 64-column
// blocks BK·128 bytes apart, 8-key groups 1024 bytes apart.
template <int BK>
__device__ __forceinline__ uint64_t v_desc(uint32_t tile, int kk) {
  return sw128_desc(tile + kk * 16 * 128, BK * 128, 1024);
}

// q: [bh, n, D] (bf16, or f32 when q_f32), k, v: [bh, n, D] bf16, through
// the tensor maps; out [bh, n, D] in q's dtype. grid (⌈n / 128⌉, split,
// bh). With split > 1 each block covers a range of key tiles and writes
// its unnormalised O to part [split, bh, n, D] f32 and (row max, row sum)
// to ml [split, bh, n, 2].
template <int D8, int NC_>
__global__ void __launch_bounds__(WgCfg<D8, NC_>::THREADS, 1)
attn_fwd_wg(const __grid_constant__ CUtensorMap qmap,
            const __grid_constant__ CUtensorMap kmap,
            const __grid_constant__ CUtensorMap vmap, void* __restrict__ outv,
            float* __restrict__ part, float* __restrict__ ml, int n,
            int q_f32, float qscale) {
  using C = WgCfg<D8, NC_>;
  constexpr int D = C::D, BK = C::BK, NST = C::NST, NC = C::NC;
  extern __shared__ __align__(16) unsigned char smem_wg[];
  // 1024-byte aligned, as the 128-byte swizzle's pattern is
  unsigned char* smem = smem_wg + ((1024 - (smem_addr(smem_wg) & 1023)) & 1023);
  unsigned char* kbuf = smem;
  unsigned char* vbuf = smem + NST * C::TILE;
  unsigned char* qbuf = smem + 2 * NST * C::TILE;
  uint64_t* full_k = reinterpret_cast<uint64_t*>(
      qbuf + (size_t)C::ROWS * D * (q_f32 ? 4 : 2));
  uint64_t* full_v = full_k + NST;
  uint64_t* empty_k = full_k + 2 * NST;
  uint64_t* empty_v = full_k + 3 * NST;
  uint64_t* full_q = full_k + 4 * NST;

  // the warpgroup, broadcast from lane 0 so that the compiler sees it
  // uniform across the warp (setmaxnreg's register budgets need that)
  const int tid = threadIdx.x;
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int q0 = blockIdx.x * C::ROWS, bh = blockIdx.z;
  // this block's key tiles
  const int nkt = (n + BK - 1) / BK;
  const int per = (nkt + gridDim.y - 1) / gridDim.y;
  const int kt0 = blockIdx.y * per;
  const int ntiles = min(nkt, kt0 + per) - kt0;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < NST; ++s) {
      mbar_init(&full_k[s], 1);
      mbar_init(&full_v[s], 1);
      mbar_init(&empty_k[s], 4 * NC);   // one arrival per consumer warp
      mbar_init(&empty_v[s], 4 * NC);
    }
    mbar_init(full_q, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {                    // the producer
    regs_dec<kProducerRegs>();
    if (tid == 0) {
      mbar_expect_tx(full_q, C::ROWS * D * (q_f32 ? 4 : 2));
      tma_load_3d(qbuf, &qmap, full_q, 0, q0, bh);
      for (int j = 0; j < ntiles; ++j) {
        const int s = j % NST, use = j / NST, key0 = (kt0 + j) * BK;
        if (use > 0) mbar_wait(&empty_k[s], (use - 1) & 1);
        mbar_expect_tx(&full_k[s], C::TILE);
#pragma unroll
        for (int c = 0; c < C::DC; ++c)
          tma_load_3d(kbuf + s * C::TILE + c * BK * 128, &kmap, &full_k[s],
                      64 * c, key0, bh);
        if (use > 0) mbar_wait(&empty_v[s], (use - 1) & 1);
        mbar_expect_tx(&full_v[s], C::TILE);
#pragma unroll
        for (int c = 0; c < C::DC; ++c)
          tma_load_3d(vbuf + s * C::TILE + c * BK * 128, &vmap, &full_v[s],
                      64 * c, key0, bh);
      }
    }
    return;
  }

  // a consumer: 64 rows, warp w of the group rows 16w + lane/4 and + 8
  regs_inc<C::CONSUMER_REGS>();
  const int cg = wg - 1;
  const int warp = (tid / 32) % 4, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int bar_mine = kTurnBar + cg, bar_next = kTurnBar + (cg + 1) % NC;
  const uint32_t kaddr = smem_addr(kbuf), vaddr = smem_addr(vbuf);

  // Q fragments: bf16(q · qscale), zero past D
  uint32_t qf[C::K16][4];
  mbar_wait(full_q, 0);
  {
    const int r0 = 64 * cg + 16 * warp + g;   // of the block's Q tile
#pragma unroll
    for (int kk = 0; kk < C::K16; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = r0 + 8 * (e & 1), col = 16 * kk + 8 * (e >> 1) + 2 * t;
        float x = 0.f, y = 0.f;
        if (col < D) {              // D % 8 == 0: col + 1 < D too
          if (q_f32) {
            const float2 f = *reinterpret_cast<const float2*>(
                reinterpret_cast<const float*>(qbuf) + r * D + col);
            x = f.x;
            y = f.y;
          } else {
            const float2 f = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(
                    reinterpret_cast<const bf16*>(qbuf) + r * D + col));
            x = f.x;
            y = f.y;
          }
        }
        qf[kk][e] = col < D ? pack_bf16(x * qscale, y * qscale) : 0u;
      }
  }

  float sacc[C::NS];                // scores, then p (f32) in place
  float o[C::NO];
#pragma unroll
  for (int i = 0; i < C::NS; ++i) sacc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < C::NO; ++i) o[i] = 0.f;
  uint32_t pf[C::KP][4];            // bf16(p) as p·v's A fragments
  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F;   // rows g and g + 8
  float l0 = 0.f, l1 = 0.f;         // this thread's partial row sums
  float corr0 = 0.f, corr1 = 0.f;   // the last softmax's rescale of O

  auto issue_scores = [&](int j) {  // sacc = q · K_jᵀ (asynchronous)
    const uint32_t tile = kaddr + (j % NST) * C::TILE;
    fence_regs(sacc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < C::K16; ++kk)
      wgmma_rs<BK, 0>(sacc, qf[kk], k_desc<BK>(tile, kk), kk > 0 ? 1 : 0);
    wg_commit();
  };

  // the online softmax of tile j's scores: the new row maxima, O's
  // rescale, p = 2^(s·log2e − m·log2e) in place, the row sums. The maxima
  // and sums in four independent chains a row (fewer dependent steps).
  auto softmax_tile = [&]() {
    float a0[4] = {m0, m0, m0, m0}, a1[4] = {m1, m1, m1, m1};
#pragma unroll
    for (int i = 0; i < C::NS / 4; ++i) {
      a0[i % 4] = fmaxf(a0[i % 4], fmaxf(sacc[4 * i], sacc[4 * i + 1]));
      a1[i % 4] = fmaxf(a1[i % 4], fmaxf(sacc[4 * i + 2], sacc[4 * i + 3]));
    }
    float mx0 = fmaxf(fmaxf(a0[0], a0[1]), fmaxf(a0[2], a0[3]));
    float mx1 = fmaxf(fmaxf(a1[0], a1[1]), fmaxf(a1[2], a1[3]));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    // the range's first tile holds a valid key, so mx is finite from here
    const float ml0 = mx0 * kLog2e, ml1 = mx1 * kLog2e;
    corr0 = ex2(fmaf(m0, kLog2e, -ml0));
    corr1 = ex2(fmaf(m1, kLog2e, -ml1));
    m0 = mx0;
    m1 = mx1;
    float r0[4] = {0.f, 0.f, 0.f, 0.f}, r1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int i = 0; i < C::NS / 4; ++i) {
      sacc[4 * i] = ex2(fmaf(sacc[4 * i], kLog2e, -ml0));
      sacc[4 * i + 1] = ex2(fmaf(sacc[4 * i + 1], kLog2e, -ml0));
      sacc[4 * i + 2] = ex2(fmaf(sacc[4 * i + 2], kLog2e, -ml1));
      sacc[4 * i + 3] = ex2(fmaf(sacc[4 * i + 3], kLog2e, -ml1));
      r0[i % 4] += sacc[4 * i] + sacc[4 * i + 1];
      r1[i % 4] += sacc[4 * i + 2] + sacc[4 * i + 3];
    }
    l0 = l0 * corr0 + ((r0[0] + r0[1]) + (r0[2] + r0[3]));
    l1 = l1 * corr1 + ((r1[0] + r1[1]) + (r1[2] + r1[3]));
  };

  // the same with tile j's keys past n (a ragged last tile's) masked to −∞
  // first; only the last tile can be ragged, and only its copy of the loop
  // step carries the mask
  auto softmax_masked = [&](int j) {
    const int key0 = (kt0 + j) * BK;
    if (key0 + BK > n) {
#pragma unroll
      for (int i = 0; i < C::NS; ++i)
        if (key0 + 8 * (i / 4) + 2 * t + (i & 1) >= n) sacc[i] = -CUDART_INF_F;
    }
    softmax_tile();
  };

  // two key octets of p form one A fragment of a 16-key step
  auto pack_p = [&]() {
#pragma unroll
    for (int kk = 0; kk < C::KP; ++kk) {
      pf[kk][0] = pack_bf16(sacc[8 * kk], sacc[8 * kk + 1]);
      pf[kk][1] = pack_bf16(sacc[8 * kk + 2], sacc[8 * kk + 3]);
      pf[kk][2] = pack_bf16(sacc[8 * kk + 4], sacc[8 * kk + 5]);
      pf[kk][3] = pack_bf16(sacc[8 * kk + 6], sacc[8 * kk + 7]);
    }
  };

  auto release = [&](uint64_t* empty) {   // this warp is done with a stage
    if (lane == 0) mbar_arrive(empty);
  };

  auto rescale_o = [&]() {          // O by the last softmax's correction
#pragma unroll
    for (int i = 0; i < C::NO / 4; ++i) {
      o[4 * i] *= corr0;
      o[4 * i + 1] *= corr0;
      o[4 * i + 2] *= corr1;
      o[4 * i + 3] *= corr1;
    }
  };

  auto issue_pv = [&](int j) {      // o += bf16(p) · V_j (asynchronous)
    const uint32_t tile = vaddr + (j % NST) * C::TILE;
    mbar_wait(&full_v[j % NST], (j / NST) & 1);
    fence_regs(o);
    fence_regs(pf);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < C::KP; ++kk)
      wgmma_rs<D, 1>(o, pf[kk], v_desc<BK>(tile, kk), 1);
    wg_commit();
  };

  // Turns, in group order: a group issues its products only between
  // bar_sync(bar_mine) and bar_arrive(bar_next); the last group's first
  // arrival gives group 0 the first turn. Each group takes ntiles + 1
  // turns; the last group gives none after its last.
  if (cg == NC - 1) bar_arrive(kTurnBar, 256);
  mbar_wait(&full_k[0], 0);
  bar_sync(bar_mine, 256);
  issue_scores(0);
  bar_arrive(bar_next, 256);
  wg_wait<0>();
  fence_regs(sacc);
  release(&empty_k[0]);
  softmax_masked(0);
  pack_p();

  // tile j + 1's scores and tile j's p·v issued in one turn, tile j + 1's
  // softmax while p·v runs
  auto step = [&](int j, auto next_softmax) {
    mbar_wait(&full_k[(j + 1) % NST], ((j + 1) / NST) & 1);
    bar_sync(bar_mine, 256);
    issue_scores(j + 1);
    rescale_o();                    // while q·kᵀ runs
    issue_pv(j);
    bar_arrive(bar_next, 256);
    wg_wait<1>();                   // the scores are in
    fence_regs(sacc);
    release(&empty_k[(j + 1) % NST]);
    next_softmax(j + 1);
    wg_wait<0>();                   // p·v is done
    fence_regs(o);
    fence_regs(pf);
    release(&empty_v[j % NST]);
    pack_p();
  };
  for (int j = 0; j + 2 < ntiles; ++j)   // full tiles
    step(j, [&](int) { softmax_tile(); });
  if (ntiles >= 2) step(ntiles - 2, softmax_masked);
  {                                 // the last tile's p·v
    const int j = ntiles - 1;
    bar_sync(bar_mine, 256);
    rescale_o();
    issue_pv(j);
    if (cg != NC - 1) bar_arrive(bar_next, 256);
    wg_wait<0>();
    fence_regs(o);
    fence_regs(pf);
    release(&empty_v[j % NST]);
  }

  // the row sums over the 4 lanes of a row
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);

  const size_t base = (size_t)bh * n * D;
  const int row[2] = {q0 + 64 * cg + 16 * warp + g,
                      q0 + 64 * cg + 16 * warp + g + 8};
  if (gridDim.y == 1) {             // normalised, in q's dtype
    const float inv[2] = {1.f / l0, 1.f / l1};
#pragma unroll
    for (int i = 0; i < C::NO / 4; ++i) {
      const int col = 8 * i + 2 * t;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (row[r] >= n) continue;
        const size_t off = base + (size_t)row[r] * D + col;
        const float x = o[4 * i + 2 * r] * inv[r];
        const float y = o[4 * i + 2 * r + 1] * inv[r];
        if (q_f32)
          *reinterpret_cast<float2*>(static_cast<float*>(outv) + off) =
              make_float2(x, y);
        else
          *reinterpret_cast<uint32_t*>(static_cast<bf16*>(outv) + off) =
              pack_bf16(x, y);
      }
    }
  } else {                          // this split's unnormalised O, max, sum
    const size_t pbase = (size_t)blockIdx.y * gridDim.z * n * D + base;
#pragma unroll
    for (int i = 0; i < C::NO / 4; ++i) {
      const int col = 8 * i + 2 * t;
#pragma unroll
      for (int r = 0; r < 2; ++r)
        if (row[r] < n)
          *reinterpret_cast<float2*>(part + pbase + (size_t)row[r] * D + col) =
              make_float2(o[4 * i + 2 * r], o[4 * i + 2 * r + 1]);
    }
    if (t == 0) {
      const size_t mbase = ((size_t)blockIdx.y * gridDim.z + bh) * n;
      const float mm[2] = {m0, m1}, ll[2] = {l0, l1};
#pragma unroll
      for (int r = 0; r < 2; ++r)
        if (row[r] < n)
          *reinterpret_cast<float2*>(ml + 2 * (mbase + row[r])) =
              make_float2(mm[r], ll[r]);
    }
  }
}

// ===========================================================================
// D > 128: mma.sync, two warps a 16-row group
// ===========================================================================

// The kernel's shape parameters. DV8: output n-tiles of 8 columns (32/48/64,
// columns past D zero); each of a group's two warps has DV8·4 output
// columns and BK/2 keys of a tile; BK: keys a tile; NST: pipeline stages.
template <int DV8, int BK, int NST>
struct Cfg {
  static constexpr int WN = 2;                  // warps a 16-row group
  static constexpr int DV = DV8 * 8;            // output columns (padded)
  static constexpr int DQK = DV8 * 8;           // q·kᵀ depth
  static constexpr int K16 = DQK / 16;          // its 16-deep mma steps
  static constexpr int QS = row_stride(DQK);    // Q and K row stride
  static constexpr int VS = row_stride(DV);     // V row stride
  static constexpr int PS = row_stride(BK);     // p exchange row stride
  static constexpr int NV = DV8 / WN;           // a warp's output n-tiles
  static constexpr int BKW = BK / WN;           // a warp's keys of a tile
  static constexpr int NS = BKW / 8;            // a warp's score n-tiles
  static constexpr int STAGE = BK * (QS + VS);  // bf16 a stage (K then V)
  static_assert(NS % 2 == 0, "score n-tiles are loaded in pairs");
  static_assert(BK % 16 == 0, "p is exchanged in 16-key steps");
  static_assert(DQK % 16 == 0, "q·kᵀ runs in 16-deep steps");

  static size_t smem_bytes(int wm) {
    return ((size_t)16 * wm * QS + (size_t)NST * STAGE) * sizeof(bf16) +
           (size_t)16 * wm * PS * sizeof(bf16) + (size_t)16 * wm * WN * 4;
  }
};

// q, out: [bh, n, d] (bf16, or f32 when q_f32); k, v: [bh, n, d] bf16.
// grid (⌈n / (16·wm)⌉, split, bh), 64·wm threads. With split > 1 each
// block covers a range of key tiles and writes its unnormalised O to
// part [split, bh, n, d] f32 and (row max, row sum) to ml [split, bh, n, 2].
template <int DV8, int BK, int NST>
__global__ void __launch_bounds__(256, 1)
attn_fwd_wide(const void* __restrict__ qv, const bf16* __restrict__ k,
              const bf16* __restrict__ v, void* __restrict__ outv,
              float* __restrict__ part, float* __restrict__ ml, int n, int d,
              int q_f32, float qscale) {
  using C = Cfg<DV8, BK, NST>;
  constexpr int WN = C::WN;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int wm_count = blockDim.x / (32 * WN);
  const int bq = 16 * wm_count;
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* stages = qs + bq * C::QS;
  bf16* ps = stages + NST * C::STAGE;
  float* red = reinterpret_cast<float*>(ps + bq * C::PS);

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

  // this warp's Q rows (16·wm …), loaded per 16-deep step
  const bf16* qw = qs + (wm * 16 + (lane & 15)) * C::QS + (lane >> 4) * 8;

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
      ldm_x4(a, qw + kk * 16);
#pragma unroll
      for (int np = 0; np < C::NS / 2; ++np) {
        uint32_t b[4];
        ldm_x4(b, kw + np * 16 * C::QS + kk * 16);
        mma_bf16(s[2 * np], a, b[0], b[1]);
        mma_bf16(s[2 * np + 1], a, b[2], b[3]);
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
    // the maxima of the group's other warp
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
    // the group's p through shared memory
    bf16* pw = ps + (wm * 16 + g) * C::PS + wn * C::BKW + 2 * t;
#pragma unroll
    for (int i = 0; i < C::NS; ++i) {
      *reinterpret_cast<uint32_t*>(pw + i * 8) = pack_bf16(s[i][0], s[i][1]);
      *reinterpret_cast<uint32_t*>(pw + 8 * C::PS + i * 8) =
          pack_bf16(s[i][2], s[i][3]);
    }
    named_barrier(1 + wm, 32 * WN);
    const bf16* vw = vs + (lane & 15) * C::VS + wn * (C::NV * 8) + (lane >> 4) * 8;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[4];
      ldm_x4(a, ps + (wm * 16 + (lane & 15)) * C::PS + kk * 16 + (lane >> 4) * 8);
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
  __syncthreads();                  // every warp is done with red's maxima
  if (t == 0) {
    red[(wm * 16 + g) * WN + wn] = l[0];
    red[(wm * 16 + g + 8) * WN + wn] = l[1];
  }
  named_barrier(1 + wm, 32 * WN);
  l[0] = l[1] = 0.f;
#pragma unroll
  for (int w = 0; w < WN; ++w) {    // in warp order: the same in each warp
    l[0] += red[(wm * 16 + g) * WN + w];
    l[1] += red[(wm * 16 + g + 8) * WN + w];
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

int launch_merge(float* part, float* ml, void* out, int split, int bh, int n,
                 int d, int q_f32, cudaStream_t stream) {
  const size_t threads = (size_t)bh * n * (d / 8);
  attn_merge<<<(unsigned)((threads + 255) / 256), 256, 0, stream>>>(
      part, ml, out, split, bh, n, d, q_f32);
  return (int)cudaGetLastError();
}

// ---- host: the D ≤ 128 launch ----------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime has loaded (no -lcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a 3-D map over [bh, n, d] (d innermost) with boxes of box_d × box_n × 1
int make_map(CUtensorMap* map, const void* ptr, bool f32, int bh, int n,
             int d, int box_d, int box_n, bool swizzle) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t es = f32 ? 4 : 2;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)n, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {d * es, (cuuint64_t)n * d * es};
  const cuuint32_t box[3] = {(cuuint32_t)box_d, (cuuint32_t)box_n, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  const CUresult r = encode(
      map, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      3, const_cast<void*>(ptr), dims, strides, box, step,
      CU_TENSOR_MAP_INTERLEAVE_NONE,
      swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// make_map through a cache of the maps this thread encoded last, by all that
// a map encodes: the UNet calls K7 on the same few buffers and shapes step
// after step, and three encodes cost the host more than the launch.
struct MapKey {
  const void* ptr;
  int bh, n, d, box_d, box_n, flags;
  bool operator==(const MapKey& o) const {
    return ptr == o.ptr && bh == o.bh && n == o.n && d == o.d &&
           box_d == o.box_d && box_n == o.box_n && flags == o.flags;
  }
};

int cached_map(CUtensorMap* map, const void* ptr, bool f32, int bh, int n,
               int d, int box_d, int box_n, bool swizzle) {
  struct Slot {
    MapKey key;
    bool used;
    CUtensorMap map;
  };
  constexpr int kSlots = 256;
  thread_local Slot slots[kSlots] = {};
  const MapKey key{ptr, bh, n, d, box_d, box_n, (f32 ? 1 : 0) | (swizzle ? 2 : 0)};
  uint64_t h = (uint64_t)(uintptr_t)ptr >> 4;
  h = (h ^ (h >> 17)) * 0x9E3779B97F4A7C15ull;
  h ^= (uint64_t)(n * 31 + box_n) * 0xC2B2AE3D27D4EB4Full + key.flags;
  Slot& slot = slots[(h >> 32) % kSlots];
  if (slot.used && slot.key == key) {
    *map = slot.map;
    return 0;
  }
  const int err = make_map(map, ptr, f32, bh, n, d, box_d, box_n, swizzle);
  if (!err) {
    slot.key = key;
    slot.map = *map;
    slot.used = true;
  }
  return err;
}

// cudaFuncSetAttribute's dynamic shared memory for `kernel` on the current
// card, set only when a call needs more than it was set to there (the
// attribute is per function and card; a call costs the host microseconds).
// Tag names the kernel (its configuration type): the kernels of one design
// share a signature, so the record is kept per Tag, not per K.
template <typename Tag, typename K>
int allow_smem(K kernel, size_t smem) {
  constexpr int kCards = 64;
  static std::atomic<int> allowed[kCards];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < kCards && allowed[dev].load(std::memory_order_relaxed) >= (int)smem)
    return 0;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err == cudaSuccess && dev < kCards) {
    int cur = allowed[dev].load(std::memory_order_relaxed);
    while (cur < (int)smem &&
           !allowed[dev].compare_exchange_weak(cur, (int)smem)) {
    }
  }
  return (int)err;
}

template <int D8, int NC>
int launch_wg(const void* q, const void* k, const void* v, void* out,
              float* part, float* ml, int bh, int n, int q_f32, float qscale,
              int split, cudaStream_t stream) {
  using C = WgCfg<D8, NC>;
  if (split < 1 || key_ranges(n, C::BK, split) != split)
    return (int)cudaErrorInvalidValue;
  alignas(64) CUtensorMap qm, km, vm;
  int err = cached_map(&qm, q, q_f32 != 0, bh, n, C::D, C::D, C::ROWS, false);
  if (!err) err = cached_map(&km, k, false, bh, n, C::D, 64, C::BK, true);
  if (!err) err = cached_map(&vm, v, false, bh, n, C::D, 64, C::BK, true);
  const size_t smem = C::smem_bytes(q_f32);
  auto kernel = attn_fwd_wg<D8, NC>;
  if (!err) err = allow_smem<C>(kernel, smem);
  if (err) return err;
  const dim3 grid((n + C::ROWS - 1) / C::ROWS, split, bh);
  kernel<<<grid, C::THREADS, smem, stream>>>(qm, km, vm, out, part, ml, n,
                                             q_f32, qscale);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || split == 1) return (int)e;
  return launch_merge(part, ml, out, split, bh, n, C::D, q_f32, stream);
}

template <int DV8>
int launch_wide(const void* q, const bf16* k, const bf16* v, void* out,
                float* part, float* ml, int bh, int n, int d, int q_f32,
                float qscale, int wm, int split, cudaStream_t stream) {
  constexpr int BK = key_tile(512);
  using C = Cfg<DV8, BK, kStages>;
  if (wm < 1 || 32 * wm * C::WN > 256 || split < 1 ||
      key_ranges(n, BK, split) != split)
    return (int)cudaErrorInvalidValue;
  const size_t smem = C::smem_bytes(wm);
  auto kernel = attn_fwd_wide<DV8, BK, kStages>;
  const int set = allow_smem<C>(kernel, smem);
  if (set) return set;
  const dim3 grid((n + 16 * wm - 1) / (16 * wm), split, bh);
  kernel<<<grid, 32 * wm * C::WN, smem, stream>>>(q, k, v, out, part, ml, n,
                                                  d, q_f32, qscale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || split == 1) return (int)err;
  return launch_merge(part, ml, out, split, bh, n, d, q_f32, stream);
}

// the kernel's attributes at head dim d: registers, local (spill) bytes a
// thread, dynamic shared memory a block (with a bf16 q), blocks an SM,
// stages, keys a tile, threads a block, the depth its q·kᵀ runs at and the
// width of its p·v (the tensor cores' work, padded)
template <typename Tag, typename K>
int kernel_attrs(K kernel, size_t smem, int threads, int stages, int bk,
                 int qk_depth, int pv_width, int* info) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err == cudaSuccess) err = (cudaError_t)allow_smem<Tag>(kernel, smem);
  int per_sm = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, smem);
  info[0] = attr.numRegs;
  info[1] = (int)attr.localSizeBytes;
  info[2] = (int)smem;
  info[3] = per_sm;
  info[4] = stages;
  info[5] = bk;
  info[6] = threads;
  info[7] = qk_depth;
  info[8] = pv_width;
  return (int)err;
}

}  // namespace

#define GBNERF_ATTN_SMALL_CASES(X)                                          \
  X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(8) X(9) X(10) X(11) X(12) X(13)     \
  X(14) X(15) X(16)

// q [bh, n, d] bf16 (f32 when q_f32), k, v [bh, n, d] bf16, out [bh, n, d]
// in q's dtype; all contiguous, 16-byte aligned. qscale: the softmax scale
// rounded to q's dtype. wm and split as gbnerf_attention_plan gives them:
// wm 16-row groups a block (at D ≤ 128 4·NC: 8, two consumer warpgroups,
// or 4·max_consumers(d), 16 up to D 16 and 12 up to D 48; 1…4 above D 128,
// two warps a group); split key ranges across blocks, each holding
// a key tile. With split > 1, part [split, bh, n, d] f32 and ml [split, bh,
// n, 2] f32 are scratch. d % 8 == 0, 8 ≤ d ≤ 512, bh ≤ 65535. Returns the
// cudaError_t of the launches (0 = success).
extern "C" int gbnerf_attention_fwd(const void* q, const void* k,
                                    const void* v, void* out, void* part,
                                    void* ml, int bh, int n, int d, int q_f32,
                                    float qscale, int wm, int split,
                                    void* stream) {
  if (bh == 0 || n == 0) return 0;
  if (d % 8 || d < 8 || d > 512) return (int)cudaErrorInvalidValue;
  float* P = static_cast<float*>(part);
  float* M = static_cast<float*>(ml);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= kSmallD) {
    if (wm != 8 && wm != 4 * max_consumers(d))
      return (int)cudaErrorInvalidValue;
#define GBNERF_ATTN_WG(D8)                                                  \
  case D8:                                                                  \
    return wm == 8 ? launch_wg<D8, 2>(q, k, v, out, P, M, bh, n, q_f32,     \
                                      qscale, split, s)                     \
                   : launch_wg<D8, max_consumers(D8 * 8)>(                  \
                         q, k, v, out, P, M, bh, n, q_f32, qscale, split, s);
    switch (d / 8) { GBNERF_ATTN_SMALL_CASES(GBNERF_ATTN_WG) }
#undef GBNERF_ATTN_WG
  }
  const bf16* K = static_cast<const bf16*>(k);
  const bf16* V = static_cast<const bf16*>(v);
  if (d <= 256)
    return launch_wide<32>(q, K, V, out, P, M, bh, n, d, q_f32, qscale, wm,
                           split, s);
  if (d <= 384)
    return launch_wide<48>(q, K, V, out, P, M, bh, n, d, q_f32, qscale, wm,
                           split, s);
  return launch_wide<64>(q, K, V, out, P, M, bh, n, d, q_f32, qscale, wm,
                         split, s);
}

// K7's launch plan at [bh, n, d] on a card of sm_count SMs: plan[0] = wm,
// plan[1] = split, each taken as given where > 0 and chosen where 0.
// D ≤ 128: the consumer count (wm = 4·NC) whose blocks leave the fewest
// waves on the card, two on a tie; the keys split (in powers of two, at most 8)
// while the query tiles give fewer than half the SMs a block. D > 128: 64-row blocks (wm 4, two warps a
// group); the keys split in two where the query tiles alone give no SM a
// second block (the VAE's 64 tiles → 128 blocks). The split is then cut to
// its key ranges (key_ranges), so that every range holds a tile. Returns 0,
// or cudaErrorInvalidValue for a shape or wm the kernel does not take.
extern "C" int gbnerf_attention_plan(int bh, int n, int d, int sm_count,
                                     int* plan) {
  if (bh < 1 || n < 1 || d % 8 || d < 8 || d > 512)
    return (int)cudaErrorInvalidValue;
  const bool small = d <= kSmallD;
  int wm = plan[0], split = plan[1];
  if (wm <= 0 && small) {
    // the consumer count that leaves the fewest waves of blocks, the fewer
    // consumers on a tie (their blocks finish sooner)
    const int wide = max_consumers(d);
    const long waves_wide = ((n + 64 * wide - 1) / (64 * wide) * (long)bh +
                             sm_count - 1) / sm_count;
    const long waves_two = ((n + 127) / 128 * (long)bh + sm_count - 1) /
                           sm_count;
    wm = 4 * (waves_wide < waves_two ? wide : 2);
  }
  if (wm <= 0) wm = 4;
  if (split <= 0) {
    if (small) {
      const int blocks = (n + 16 * wm - 1) / (16 * wm) * bh;
      split = 1;
      while (split < 8 && 2 * blocks * split <= sm_count) split *= 2;
    } else {
      split = ((n + 63) / 64) * bh <= sm_count ? 2 : 1;
    }
  }
  if (small ? wm != 8 && wm != 4 * max_consumers(d) : 64 * wm > 256)
    return (int)cudaErrorInvalidValue;
  plan[0] = wm;
  plan[1] = key_ranges(n, key_tile(d), split);
  return 0;
}

// info[9] for the kernel that runs head dim d (see kernel_attrs) at wm (0:
// the largest blocks; 8, two consumer warpgroups, at D ≤ 128); 0 or a
// cudaError_t.
template <int D8, int NC>
int wg_attrs(int* info) {
  using C = WgCfg<D8, NC>;
  return kernel_attrs<C>(attn_fwd_wg<D8, NC>, C::smem_bytes(0), C::THREADS,
                         C::NST, C::BK, 16 * C::K16, C::D, info);
}

template <int DV8>
int wide_attrs(int* info) {
  constexpr int bk = key_tile(512);
  using C = Cfg<DV8, bk, kStages>;
  return kernel_attrs<C>(attn_fwd_wide<DV8, bk, kStages>, C::smem_bytes(4),
                         256, kStages, bk, C::DQK, C::DV, info);
}

extern "C" int gbnerf_attention_info(int d, int wm, int* info) {
  if (d % 8 || d < 8 || d > 512) return (int)cudaErrorInvalidValue;
  if (d <= kSmallD) {
    if (wm != 0 && wm != 8 && wm != 4 * max_consumers(d))
      return (int)cudaErrorInvalidValue;
#define GBNERF_ATTN_INFO(D8)                                                \
  case D8:                                                                  \
    return wm == 8 ? wg_attrs<D8, 2>(info)                                  \
                   : wg_attrs<D8, max_consumers(D8 * 8)>(info);
    switch (d / 8) { GBNERF_ATTN_SMALL_CASES(GBNERF_ATTN_INFO) }
#undef GBNERF_ATTN_INFO
  }
  if (d <= 256) return wide_attrs<32>(info);
  if (d <= 384) return wide_attrs<48>(info);
  return wide_attrs<64>(info);
}
