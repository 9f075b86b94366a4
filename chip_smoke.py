#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (gbnerf_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py                  # from the root of a checkout
    python3 chip_smoke.py --profile DIR    # also trace one render and one
                                           # step of each stage
                                           # (torch.profiler)

1. Requires CUDA (exits nonzero without it) and prints the card's name and
   power limit.
2. Builds the CUDA kernels from gbnerf_tpu_torch/csrc (ops/_build.py) and
   prints the field kernels' registers, spill bytes, shared memory a block
   and blocks an SM ("kernel info" lines, from the CUDA runtime), and the
   warpgroup products (HGMMA) in the SASS of each of K1/K2's four builds
   (cuobjdump; fails where a build has none, or cuobjdump is missing).
3. Holds each kernel against its plain PyTorch version on the card, at the
   shapes the main paths give it (and once at a ragged size), and times
   both with CUDA events: K1/K2 (field forward; also by CUDA graph along
   rays, and checked and timed by graph at a stage-1 step's shapes,
   beside PREV_MS, the mma.sync design's graph time), K3 (z-merge, and its
   gradient against the CPU's, ties included), K4/K5 (field backward,
   every cotangent; two calls on the same inputs must be bit-equal); and
   K1/K2/K4/K5 at other widths (F 16, 24 and the widest they take, 160).
4. Drives the eval render path at the full width of configs/spinnerf_scene.txt
   (CP fields 17…257 at rank 16, coarse and fine alike, 64 + 64 samples,
   lindisp, white background) with seeded random weights: 16384 rays for
   rays/s (the "render" line; not bench.py's workload, whose coarse field
   is smaller: that is the bench twin's, 21), and three full 189 × 252
   views through render_pose_path. It checks that every map is finite
   with acc in [0, 1], that every kernel of the path was launched by that
   run, and that the path agrees with the plain path (the same fields on
   the CPU) on a subset of rays.
5. Drives stage-1 training through train() at the same full width
   (first_stage, N_rand 1024 for each of the three ray streams, Adam at
   lrate 3e-3, raw_noise_std 1, perturb on) on an in-memory scene of
   SPIn-NeRF size: 60 views at 189 × 252 with masks, inpainted depths and
   COLMAP-style depth rays, rendered by the port's twin of
   tools/make_synthetic_scene.py. About 300 steps, one checkpoint save and
   restore, one eval render. It checks finite metrics, a falling
   img_loss, and that the steps launched K1, K3, K4 and K5 and the eval
   K2; it prints ms per step.
6. Holds one stage-1 step on the card against the same step on the CPU
   plain path: same weights, injected batch indices, 64 rays per stream;
   and runs one full-width stage-1 step twice from the same state and
   batch, which must leave bit-equal parameters and Adam moments.
7. Holds K7 (self-attention) against its plain version on the card, in
   bf16, at the three shapes of the stage-2 path (the UNet at 64² and 32²
   latents, the VAE mid block), at the LoRA, tiny-prior and colla shapes
   (the colla UNet at batch 8: 64 × 4096 × 40 and 64 × 1024 × 80), at a
   ragged N and with an f32 q; times both, beside SDPA and the previous
   design's time (PREV_MS: up to D 128 the mma.sync design that the
   TMA/wgmma one replaced); prints K7's registers, spills, shared memory
   a block, stages and keys a tile at every head dim ("kernel info
   attention"), and its bound from the SFU's exps, the products at the
   depth wgmma runs and the bytes.
8. Drives stage 2 through train() (first_stage = False), warm-started
   (ft_path) from the stage-1 run's last checkpoint on the same scene: the
   full-width SD1.5-inpainting UNet, VAE and CLIP text tower at 512² / 64²
   latents in bf16 with seeded random weights (sd_allow_random), 2-way SDS
   at the shipped scales (RGB 7.5, normal 1.5), sds_loss_weight 1e-4, the
   masked-latents cache, the normal map at normalmap_render_factor 7, and
   normal_start_iter 0 so both modalities run from the first step. About
   50 steps, timed as stage 1 is, plus the SD build and the cache. It
   checks finite metrics, a nonzero sds_loss, that the steps launched K1,
   K3, K4 and K7 (K7 from the UNet and from the VAE), and that the SDS term
   alone gives the fine field's lines a nonzero, finite gradient.
9. Holds one stage-2 step on the card against the same step on the CPU
   plain path, at the tiny SD widths (f32) but sd_latent_size 512, so that
   attention sees N = 4096 and 1024 and K7 runs on the card: the same
   fields and SD weights, injected view, stream indices and draws; with
   RGB + normal, RGB alone, RGB + colla (the four neighbour views
   injected) and Perp-Neg (its orbit uniforms injected).
10. Holds K6 (the standalone CP encode) against its plain version on the
   card, bit for bit: at the profile's 2,097,152 points (R_max 257, F
   80), at the proposal field's R_max 65, F 24, and at a ragged N, each
   with points on 0, 1 and the grid nodes; and the gradient of
   cp_encode_unified on the card against the CPU plain path's.
11. Drives the profiling entry points in-process, each with its own
   launch counts: prof_field's main at its full workload (16384 rays;
   encode_dense_kernel is K6's path), then prof_train and prof_guidance
   (the full-size SD stack in bf16) at a few reps.
12. Times a library call beside K3 (torch.sort of the [16384, 128] rows)
   and K7 (scaled_dot_product_attention), which the port never calls, and
   computes each kernel's bound on the H100 from its shapes. K1–K7
   and SDPA are also timed with the host out of the loop (graph_ms: the
   calls replayed from a CUDA graph).
13. The disk phase: writes the round-5 ablation scene (252 × 189, 16 + 3
   views, sparse COLMAP, seed 0) with the port's synthetic-scene twin and
   reads it back through load_scene with imageio and cv2 blocked (the
   PNG codec; the arrays must equal those written), then trains the
   ablation twin's s1 config for DISK_S1_STEPS steps and its nog config
   (the LPIPS patch loss with random VGG weights, no guidance) for
   DISK_NOG_STEPS more from s1's checkpoint, both through train() from
   the files; prints the decode time, ms per step, launches and the eval
   PSNRs, and checks that the eval PNGs decode to to8b of the maps.
   Then LPIPS on the card against the CPU (distance and input gradient on
   4 × 32 × 32 patches). With --profile, one nog step is traced too.
14. The guided arms on the disk scene: a tiny prior from the tiny-prior
   CLI (a few steps at latent 256), the scene LoRA from the LoRA CLI on
   it, then the ablation twin's priorNL-sds config through train() from
   s1's checkpoint (the prior loaded, the adapters merged, RGB and
   normal-map SDS with the LPIPS patch loss); ms per step, K7 launched at
   the tiny stack's shapes. With --profile, one priorNL-sds step is traced.
15. The LoRA phase: LoRA training of the full-size SD1.5-inpainting UNet
   (bf16, random weights) at the reference's shape (rank/α 32, batch 4,
   512², AdamW lr 1e-4) on the disk scene's images and label masks:
   warm-up and timed steps, peak memory, the adapter count (13,565,952
   on 192 kernels), K7's re-linearised backward's share of a step; a
   full-size DDIM inpaint (ms a step); the merged UNet against the
   functional path; one tiny LoRA step on the card against the CPU; a
   prior written and read back through utils/msgpack.py. With --profile,
   one LoRA step is traced.
16. Stage 2 from the stage-1 checkpoint as in 8, with collaborative
   guidance (four random views rendered at 27 × 36 with gradient each
   step, the UNet at batch 8) and then with Perp-Neg (the UNet at batch 4
   on direction-blended prompts), COLLA_STEPS and PERPNEG_STEPS steps:
   ms per step and peak memory, K1, K3, K4 and K7 launched. Then stage 1
   for FROZEN_STEPS steps with alpha_model_path at the stage-1
   checkpoints: σ from that run's fine field (K2) bit-equal to the alpha
   field's own call along 1024 rays, the σ column of each field's ws1
   bit-equal before and after while the rest trained; ms per step.
17. CLIP guidance at the ViT-B/16 size: its loss and image gradient on
   the card against the CPU.
18. The Blender phase: a scene in nerf_synthetic's layout (100 train views
   at 800² with mask/ companions, 8 val and 16 test views; the twin's
   sphere, alpha = its silhouette) written with the PNG codec, then with
   imageio, cv2 and matplotlib blocked: load_scene with half_res (400²)
   and testskip 8; stage 1 through train() with the shipped field at full
   width on the white background (σ term on depth rays to the analytic
   sphere), the held-out PSNR before and after (it must rise);
   render_only with render_test_ray (test PNGs, test_ray.npz, sigma.png,
   the maps and a 40-frame spiral GIF, read back by the port's readers);
   the export_mesh CLI at 256³ with colours (a non-empty PLY, read back;
   the vertices' distance from the analytic sphere). Then K1 at
   render_test_ray's 64 points, K2 on a 524,288-point mesh slab and
   field_normals (K2, K5 with dx) at 65,536 mesh vertices against their
   plain versions (off the ties of the CP interpolation; at a tie the
   kernel's partial must be the JAX kernel's 0).
19. The hash phase: configs/spinnerf_scene.txt with field_type = hash at
   its full width (16 levels, 2^19 × 2 table, base 16, bound 100, f32) on
   the scene of 5: stage 1 through train() as in 5 (K3 launched, no CP
   kernel; ms per step, the held-out PSNR), one step on the card against
   the CPU in f32 and in float64 (loss to 1e-3, every gradient, the
   table's too, to cosine 0.999), one full-width step twice from one
   state (bit-equal: the gather's backward sums in sorted order), the
   render phase's 16384 rays (rays/s), HASH_STAGE2_STEPS stage-2 steps
   from its checkpoint with the full-size SD stack of 8 (K3 and K7 launched, sds_loss nonzero); and
   the native host library (data/native.py, built from native/csrc into
   build/) available, its searchsorted equal to numpy's.
20. The parallel phase, torchrun on the card (tools/parallel_check.py's
   cases; the ranks count their own launches and rank 0 sums them into
   the kernels line): (a) one NCCL rank through run.py, NCCL_STEPS
   stage-1 steps of configs/spinnerf_scene.txt at full width on the disk
   scene (ms a step, the group's backend and world size); (b) two gloo
   ranks sharing the card: the data-parallel full-width stage-1 step, 512
   rays a stream a rank, against the one-process step on the same
   injected draws (loss 1e-3, every gradient's cosine 0.999), the
   two-rank step twice (bit-equal), then PAR_STEPS timed steps (two
   processes on one card: contention, not scaling); (c) two gloo ranks,
   model = 2: the stage-2 step with the full-size SD stack tensor-parallel
   against the unsharded step (the same bounds), a rank's UNet bytes at
   most 0.6 of the whole; (d) tools/run_spmd_demo.py's twin at its micro
   size. Also, with the kernel checks, the CP field's x01 on the card
   against the CPU, bit for bit.
21. The bench twin, right after the render phase: bench.py's workload
   (its proposal-style coarse field (17, 33, 65) at rank 8, the Config()
   defaults, 64 + 64 samples) through gbnerf_tpu_torch/tools/bench.py's
   functions, in-process, at 16384 rays × 128 renders a loop, best of 3
   by CUDA events; its JSON line (bench.py's keys); K1, K2 and K3
   launched by one render; one render against the plain path of the same
   fields on the card (the kernels off) at the map tolerances.
22. The weights phase: the port's fake-checkpoint twin writes a
   full-width SD1.5-inpainting checkpoint (≈ 1.07 G f32 values, ≈ 4.3 GB)
   into a temporary directory, check_weights loads it in bf16 (strict
   keys, every parameter overwritten) and runs a 2-step DDIM inpaint at
   512² (K7 at the UNet's and the VAE's shapes); write, load and DDIM
   seconds; the directory is deleted.
23. The jax-draws phase (utils/jax_random.py, the twin of jax.random, and
   utils/jax_init.py, the JAX package's initial parameters), after 6: the
   twin on the card against the twin on the CPU in both threefry layouts
   (keys, bits, uniforms and randint bit-equal; normals, exponentials and
   truncated normals within JAX_ULP; bf16's 8-bit words and uniforms
   bit-equal, bf16 normals within 1 bf16 ulp) and against literal values
   that jax 0.9.0 gave on a CPU (JAX_GOLDEN: the same bounds, the bf16
   draws bit-equal); the full-width
   CP fields' init from PRNGKey(0) on the card against the CPU (JAX_ULP);
   one stage-1 loss and gradient of a JAX-draw run (jitter, the fine
   samples' sorted uniforms, the three streams' indices from one key; σ
   noise off, as in 6) on the card against the CPU plain path: from those
   fields at the bounds of 6, and from phase 5's trained fields with the
   card's plain path at the bounds of 6 and with the kernels at
   JAX_TRAINED_COS, beside the kernels against the card's plain path with
   the JAX package's draws and with torch's; a tiny LoRA step (the
   adapters' A and the step's draws from a JaxKey on each device; the
   LoRA bounds of 15) and stage 9's colla and Perp-Neg steps (their
   guidance draws from a JaxKey on each device; the bounds of 9), card
   against CPU; then ms a full-width stage-1 step and a full-width LoRA
   step (the SD1.5 stack in bf16, JAX_LORA_REPS steps a turn) with the
   JAX package's draws and with torch's, in turns (its own launch
   counts).

Every failure raises, so the script exits nonzero. The last line is
{"ok": true, "device": {...}}; the line before it names the card and its
power limit, and the one before that holds one JSON object with each
kernel's launches on the main paths, error, times and bound.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import itertools
import json
import math
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# Kernel checks: |kernel − plain| ≤ atol + rtol·|plain| elementwise with
# atol = ATOL_FRAC·max|plain| — the field's bf16 tolerance of the JAX
# package's own kernel tests (tests/test_field_bwd.py::_close): both sides
# round every matmul operand to bf16 and accumulate in f32, but sum in
# another order, which can flip one bf16 rounding of a hidden activation.
# The merge is a permutation and must be exact.
FIELD_RTOL, FIELD_ATOL_FRAC = 3e-2, 5e-3
# Slice vs the plain path (the same fields on the CPU), absolute, on maps
# of O(1) values: as tests/test_torch_render.py, for the same reason, and
# because the flip moves σ and, through the resampling, the fine samples.
MAP_ATOL = {"rgb": 5e-3, "acc": 5e-3, "depth": 2e-2, "disp": 2e-2}
ACC_SLACK = 1e-5        # Σ weights may pass 1 by f32 rounding

# the render phase: 16384 rays of the shipped config's fields (bench.py's
# ray count, near and far; not its fields: the bench twin's phase runs those)
BENCH_RAYS, NEAR, FAR = 16384, 1.2, 5.3
VIEW_H, VIEW_W, N_VIEWS = 189, 252, 3         # factor-4 SPIn-NeRF views
SUBSET_RAYS = 256
N_RAND = 1024                # rays per stream per stage-1 step
# stage 1 through train(): the scene, the steps, the cadences
TRAIN_VIEWS, TRAIN_STEPS, TRAIN_PRINT = 60, 300, 50
# the σ-likelihood term (DS-NeRF's; sigma_loss_weight is 0 in the shipped
# config) is on, so the σ-only field and its gradient (K2 forward, K5
# backward) are on the training path too
SIGMA_LOSS_WEIGHT = 0.1
# one step, card vs the CPU plain path: perturb and σ noise off (the two
# devices draw different numbers), bf16 rounding flips between the kernels
# and the plain ops move single samples: loss to 1e-3 relative, every
# parameter's gradient to cosine 0.999
STEP_RAYS, STEP_LOSS_RTOL, STEP_GRAD_COS = 64, 1e-3, 0.999
# K7 against its plain version, bf16: |kernel − plain| ≤ atol + rtol·|plain|
# with atol = ATTN_ATOL_FRAC·max|plain|. Both round q·scale, k, v and p to
# bf16 once and sum in f32, but the kernel rounds the unnormalised p of an
# online softmax where the plain version rounds the normalised p, so they
# differ by bf16 roundings (2^-8 = 3.9e-3 relative) of the output's terms.
ATTN_RTOL, ATTN_ATOL_FRAC = 1e-2, 1e-2
# (label, batch·heads, N, D): the stage-2 path's shapes, 2 CFG copies × 8
# heads in the UNet, one head in the VAE; and a ragged N
ATTN_SHAPES = (("unet 64x64", 16, 4096, 40), ("unet 32x32", 16, 1024, 80),
               ("vae mid", 1, 4096, 512), ("ragged", 3, 4000, 40),
               ("ragged vae", 1, 4000, 512),
               # the LoRA step at batch 4 (8 heads), its VAE encode; the
               # tiny prior's UNet top level and VAE mid block at latent
               # 256 (32² = 1024 tokens) in prior training at batch 16
               ("lora unet 64x64", 32, 4096, 40),
               ("lora unet 32x32", 32, 1024, 80), ("lora vae", 4, 4096, 512),
               ("prior unet", 32, 1024, 16), ("prior vae", 16, 1024, 32),
               # the colla UNet at batch 8 (4 views × 2 CFG copies); the
               # Perp-Neg UNet at batch 4 is the LoRA shape, 32 × 4096 × 40
               ("colla unet 64x64", 64, 4096, 40),
               ("colla unet 32x32", 64, 1024, 80))
# the shapes timed (the stage-2 path's first, the main-path shape)
ATTN_TIMED = ("unet 64x64", "unet 32x32", "vae mid", "lora unet 64x64",
              "lora unet 32x32", "lora vae", "prior unet", "prior vae",
              "colla unet 64x64", "colla unet 32x32")
# the same check with an f32 q (the kernel scales q as it loads it and
# writes q's dtype): the UNet's head dim, and the VAE's with a ragged N
ATTN_F32_SHAPES = (("f32 q", 4, 4096, 40), ("f32 q vae", 1, 4000, 512))
# and with an f16 q (scaled in f16 by the wrapper, passed as f32)
ATTN_F16_SHAPES = (("f16 q", 4, 4096, 40),)
# K7 at every head dim it takes up to 264, and at 384 and 512: each of its
# compiled variants (the wgmma design up to D 128, with two consumer
# warpgroups and, up to D 48, with the most the head dim takes; q·kᵀ
# padded to 16·⌈D/16⌉ at odd D/8; two warps a 16-row group above), a ragged
# N, q in bf16, f32 and f16, the keys unsplit and split in two
ATTN_SWEEP_BH, ATTN_SWEEP_N = 2, 333
ATTN_SWEEP_D = tuple(range(8, 265, 8)) + (384, 512)
# the head dims of K7's "kernel info" lines: each compiled variant (up to
# D 48 both block shapes)
ATTN_INFO_D = tuple(range(8, 129, 8)) + (256, 384, 512)
# The previous designs' times at the main-path shapes (this script, NVIDIA
# H100 80GB HBM3, 700.00 W), printed beside this run's: K7 by CUDA-graph
# replay (device time), the mma.sync design of D ≤ 128 that the TMA/wgmma
# one replaced (D 512 is the same code), from PERF.md's K7 row; K4/K5 by
# graph too, the design whose block partials went through the scratch
# buffer every tile (PERF.md's K4/K5 rows, uniform points); K1/K2 by graph
# too, their mma.sync design that the warpgroup one replaced (PERF.md's
# K1/K2 rows, through the wrapper, uniform points).
PREV_MS = {("attention", "unet 64x64"): 0.1971,
           ("attention", "unet 32x32"): 0.0270,
           ("attention", "vae mid"): 0.217,
           ("attention", "lora unet 64x64"): 0.3904,
           ("attention", "lora unet 32x32"): 0.0522,
           ("attention", "lora vae"): 0.8164,
           ("attention", "prior unet"): 0.0184,
           ("attention", "prior vae"): 0.0175,
           ("attention", "colla unet 64x64"): 0.7719,
           ("attention", "colla unet 32x32"): 0.1063,
           ("field_fused", "fine"): 0.3694,
           ("field_fused_sigma", "coarse"): 0.1478,
           ("field_fused_bwd", "fine"): 0.561,
           ("field_fused_bwd_sigma", "coarse"): 0.223}
# stage 2 through train(): the steps after the stage-1 checkpoint; then
# the same with collaborative guidance (four 27 × 36 neighbour views a
# step) and with Perp-Neg, each for a group of warm-up steps and four
# timed groups
STAGE2_STEPS, STAGE2_PRINT = 50, 10
COLLA_STEPS, PERPNEG_STEPS, VARIANT_PRINT = 25, 25, 5
# stage 1 with alpha_model_path at the stage-1 phase's checkpoints: the
# steps, and the rays × N_samples points whose σ is held bit-equal to the
# alpha field's
FROZEN_STEPS, FROZEN_PRINT, FROZEN_SIGMA_RAYS = 50, 10, 1024
# CLIP guidance at the ViT-B/16 size, card vs CPU in f32 (TF32 off): the
# same formulas summed in another order over 12 layers: the loss to 1e-4
# relative, the image gradient to 1e-3·max|cpu|
CLIP_LOSS_RTOL, CLIP_GRAD_ATOL_FRAC = 1e-4, 1e-3
# one stage-2 step, card vs the CPU plain path, tiny SD widths at 512²,
# with both modalities, with RGB only, with RGB + colla and with Perp-Neg
# (RGB, without the normal term: at 0.999 as RGB only). The card's bf16 attention (K7
# rounds f32 q, k, v, p to bf16; the CPU does not) moves the UNet's ε and
# the VAE's latents, which the 7.5× CFG scale amplifies in the SDS term:
# loss to 1e-3 relative (the SDS term enters at weight 1e-4), the SDS loss
# itself to 5e-2; with RGB only every parameter's gradient to cosine 0.999.
# The normal term's gradient passes through depth2normal_geo's least-squares
# solve, here on a 9 × 12 normal map whose 31 × 31 windows span the whole
# map: an ill-conditioned solve that amplifies the field kernels' bf16
# rounding flips (cosine 0.999997 on the stage-1 step) in the rendered
# depth. Measured on the H100 the fine lines' cosines were 0.990–0.9992 in
# three runs (every other parameter ≥ 0.9999; RGB only ≥ 0.99999): 0.98.
STEP2_VIEW, STEP2_LATENT = (63, 84), 512
STEP2_LOSS_RTOL, STEP2_SDS_RTOL = 1e-3, 5e-2
STEP2_GRAD_COS = {"rgb+normal": 0.98, "rgb": 0.999, "colla": 0.999,
                  "perpneg": 0.999}
# K6 against its plain version: the same taps and roundings, so bit-equal
# (limit 1e-6·max|plain|, which equality meets). (label, points, R_max, F):
# the profile's fine pass, the proposal field, a ragged N.
CP_CASES = (("fine", BENCH_RAYS * 128, 257, 80),
            ("proposal", BENCH_RAYS * 64, 65, 24),
            ("ragged", BENCH_RAYS * 128 - 29, 257, 80))
CP_ATOL_FRAC = 1e-6
# its gradient (the plain backward on both sides) card vs CPU: the cotangents
# are rounded to bf16 after f32 sums in another order, one bf16 step
# (2^-7 relative) and 5e-3·max where the three axes' terms cancel
CP_GRAD_POINTS, CP_GRAD_RTOL, CP_GRAD_ATOL_FRAC = 65536 - 29, 2.0 ** -7, 5e-3
# the disk phase: the round-5 ablation scene written to disk by the
# synthetic-scene twin (252 × 189, 16 + 3 views, sparse COLMAP, seed 0),
# loaded by load_scene, then the ablation twin's s1 and nog configs through
# train(): stage-1 steps, then nog steps (LPIPS patches, random VGG, no
# guidance) from s1's checkpoint
DISK_VIEWS, DISK_S1_STEPS, DISK_NOG_STEPS = (16, 3), 300, 100
DISK_S1_PRINT, DISK_NOG_PRINT = 50, 20
# the parallel phase: (a) one NCCL rank through run.py, NCCL_STEPS stage-1
# steps of configs/spinnerf_scene.txt on the disk scene (ms by groups of
# NCCL_PRINT); (b) two gloo ranks sharing the card, the full-width stage-1
# step at PAR_N_RAND rays a stream (half a rank; the streams cut to
# PAR_BANK rays) against the one-process step, twice, then PAR_STEPS timed
# steps; (c) two gloo ranks, the stage-2 step with the full-size SD stack
# tensor-parallel over model = 2, against the unsharded step, on the first
# PAR_VIEWS views; (d) the SPMD demo twin at its micro size. The bf16 step
# tolerance of PERF.md §2: loss PAR_LOSS_RTOL, every gradient's cosine
# PAR_COS; a rank holds at most PAR_BYTES_MAX of the UNet. In (c) the
# loss carries the score-distillation term w·Σ latents·g, whose terms
# partly cancel and whose g (the CFG-combined bf16 UNet outputs, the CFG
# scale amplifying their rounding) the step uses through its gradient
# alone. S = w·Σ|latents·g| is the scale of those terms. (c) holds: the
# whole loss, |Δloss| ≤ PAR_LOSS_RTOL·(|loss − w·sds| + S); the loss
# without the SDS term, relative, at PAR_LOSS_RTOL; the SDS term,
# |Δ(w·sds)| ≤ PAR_SDS_RTOL·S; and g, each modality's cosine ≥ PAR_G_COS.
# PAR_SDS_RTOL and PAR_G_COS come from the one-process step's own noise
# floor, read in every run beside (c): the bf16 step against the same step
# in f32 read 1.68e-3 on the SDS term and g at cosine 0.99934 on an H100
# (two bf16 roundings of one f32 step sit ≈ √2 as far apart); the bounds
# are twice that (2·√2·1.68e-3; 1 − 4·6.6e-4). The controls, the CFG
# scales 1.1× (9.35e-3, and the whole loss 2.7e-3) and other draws, must
# fail them; the same step with cuDNN's benchmarked algorithms and cuBLAS's
# other bf16 reduction must pass (PERF.md §2)
NCCL_STEPS, NCCL_PRINT = 50, 25
PAR_N_RAND, PAR_BANK, PAR_STEPS, PAR_VIEWS = 1024, 65536, 50, 4
PAR_LOSS_RTOL, PAR_COS, PAR_BYTES_MAX = 1e-3, 0.999, 0.6
PAR_SDS_RTOL, PAR_G_COS = 5e-3, 0.997
PAR_SD = ("full", 512)           # (c)'s SD stack and its latent size
PAR_TIMEOUT = 600
# the CP field's x01 on the card against the CPU at CP_POS_POINTS points
CP_POS_POINTS = 1 << 20
# the Blender phase: a scene in nerf_synthetic's layout (BLENDER_VIEWS train,
# val and test views at BLENDER_SIZE², camera_angle_x as its scenes, cameras
# on a sphere of BLENDER_RADIUS), read with half_res and testskip; stage 1
# for BLENDER_STEPS; the mesh at MESH_RES³ over [−MESH_BOUND, MESH_BOUND]³
# in slabs of MESH_SLAB·MESH_RES² points; field_normals at up to
# NORMAL_POINTS mesh vertices, held to the plain normals at cosine
# NORMAL_COS_MIN (every vertex: the dx tolerance, rtol 5e-2, turns a
# vector by up to ~0.05 rad) and NORMAL_COS_MEDIAN (the median)
BLENDER_VIEWS, BLENDER_SIZE, BLENDER_TESTSKIP = (100, 8, 16), 800, 8
BLENDER_ANGLE_X, BLENDER_RADIUS = 0.6911112, 4.0
BLENDER_STEPS, BLENDER_PRINT = 300, 50
MESH_RES, MESH_BOUND, MESH_SLAB = 256, 1.5, 8
NORMAL_POINTS, NORMAL_COS_MIN, NORMAL_COS_MEDIAN = 65536, 0.99, 0.9999
# LPIPS on the card against the CPU on 4 × 32 × 32 patches (random VGG,
# TF32 off): cuDNN picks its own f32 algorithm for each of the 13 convs
# (Winograd, FFT or implicit GEMM), which rounds otherwise than the CPU's
# direct convolution: distance to rtol 1e-3, input gradient to atol
# 2e-3·max|cpu|
LPIPS_SHAPE, LPIPS_RTOL, LPIPS_GRAD_ATOL_FRAC = (4, 32, 32, 3), 1e-3, 2e-3
# the guided arms on the disk scene (the ablation twin's priorNL-sds from
# s1's checkpoint): a tiny prior trained for a few steps by the tiny-prior
# CLI at latent 256 on PRIOR_DOMAIN domain images, the scene LoRA by the
# LoRA CLI on it, then priorNL-sds steps through train()
PRIOR_DOMAIN, PRIOR_STEPS, LORA_TINY_STEPS = 16, 40, 10
PRIOR_NL_STEPS, PRIOR_NL_PRINT = 60, 20
# the LoRA phase: the full-size SD1.5-inpainting UNet (bf16, random) at the
# reference's shape, rank/α 32, batch 4 at 512², AdamW lr 1e-4: warm-up
# and timed steps; the adapters the JAX package selects on that UNet
# (jax.eval_shape of its UNet); a full-size DDIM inpaint at DDIM_STEPS
LORA_BATCH, LORA_WARM, LORA_STEPS, LORA_RANK = 4, 5, 10, 32
LORA_ADAPTERS, LORA_KERNELS = 13_565_952, 192
DDIM_STEPS = 10
# the merged UNet (merge_lora_strict) against the functional path
# (apply_lora + functional_call): both round W + (α/r)·A@B to bf16 once,
# so equal up to the order of nothing: ε cosine 0.999
LORA_MERGE_COS = 0.999
# one tiny LoRA step (f32 stack at 512², so K7 runs in the UNet and the
# VAE) on the card against the CPU: the card's K7 rounds q, k, v and p to
# bf16 where the CPU does not, which moves ε by ≈ 1e-3 relative: the loss
# to 1e-3 relative, every adapter's gradient to cosine 0.999
LORA_TINY_LOSS_RTOL, LORA_TINY_GRAD_COS = 1e-3, 0.999
# the hash phase: the render phase's 16384 rays in groups, then stage-2
# steps from its stage-1 checkpoint
HASH_BENCH_GROUPS, HASH_BENCH_REPS = 5, 3
HASH_STAGE2_STEPS, HASH_STAGE2_PRINT = 20, 5
# the bench twin (gbnerf_tpu_torch/tools/bench.py) at bench.py's workload:
# TWIN_RAYS rays, TWIN_REPS renders a loop; the weights phase writes the
# fake SD checkpoint at WEIGHTS_SD's widths ("full": SD1.5-inpainting)
TWIN_RAYS, TWIN_REPS, WEIGHTS_SD = 16384, 128, "full"
# the profiling entry points' reps in this script
PROF_FIELD_REPS, PROF_TRAIN_REPS, PROF_GUIDANCE_REPS = 5, 5, 3
# Peaks of an H100 SXM (NVIDIA's data sheet, dense): HBM bytes/s, bf16
# tensor-core and f32 FLOP/s. A kernel's bound is the larger of its bytes
# (each input read once, each output written once) over the memory rate
# and its operations over their peaks (bf16 products on the tensor cores,
# the elementwise f32 arithmetic on the CUDA cores; the two kinds of unit
# run at once, so each is a bound of its own).
HBM_BPS, BF16_FLOPS, F32_FLOPS = 3.35e12, 989e12, 67e12
# f32 operations per encoded feature: three two-tap lerps (mul + fma) and
# the two products of the axes
ENC_OPS = 11
DEVICE = "cuda:0"
# the jax-draws phase: the twin's ulp bound for draws through log1p and
# erf_inv (tests/test_torch_jax_random.py), its steps timed a draw kind,
# and what jax 0.9.0 gave on a CPU from PRNGKey(42): split in 3, the
# second key folded with 7, then 5 draws of each kind from that key
JAX_ULP, JAX_STEP_REPS = 4, 20
# the JAX-draw step on phase 5's trained fields, jitter on, card against
# CPU with the kernels on: the fine lines' gradient cosine read 0.99590,
# 0.99970 and 0.99962 for keys 5, 6 and 7 on an H100, the same as the
# kernels against the card's plain path on the same draws, while the
# card's plain path read ≥ 0.999987 against the CPU: the gap is the
# kernels' bf16 on trained fields, which torch's draws show too (0.99965
# to 0.99996, seeds 5 to 7). The bound leaves more than twice the worst
# gap seen (0.0041, key 5, the key the phase runs).
JAX_TRAINED_COS, JAX_STEP_SEED = 0.99, 5
# the full-width LoRA step timed by draw kind (batch LORA_BATCH, rank
# LORA_RANK, 512²): JAX_LORA_REPS steps a turn, in turns torch, jax, jax,
# torch, after one warm-up step of each
JAX_LORA_REPS = 4
JAX_GOLDEN = {
    True: {"split": [(1832780943, 270669613), (64467757, 2916123636),
                     (2465931498, 255383827)],
           "fold_in": (520833650, 68019029),
           "bits": [1994246173, 1561166990, 1610240137, 747541974,
                    1006511542],
           "uniform": [0.4643216133117676, 0.36348748207092285,
                       0.37491321563720703, 0.17405056953430176,
                       0.23434662818908691],
           "randint": [17459, 94754, 86192, 5550, 64789],
           "normal": [-0.08955191820859909, -0.34915226697921753,
                      -0.31886816024780273, -0.9382786154747009,
                      -0.7246067523956299],
           "exponential": [0.6242213249206543, 0.451751172542572,
                           0.46986478567123413, 0.19122172892093658,
                           0.26702573895454407],
           "truncated_normal": [-0.08546718209981918, -0.3326511085033417,
                                -0.3038930296897888, -0.882025957107544,
                                -0.685754656791687],
           # bf16 (bit patterns): 8-bit words, uniform, normal
           "bits8": [29, 142, 137, 214, 182],
           "uniform_bf16": [15840, 16142, 16136, 16214, 16182],
           "normal_bf16": [49052, 15890, 15786, 16252, 16144]},
    False: {"split": [(3134548294, 3733159049), (3746501087, 894150801),
                      (801545058, 2363201431)],
            "fold_in": (2256930989, 524940092),
            "bits": [2055658885, 3916580167, 3238666461, 4245475352,
                     3494230065],
            "uniform": [0.4786202907562256, 0.9118998050689697,
                        0.7540607452392578, 0.9884767532348633,
                        0.8135638236999512],
            "randint": [50503, 45658, 7421, 73748, 49870],
            "normal": [-0.053616587072610855, 1.352547287940979,
                       0.6873242259025574, 2.2726640701293945,
                       0.8911060094833374],
            "exponential": [0.651276707649231, 2.4292805194854736,
                            1.4026707410812378, 4.463388919830322,
                            1.67966628074646],
            "truncated_normal": [-0.05117490142583847, 1.2435004711151123,
                                 0.6510748267173767, 1.8283424377441406,
                                 0.8391112685203552],
            "bits8": [199, 7, 203, 186, 111],
            "uniform_bf16": [16198, 15552, 16202, 16186, 16092],
            "normal_bf16": [16194, 49146, 16208, 16156, 48688]},
}


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean ms per call on the card (CUDA events, after one warm-up call)."""
    from gbnerf_tpu_torch.utils.profiling import time_ms

    return time_ms(fn, torch.device(DEVICE), reps)


def graph_ms(fn, reps: int) -> float:
    """Mean device ms per call with the host out of the loop (CUDA graph)."""
    from gbnerf_tpu_torch.utils.profiling import graph_ms as _graph_ms

    return _graph_ms(fn, torch.device(DEVICE), reps)


def roofline(nbytes: float, bf16_flop: float = 0.0, f32_op: float = 0.0
             ) -> dict:
    """The least time the H100 could take for this work, and what sets it."""
    t_bytes = nbytes / HBM_BPS * 1e3
    t_ops = max(bf16_flop / BF16_FLOPS, f32_op / F32_FLOPS) * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


# ex2 results a clock an SM on Hopper's special-function units
SFU_EX2_A_CLOCK = 16
_sm_clock_hz = None


def sm_clock_hz() -> float:
    """The card's highest SM clock in Hz (nvidia-smi clocks.max.sm)."""
    global _sm_clock_hz
    if _sm_clock_hz is None:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, check=True, timeout=60).stdout
        _sm_clock_hz = float(out.strip().splitlines()[0]) * 1e6
    return _sm_clock_hz


def attention_bound(c: dict) -> dict:
    """K7's least time on this card at the shapes of check line c, the
    largest of three: its bytes (q, k, v read once, the output written
    once, in their dtypes) over the HBM rate; its products at the depth
    and width the tensor cores run (as the kernel's library reports them,
    ops/attention.py::kernel_info: q·kᵀ 16·⌈D/16⌉ deep up to D 128) at the
    bf16 rate; one ex2 a score on the SFU at SFU_EX2_A_CLOCK a clock an
    SM, the SM count and the highest SM clock read from the card. The
    other f32 work a score (one FMA, a max, an add at 128 a clock an SM)
    always takes less than the exps.
    bound_by names the largest: bytes, products or exp."""
    from gbnerf_tpu_torch.ops import attention as at

    bh, n, d = c["bh"], c["n"], c["d"]
    info = at.kernel_info(d)
    dqk, dv = info["qk_depth"], info["pv_width"]
    q_bytes = 4 if c.get("q_dtype") == str(torch.float32) else 2
    times = {
        "bytes": bh * n * d * (2 * q_bytes + 4) / HBM_BPS * 1e3,
        "products": 2.0 * bh * n * n * (dqk + dv) / BF16_FLOPS * 1e3,
        "exp": bh * n * n / (torch.cuda.get_device_properties(
            DEVICE).multi_processor_count * SFU_EX2_A_CLOCK
            * sm_clock_hz()) * 1e3}
    by = max(times, key=times.get)
    return {"bound_ms": times[by], "bound_by": by,
            "bound_parts_ms": times, "sm_clock_mhz": sm_clock_hz() / 1e6}


def head_macs(feat: int, sigma_only: bool) -> int:
    """Multiply-adds a point of the σ (and colour) heads: the weights' size."""
    macs = feat * 64 + 64 * 16
    return macs if sigma_only else macs + 31 * 64 + 64 * 64 + 64 * 3


def kernel_bound(name: str, c: dict) -> dict:
    """roofline() of one kernel call at the shapes of its check line ``c``.
    Bytes: points in and results out, lines and weights once (f32; twice
    for the backward, which writes their gradients). Operations: the heads'
    products in bf16 (2 per multiply-add; a backward 3× its forward: the
    recomputed forward and the two products of each layer's backward), the
    encode's ENC_OPS f32 operations per feature (3× in a backward);
    attention: attention_bound; the merge one comparison per output."""
    if name == "merge128":
        rows = c["rows"]
        return roofline(rows * 128 * 4 * 2, 0.0, rows * 128)
    if name == "attention":
        return attention_bound(c)
    n, feat, r = c["points"], c["F"], c["R_max"]
    lines, enc = 3 * r * feat * 4, float(n) * feat * ENC_OPS
    if name == "cp_encode":
        return roofline(n * (12 + feat * 4) + lines, 0.0, enc)
    sigma = name.endswith("sigma")
    macs = head_macs(feat, sigma)
    if name.startswith("field_fused_bwd"):
        per_point = 12 + 16 + 12 + (0 if sigma else 2 * 64)  # x, g; dx; sh, dsh
        return roofline(n * per_point + 2 * (lines + macs * 4),
                        3 * 2.0 * n * macs, 3 * enc)
    per_point = 12 + 16 + (0 if sigma else 64)               # x; raw; sh
    return roofline(n * per_point + lines + macs * 4, 2.0 * n * macs, enc)


def compare_field(got, ref, rtol=FIELD_RTOL, atol_frac=FIELD_ATOL_FRAC) -> dict:
    diff = (got - ref).abs()
    atol = atol_frac * max(float(ref.abs().max()), 1e-3)
    bad = diff > atol + rtol * ref.abs()
    return {"max_abs_err": float(diff.max()),
            "max_rel_err": float((diff / ref.abs().clamp_min(atol)).max()),
            "n_out_of_tol": int(bad.sum()), "atol": atol}


def field_operands(dev, field, n, np_rng, *, tie_free=False, samples=0):
    """x01 [n, 3], sh [n, 16], the field's unified lines and head weights;
    samples > 0: the points along rays of that many samples, as
    tools/prof_field_kernels.py lays them out (else independent points)."""
    from gbnerf_tpu_torch.core.encoding import sh_encode
    from gbnerf_tpu_torch.ops import field_fused as ff
    from gbnerf_tpu_torch.ops.cp_pallas import upsample_lines

    r_max = max(field.resolutions)
    ul = upsample_lines([l.detach() for l in field.lines()], r_max)
    Ws = {k: getattr(field, k).detach() for k in ff.W_KEYS}
    if samples:
        from gbnerf_tpu_torch.tools.prof_field_kernels import points

        x = points("rays", n, samples, np_rng)
    else:
        x = np_rng.random((n, 3), dtype=np.float32)
    if tie_free:
        # off the grid nodes and the clip boundary, where the kernel's and
        # autograd's subgradient conventions differ (tests/test_field_bwd.py)
        x = (0.03 + 0.94 * x).astype(np.float32)
        u = x * (r_max - 1)
        x += ((np.abs(u - np.round(u)) < 1e-3) * 2e-3).astype(np.float32)
    d = np_rng.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    sh = sh_encode(torch.from_numpy(d).to(dev)).contiguous()
    return torch.from_numpy(x).to(dev), sh, ul, Ws


def check_field_bwd(dev, fine, coarse, np_rng):
    """K4 at the stage-1 fine and coarse pass shapes (131,072 and 65,536
    points, F 80, R_max 257), K5 at 65,536; each also at a ragged size,
    once with clipped points and, timed too, once with the points along
    rays of 128 (fine) or 64 (coarse) samples, as a training step lays
    them out. All cotangents against the plain backward."""
    from gbnerf_tpu_torch.ops import field_fused as ff

    results = {}
    cases = [("field_fused_bwd", "fine", fine, N_RAND * 128, False),
             ("field_fused_bwd", "coarse", coarse, N_RAND * 64, False),
             ("field_fused_bwd_sigma", "coarse", coarse, N_RAND * 64, True)]
    for name, label, field, n, sigma_only in cases:
        for variant in ("", "ragged", "clipped", "rays"):
            m = n - 29 if variant == "ragged" else n
            x, sh, ul, Ws = field_operands(
                dev, field, m, np_rng, tie_free=True,
                samples=(128 if label == "fine" else 64)
                if variant == "rays" else 0)
            if variant == "clipped":
                x[:64, 0] = -0.5
                x[64:128, 1] = 1.5
            sh = None if sigma_only else sh
            if sigma_only:
                Ws = {k: Ws[k] for k in ("ws0", "ws1")}
            g = torch.from_numpy(np_rng.standard_normal(
                (m, 4)).astype(np.float32)).to(dev)
            got = ff.field_fused_bwd(x, sh, ul, Ws, g, sigma_only=sigma_only)
            again = ff.field_fused_bwd(x, sh, ul, Ws, g, sigma_only=sigma_only)
            ref = ff.field_bwd_plain(x, sh, ul, Ws, g, sigma_only=sigma_only)
            torch.cuda.synchronize()
            r = {"points": m, "F": ul.shape[2], "R_max": ul.shape[1],
                 "deterministic": all(
                     (a is None and b is None) or torch.equal(a, b)
                     for a, b in zip(list(got[:3]) + list(got[3].values()),
                                     list(again[:3])
                                     + list(again[3].values())))}
            for cot, a, b in zip(("dx", "dsh", "dulines"), got[:3], ref[:3]):
                if b is None:
                    continue
                r[cot] = (compare_field(a, b, rtol=5e-2, atol_frac=8e-3)
                          if cot == "dx" else compare_field(a, b))
            for k in ref[3]:
                r["d" + k] = compare_field(got[3][k], ref[3][k])
            if variant == "clipped":
                r["clipped_dx_zero"] = bool(
                    (got[0][:64, 0] == 0).all() and (got[0][64:128, 1] == 0).all())
            if variant in ("", "rays"):
                r["ms"] = cuda_ms(lambda: ff.field_fused_bwd(
                    x, sh, ul, Ws, g, sigma_only=sigma_only), reps=5)
                r["graph_ms"] = graph_ms(lambda: ff.field_fused_bwd(
                    x, sh, ul, Ws, g, sigma_only=sigma_only), reps=5)
                r.update(kernel_bound(name, r))
            if not variant:
                r["plain_ms"] = cuda_ms(lambda: ff.field_bwd_plain(
                    x, sh, ul, Ws, g, sigma_only=sigma_only), reps=3)
                r["prev_graph_ms"] = PREV_MS.get((name, label))
            print(f"check {name} [{label}{' ' + variant if variant else ''}] "
                  f"{json.dumps(r)}")
            bad = {k: v["n_out_of_tol"] for k, v in r.items()
                   if isinstance(v, dict) and v["n_out_of_tol"]}
            if bad or r.get("clipped_dx_zero") is False:
                raise AssertionError(f"{name} [{label} {variant}]: values "
                                     f"outside tolerance {bad}, or non-zero "
                                     "dx at clipped coordinates")
            if not r["deterministic"]:
                raise AssertionError(f"{name} [{label} {variant}]: two calls "
                                     "on the same inputs differ")
            r["max_abs_err"] = max(v["max_abs_err"] for v in r.values()
                                   if isinstance(v, dict))
            results.setdefault(name, []).append(r)
    return results


def check_fields(dev, fine, coarse, proposal, np_rng):
    """K1 at fine shapes, K2 at coarse and at proposal-coarse shapes; each
    also timed along rays and, as a stage-1 step calls them (131,072 and
    65,536 points, uniform and along rays), checked and timed there."""
    from gbnerf_tpu_torch.ops import field_fused as ff

    results = {}
    cases = [("field_fused", "fine", fine, BENCH_RAYS * 128, False),
             ("field_fused_sigma", "coarse", coarse, BENCH_RAYS * 64, True),
             ("field_fused_sigma", "proposal", proposal, BENCH_RAYS * 64,
              True)]
    for name, label, field, n, sigma_only in cases:
        for ragged in (False, True):
            m = n - 29 if ragged else n
            x, sh, ul, Ws = field_operands(dev, field, m, np_rng)
            sh = None if sigma_only else sh
            got = ff.cp_field_fused(x, sh, ul, Ws, sigma_only=sigma_only)
            ref = ff.field_plain(x, sh, ul, Ws, sigma_only=sigma_only)
            torch.cuda.synchronize()
            r = compare_field(got, ref)
            r.update(points=m, F=ul.shape[2], R_max=ul.shape[1])
            if sigma_only:
                assert bool((got[:, :3] == 0).all()), f"{name}: rgb not zero"
            if not ragged:
                r["ms"] = cuda_ms(lambda: ff.cp_field_fused(
                    x, sh, ul, Ws, sigma_only=sigma_only), reps=10)
                r["graph_ms"] = graph_ms(lambda: ff.cp_field_fused(
                    x, sh, ul, Ws, sigma_only=sigma_only), reps=10)
                # the plain encode (here and in K4/K5's plain backward) is
                # cp_pallas.encode_plain, built for JAX's tie gradients:
                # slower than a clamp/relu/abs encode (PERF.md has both)
                r["plain_ms"] = cuda_ms(lambda: ff.field_plain(
                    x, sh, ul, Ws, sigma_only=sigma_only), reps=3)
                r.update(kernel_bound(name, r))
                r["prev_graph_ms"] = PREV_MS.get((name, label))
                samples = 128 if label == "fine" else 64
                r["rays_graph_ms"] = field_graph_ms(
                    dev, field, n, np_rng, samples, sigma_only)
                r["train"] = check_field_train(dev, field, N_RAND * samples,
                                               np_rng, samples, sigma_only)
            print(f"check {name} [{label}{' ragged' if ragged else ''}] "
                  f"{json.dumps(r)}")
            bad = r["n_out_of_tol"] + sum(
                t["n_out_of_tol"] for t in r.get("train", {}).values())
            if bad:
                raise AssertionError(
                    f"{name} [{label}]: {bad} values outside rtol "
                    f"{FIELD_RTOL}, atol {FIELD_ATOL_FRAC}·max|plain|")
            results.setdefault(name, []).append(r)
    return results


def field_graph_ms(dev, field, n, np_rng, samples, sigma_only) -> float:
    """K1 (K2 when sigma_only) by CUDA-graph replay at n points along rays
    of that many samples."""
    from gbnerf_tpu_torch.ops import field_fused as ff

    x, sh, ul, Ws = field_operands(dev, field, n, np_rng, samples=samples)
    sh = None if sigma_only else sh
    return graph_ms(lambda: ff.cp_field_fused(x, sh, ul, Ws,
                                              sigma_only=sigma_only), reps=10)


def check_field_train(dev, field, n, np_rng, samples, sigma_only) -> dict:
    """K1/K2 at a stage-1 step's shape (n points), uniform and along rays:
    against the plain version and by CUDA-graph replay."""
    from gbnerf_tpu_torch.ops import field_fused as ff

    out = {}
    for layout, s in (("uniform", 0), ("rays", samples)):
        x, sh, ul, Ws = field_operands(dev, field, n, np_rng, samples=s)
        sh = None if sigma_only else sh
        call = lambda: ff.cp_field_fused(                  # noqa: E731
            x, sh, ul, Ws, sigma_only=sigma_only)
        r = compare_field(call(), ff.field_plain(x, sh, ul, Ws,
                                                 sigma_only=sigma_only))
        r.update(points=n, graph_ms=graph_ms(call, reps=20))
        out[layout] = r
    return out


def check_field_widths(dev, np_rng) -> None:
    """K1/K2 and K4/K5 at widths off the main path: the proposal field's
    (R_max 65, F 24, less than a 16-deep k-chunk), the narrowest (F 16) and
    the widest the kernels take (F 160, MAX_FEAT: K4's shared memory), at
    ragged sizes with tie-free points and random weights, against the plain
    versions at the check tolerances; two backward calls bit-equal."""
    from gbnerf_tpu_torch.ops import field_fused as ff

    for r_max, feat, n in ((65, 24, 4099), (33, 16, 1000),
                           (129, ff.MAX_FEAT, 3001)):
        x = (0.03 + 0.94 * np_rng.random((n, 3))).astype(np.float32)
        u = x * (r_max - 1)
        x += ((np.abs(u - np.round(u)) < 1e-3) * 2e-3).astype(np.float32)
        x = torch.from_numpy(x).to(dev)
        ul, sh, g = (torch.from_numpy(np_rng.standard_normal(shape).astype(
            np.float32) * scale).to(dev) for shape, scale in (
            ((3, r_max, feat), 0.5), ((n, 16), 0.5), ((n, 4), 1.0)))
        for sigma_only in (False, True):
            Ws = {k: torch.from_numpy(np_rng.standard_normal(shape).astype(
                np.float32) * 0.2).to(dev) for k, shape in
                ff.weight_shapes(feat, sigma_only=sigma_only).items()}
            s_ = None if sigma_only else sh
            gg = g.clone()
            if sigma_only:
                gg[:, :3] = 0.0
            with torch.no_grad():
                r = {"raw": compare_field(
                    ff.cp_field_fused(x, s_, ul, Ws, sigma_only=sigma_only),
                    ff.field_plain(x, s_, ul, Ws, sigma_only=sigma_only))}
            runs = [ff.field_fused_bwd(x, s_, ul, Ws, gg,
                                       sigma_only=sigma_only)
                    for _ in range(2)]
            ref = ff.field_bwd_plain(x, s_, ul, Ws, gg, sigma_only=sigma_only)
            flat = [[t for t in run[:3] if t is not None]
                    + [run[3][k] for k in Ws] for run in runs + [ref]]
            names = ["dx"] + ([] if sigma_only else ["dsh"]) + [
                "dulines"] + ["d" + k for k in Ws]
            for name, a, b in zip(names, flat[0], flat[2]):
                r[name] = (compare_field(a, b, rtol=5e-2, atol_frac=8e-3)
                           if name == "dx" else compare_field(a, b))
            det = all(torch.equal(a, b) for a, b in zip(flat[0], flat[1]))
            bad = {k: v["n_out_of_tol"] for k, v in r.items()
                   if v["n_out_of_tol"]}
            print(f"check field widths [R_max {r_max}, F {feat}, {n} points"
                  f"{', sigma only' if sigma_only else ''}] deterministic "
                  f"{det}, max_abs_err "
                  f"{json.dumps({k: v['max_abs_err'] for k, v in r.items()})}")
            if bad or not det:
                raise AssertionError(f"field kernels at F {feat}: outside "
                                     f"tolerance {bad}, or two backward "
                                     "calls differ")


def field_kernel_info(fine, coarse, proposal) -> None:
    """Print the field kernels' registers, spill bytes, shared memory a
    block and blocks an SM at the fields' shapes (the CUDA runtime's
    account of the built kernels)."""
    from gbnerf_tpu_torch.ops import field_fused as ff

    for name, field, backward, sigma_only in (
            ("field_fused", fine, False, False),
            ("field_fused_sigma", coarse, False, True),
            ("field_fused_sigma", proposal, False, True),
            ("field_fused_bwd", fine, True, False),
            ("field_fused_bwd_sigma", coarse, True, True)):
        r_max = max(field.resolutions)
        feat = len(field.resolutions) * field.rank
        info = ff.kernel_info(backward=backward, sigma_only=sigma_only,
                              r_max=r_max, feat=feat)
        print(f"kernel info {name} [R_max {r_max}, F {feat}] "
              f"{json.dumps(info)}")
        if info["blocks_per_sm"] < 1:
            raise AssertionError(f"{name}: a block does not fit an SM: {info}")
    # K1/K2's heads are warpgroup products: HGMMA in the SASS of each of the
    # four builds of field_fused_kernel<kSigmaOnly, kStaged> (mangled with
    # its two bool arguments in that order: ILb<σ-only>ELb<staged>EE)
    sass = sass_counts("field_fused_kernel", ("HGMMA", "HMMA", "LDSM"))
    builds = {}
    for fn, counts in sass.items():
        m = re.search(r"field_fused_kernelILb([01])ELb([01])EE", fn)
        if m:
            builds[(m[1] == "1", m[2] == "1")] = counts
    for sigma_only in (False, True):
        for staged in (True, False):
            kind = ("field_fused_sigma" if sigma_only else "field_fused") + (
                " [lines staged]" if staged else " [lines in L1/L2]")
            counts = builds.get((sigma_only, staged))
            if counts is None:
                raise AssertionError(f"{kind}: not in the kernel library's "
                                     f"SASS (found {sorted(sass)})")
            print(f"kernel info {kind} SASS {json.dumps(counts)}")
            if counts["HGMMA"] == 0:
                raise AssertionError(f"{kind}: no HGMMA in its SASS: {counts}")


def sass_counts(name: str, ops: tuple) -> dict:
    """{function: {op: instructions}} of the built kernel library's SASS
    (cuobjdump -sass, beside nvcc) for the functions whose mangled name
    holds ``name``. Raises where the toolkit has no cuobjdump or it
    fails."""
    from gbnerf_tpu_torch.ops import _build

    tool = Path(_build.find_nvcc()).with_name("cuobjdump")
    if not tool.is_file():
        raise RuntimeError(f"no cuobjdump beside nvcc ({tool})")
    text = subprocess.run([str(tool), "-sass", str(_build.build_library())],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    out, fn = {}, None
    for line in text.splitlines():
        if "Function : " in line:
            fn = line.split("Function : ")[1].strip()
            fn = fn if name in fn else None
            if fn:
                out[fn] = dict.fromkeys(ops, 0)
        elif fn:
            for op in ops:
                if re.search(rf"\b{op}\b", line):
                    out[fn][op] += 1
    return out


def check_merge(dev, np_rng):
    """K3 at [16384, 128] (and ragged), exact, with ties across halves."""
    from gbnerf_tpu_torch.ops import resample as rs

    results = []
    for rows in (BENCH_RAYS, BENCH_RAYS - 5):
        a = np.broadcast_to(np.sort(NEAR + (FAR - NEAR) * np_rng.random(64)),
                            (rows, 64))
        b = np.sort(NEAR + (FAR - NEAR) * np_rng.random((rows, 64)), -1)
        b[::7, 10] = a[::7, 11]                   # ties across the halves
        b[::7] = np.sort(b[::7], -1)
        x = torch.from_numpy(np.concatenate([a, b], -1).astype(np.float32))
        x = x.to(dev).contiguous()
        got = rs.merge128(x, 64)
        ref = rs.merge128_plain(x, 64)
        torch.cuda.synchronize()
        r = {"rows": rows, "max_abs_err": float((got - ref).abs().max()),
             "exact": bool(torch.equal(got, ref))}
        if rows == BENCH_RAYS:
            r["ms"] = cuda_ms(lambda: rs.merge128(x, 64), reps=20)
            r["plain_ms"] = cuda_ms(lambda: rs.merge128_plain(x, 64), reps=20)
            # the yardstick: one library sort of the rows (never called by
            # the port)
            r["library_ms"] = cuda_ms(lambda: torch.sort(x, dim=-1), reps=20)
            r["graph_ms"] = graph_ms(lambda: rs.merge128(x, 64), reps=20)
            r.update(kernel_bound("merge128", r))
        print(f"check merge128 {json.dumps(r)}")
        if not r["exact"]:
            raise AssertionError("merge128 differs from the stable sort")
        results.append(r)

    # its gradient: rows with ties within and across the halves, a random
    # cotangent; the card's forward and gradient against the CPU's
    vals = np_rng.integers(0, 12, size=(BENCH_RAYS, 128)).astype(np.float32)
    x = torch.from_numpy(np.concatenate([np.sort(vals[:, :64], -1),
                                         np.sort(vals[:, 64:], -1)], -1))
    g = torch.from_numpy(np_rng.standard_normal((BENCH_RAYS, 128)).astype(
        np.float32))
    res = {}
    with torch.enable_grad():
        for where, device in (("card", dev), ("cpu", torch.device("cpu"))):
            xd = x.to(device).requires_grad_(True)
            out = rs.merge128(xd, 64)
            (dx,) = torch.autograd.grad(out, xd, g.to(device))
            res[where] = (out.detach().cpu(), dx.cpu())
    r = {"rows": BENCH_RAYS, "ties": True,
         "forward_equal": bool(torch.equal(res["card"][0], res["cpu"][0])),
         "grad_equal": bool(torch.equal(res["card"][1], res["cpu"][1]))}
    print(f"check merge128 gradient (card vs cpu) {json.dumps(r)}")
    if not (r["forward_equal"] and r["grad_equal"]):
        raise AssertionError("merge128's gradient on the card differs from "
                             "the CPU plain path's")
    return results


def camera_arc(n: int, radius: float = 4.0) -> np.ndarray:
    """n camera-to-world poses [n, 3, 4] on an arc, looking at the origin
    (OpenGL: x right, y up, the camera looks down −z)."""
    poses = []
    for th in np.linspace(-0.4, 0.4, n):
        eye = np.array([radius * np.sin(th), 0.5, radius * np.cos(th)])
        fwd = -eye / np.linalg.norm(eye)
        right = np.cross(fwd, [0.0, 1.0, 0.0])
        right /= np.linalg.norm(right)
        up = np.cross(right, fwd)
        poses.append(np.stack([right, up, -fwd, eye], 1))
    return np.stack(poses).astype(np.float32)


def profile_once(fn, label: str, outdir: Path, untraced_ms: float) -> None:
    """Trace one call of fn (after one untraced warm call) into
    outdir/label/trace.json; print device time by kernel and the device's
    idle share of the untraced time (tools/trace_summary.py)."""
    from gbnerf_tpu_torch.tools.trace_summary import summarize
    from gbnerf_tpu_torch.utils.profiling import trace

    fn()
    torch.cuda.synchronize()
    with trace(str(outdir / label)):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3
    s = summarize(str(outdir / label), untraced_ms=untraced_ms)
    print(f"profile {label}: device busy {s['busy_ms']:.3f} ms in "
          f"{len(s['kernels'])} kernel kinds, {s['launches']:.0f} launches; "
          f"{untraced_ms:.3f} ms untraced ({traced_ms:.3f} traced): idle "
          f"share {s['idle_share']:.3f}")
    for name, ms, count in s["kernels"][:15]:
        print(f"profile {label}:   {ms:9.3f} ms x{count:<4.0f} {name[:100]}")


def synthetic_tool():
    """The port's synthetic-scene twin (numpy only)."""
    from gbnerf_tpu_torch.tools import make_synthetic_scene

    return make_synthetic_scene


def spinnerf_scene(n_train: int, H: int, W: int, n_test: int = 2,
                   seed: int = 0):
    """An in-memory scene of SPIn-NeRF size: n_train views (plus n_test
    held out, with ground truth) of the synthetic sphere on a forward arc,
    label masks (the dilated silhouette of an intruder sphere), inpainted
    disparities, and COLMAP-style depth rays (200 surface pixels a view,
    z-depth, weights 2·exp(−(err/ē)²)) → (LLFFScene, depth_gts)."""
    from gbnerf_tpu_torch.data.llff import LLFFScene

    syn = synthetic_tool()
    rng = np.random.default_rng(seed)
    focal = 1.2 * W
    n = n_train + n_test
    test_idx = [(k + 1) * n // (n_test + 1) for k in range(n_test)]
    imgs, masks, disps, poses, depth_gts = [], [], [], [], []
    for k in range(n):
        th = (k / (n - 1) - 0.5) * 0.9
        c2w = syn.look_at(np.array([2.5 * np.sin(th), 0.3 * np.sin(2 * th),
                                    2.5 * np.cos(th)]))
        img, depth, _ = syn.render_scene(H, W, focal, c2w)
        _, _, hit = syn.render_scene(H, W, focal, c2w,
                                     (syn.MAIN_SPHERE, syn.INTRUDER))
        imgs.append(img)
        masks.append(syn.dilate(hit == 1, it=2).astype(np.float32))
        disps.append(1.0 / np.maximum(depth, 1e-3))
        poses.append(np.concatenate(
            [c2w, np.array([[H], [W], [focal]], np.float32)], 1))
        ys, xs = np.nonzero(depth < 3.99)          # the sky carries 4.0
        sel = rng.choice(len(ys), min(200, len(ys)), replace=False)
        x, y = xs[sel], ys[sel]
        ray_len = np.sqrt(((x - W / 2) / focal) ** 2
                          + ((y - H / 2) / focal) ** 2 + 1.0)
        err = rng.uniform(0.3, 1.5, len(sel))
        depth_gts.append({
            "coord": np.stack([x, y], -1).astype(np.float32),
            "depth": (depth[y, x] / ray_len).astype(np.float32),
            "weight": (2.0 * np.exp(-(err / err.mean()) ** 2)).astype(
                np.float32)})
    imgs, masks, poses = np.stack(imgs), np.stack(masks), np.stack(poses)
    disps = np.stack(disps)
    train = [k for k in range(n) if k not in test_idx]
    scene = LLFFScene(
        images=imgs[train], masks=masks[train],
        inpainted_depths=(disps / disps.max())[train].astype(np.float32),
        poses=poses[train], poses_test=poses[test_idx],
        bds=np.array([[1.0, 4.5]], np.float32), render_poses=poses[test_idx],
        hwf=(H, W, focal), near=1.0, far=4.5, images_test=imgs[test_idx],
        masks_test=masks[test_idx])
    return scene, [depth_gts[k] for k in train]


def _launch_counters() -> tuple:
    from gbnerf_tpu_torch.ops import attention as at
    from gbnerf_tpu_torch.ops import cp_pallas as cp
    from gbnerf_tpu_torch.ops import field_fused as ff
    from gbnerf_tpu_torch.ops import resample as rs

    return ff.LAUNCHES, rs.LAUNCHES, at.LAUNCHES, cp.LAUNCHES


def all_launches() -> dict:
    return {k: v for counts in _launch_counters() for k, v in counts.items()}


def zero_launches() -> None:
    from gbnerf_tpu_torch.ops import attention as at

    for counts in _launch_counters():
        for k in counts:
            counts[k] = 0
    at.LAUNCHES_BY_SHAPE.clear()


def check_attention(dev):
    """K7 against its plain version at ATTN_SHAPES (bf16) and
    ATTN_F32_SHAPES (f32 q), q scaled ×3 for a peaked softmax; times both
    at the main-path shapes, beside SDPA and the previous design."""
    from gbnerf_tpu_torch.ops import attention as at

    for d in ATTN_INFO_D:                # up to D 48 also with two consumers
        for wm in (0, 8) if d <= 48 else (0,):
            info = at.kernel_info(d, wm)
            print(f"kernel info attention [D {d}{', wm 8' if wm else ''}] "
                  f"{json.dumps(info)}")
            if info["blocks_per_sm"] < 1:
                raise AssertionError(f"attention at D {d}: a block does not "
                                     f"fit an SM: {info}")
            if info["key_tile"] != at.key_tile(d):   # the plain version's
                raise AssertionError(f"attention at D {d}: the kernel's key "
                                     f"tile {info['key_tile']} is not "
                                     f"key_tile's {at.key_tile(d)}")
    gen = torch.Generator(device=dev).manual_seed(5)
    results = []
    cases = ([(c, torch.bfloat16) for c in ATTN_SHAPES]
             + [(c, torch.float32) for c in ATTN_F32_SHAPES]
             + [(c, torch.float16) for c in ATTN_F16_SHAPES])
    for (label, bh, n, d), dtype in cases:
        q, k, v = (torch.randn((bh, n, d), generator=gen, device=dev)
                   .to(torch.bfloat16) for _ in range(3))
        q = (q * 3).to(dtype)
        scale = d ** -0.5
        before = at.LAUNCHES["attention_kernels"]
        got = at.flash_fwd(q, k, v, scale)
        kernels = at.LAUNCHES["attention_kernels"] - before
        ref = at.attention_plain(q, k, v, scale)
        torch.cuda.synchronize()
        r = compare_field(got.float(), ref.float(), rtol=ATTN_RTOL,
                          atol_frac=ATTN_ATOL_FRAC)
        r.update(shape=label, bh=bh, n=n, d=d, q_dtype=str(dtype),
                 out_dtype=str(got.dtype),
                 plan=at.kernel_plan(bh, n, d, dev),
                 kernels_a_call=kernels,
                 finite=bool(torch.isfinite(got).all()))
        if label in ATTN_TIMED and dtype == torch.bfloat16:
            r["ms"] = cuda_ms(lambda: at.flash_fwd(q, k, v, scale), reps=20)
            r["plain_ms"] = cuda_ms(
                lambda: at.attention_plain(q, k, v, scale), reps=5)
            # the yardstick: one library call on [1, BH, N, D] (never called
            # by the port)
            q4, k4, v4 = q[None], k[None], v[None]
            r["library_ms"] = cuda_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    q4, k4, v4, scale=scale), reps=20)
            # both again with the host out of the loop (device time alone)
            r["graph_ms"] = graph_ms(lambda: at.flash_fwd(q, k, v, scale),
                                     reps=20)
            r["library_graph_ms"] = graph_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    q4, k4, v4, scale=scale), reps=20)
            r.update(kernel_bound("attention", r))
            r["prev_graph_ms"] = PREV_MS.get(("attention", label))
        print(f"check attention [{label}] {json.dumps(r)}")
        if (r["n_out_of_tol"] or not r["finite"]
                or got.dtype != q.dtype or kernels not in (1, 2)):
            raise AssertionError(
                f"attention [{label}]: {r['n_out_of_tol']} values outside "
                f"rtol {ATTN_RTOL}, atol {ATTN_ATOL_FRAC}·max|plain|, or "
                f"output {got.dtype} for q {q.dtype}, or {kernels} kernels")
        results.append(r)
    results.append(check_attention_head_dims(dev, gen))
    return results


def check_attention_head_dims(dev, gen):
    """K7 against its plain version at ATTN_SWEEP_D (see there); one line
    with the worst case, and every case outside tolerance."""
    from gbnerf_tpu_torch.ops import attention as at

    bh, n = ATTN_SWEEP_BH, ATTN_SWEEP_N
    cases, bad, worst, max_err = 0, [], {"err_over_atol": 0.0}, 0.0
    for d in ATTN_SWEEP_D:
        q0, k, v = (torch.randn((bh, n, d), generator=gen, device=dev)
                    .to(torch.bfloat16) for _ in range(3))
        for dtype in (torch.bfloat16, torch.float32, torch.float16):
            q = (q0 * 3).to(dtype)
            ref = at.attention_plain(q, k, v, d ** -0.5).float()
            # every block shape the head dim takes (up to D 48 two
            # consumer warpgroups and the most it allows), whichever the
            # plan would pick
            plans = set()
            for wm, split in itertools.product((0, 8, 12, 16), (1, 2)):
                try:
                    plans.add(at.kernel_plan(bh, n, d, dev,
                                             plan=at.Plan(wm, split)))
                except ValueError:
                    pass
            for plan in sorted(plans):
                got = at.flash_fwd(q, k, v, d ** -0.5, plan=plan)
                r = compare_field(got.float(), ref, rtol=ATTN_RTOL,
                                  atol_frac=ATTN_ATOL_FRAC)
                case = {"d": d, "q_dtype": str(dtype), "plan": plan,
                        "max_abs_err": r["max_abs_err"],
                        "err_over_atol": r["max_abs_err"] / r["atol"]}
                cases += 1
                max_err = max(max_err, r["max_abs_err"])
                if (r["n_out_of_tol"] or got.dtype != dtype
                        or not bool(torch.isfinite(got).all())):
                    bad.append(case)
                if case["err_over_atol"] > worst["err_over_atol"]:
                    worst = case
    r = {"shape": "head dims", "bh": bh, "n": n, "d": list(ATTN_SWEEP_D),
         "cases": cases, "n_bad": len(bad), "bad": bad[:10],
         "max_abs_err": max_err, "worst": worst,
         "rtol": ATTN_RTOL, "atol_frac": ATTN_ATOL_FRAC}
    print(f"check attention [head dims] {json.dumps(r)}")
    if bad:
        raise AssertionError(f"attention: {len(bad)} of {cases} head-dim "
                             f"cases outside tolerance, e.g. {bad[0]}")
    return r


def stage2_config(cfg, workdir: Path, ft_path: str, n_iters: int):
    """The shipped stage-2 configuration with random SD weights, both
    modalities on from the first step, cadences quiet."""
    never = 10 ** 9
    return cfg.replace(
        train=dataclasses.replace(
            cfg.train, first_stage=False, N_iters=n_iters,
            i_print=STAGE2_PRINT, i_weights=never, i_evaluate=never,
            i_testset=never, i_video=never, basedir=str(workdir),
            expname="stage2", no_reload=True, ft_path=ft_path),
        guidance=dataclasses.replace(cfg.guidance, sd_allow_random=True,
                                     normal_start_iter=0))


def stage2_train(cfg, dev, scene, depth_gts, workdir: Path, start: int, *,
                 label: str = "stage2", steps: int = STAGE2_STEPS,
                 every: int = STAGE2_PRINT, profile_dir=None,
                 src: str = "stage1",
                 kernels=("field_fused", "merge128", "field_fused_bwd",
                          "attention"), **guidance):
    """Stage 2 through train(), ``steps`` steps after the checkpoint at
    ``start`` of the stage-1 run ``src``, with ``guidance`` overriding the
    shipped guidance options; the steps must launch ``kernels`` → (out, ms
    per step, launches, the config, peak memory in GiB). With
    ``profile_dir``, one more step is traced."""
    from gbnerf_tpu_torch.ops import attention as at
    from gbnerf_tpu_torch.train.loop import train

    cfg = stage2_config(cfg, workdir,
                        str(workdir / src / "ckpt" / str(start)),
                        start + steps)
    cfg = cfg.replace(
        train=dataclasses.replace(cfg.train, i_print=every, expname=label),
        guidance=dataclasses.replace(cfg.guidance, **guidance))
    group_ms = []

    def log_fn(i, m):
        print(f"{label}: [{i}/{start + steps}] " + " ".join(
            f"{k}={v:.5g}" for k, v in m.items()))
        bad = [k for k, v in m.items() if not np.isfinite(v)]
        if bad:
            raise AssertionError(f"non-finite {label} metrics at {i}: {bad}")
        if m["sds_loss"] == 0.0:
            raise AssertionError(f"sds_loss is 0 at {i}: no guidance")
        group_ms.append(1e3 / m["iters_per_sec"])

    torch.cuda.synchronize()
    base_gib = torch.cuda.memory_allocated() / 2 ** 30
    torch.cuda.reset_peak_memory_stats()
    # ---- the main path: launches counted from here ...
    zero_launches()
    out = train(cfg, scene=scene, depth_gts=depth_gts, device=dev,
                log_fn=log_fn)
    torch.cuda.synchronize()
    launches, by_shape = all_launches(), dict(at.LAUNCHES_BY_SHAPE)
    # ... to here
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    if out["state"].step != start + steps or len(group_ms) == 0:
        raise AssertionError(f"{label} stopped at {out['state'].step}")
    print(f"{label}: launches {json.dumps(launches)}; attention by (N, D) "
          f"{json.dumps({f'{n}x{d}': c for (n, d), c in by_shape.items()})}")
    for k in kernels:
        if launches[k] <= 0:
            raise AssertionError(f"kernel {k} was not launched by {label}")
    unet = sum(c for (n, d), c in by_shape.items() if d in (40, 80))
    vae = sum(c for (n, d), c in by_shape.items() if d == 512)
    if unet <= 0 or vae <= 0:
        raise AssertionError(f"K7 launches: UNet {unet}, VAE {vae}")
    ms = float(np.median(group_ms[1:] or group_ms))
    times = out["setup_times"]
    print(f"{label}: {steps} steps at the full SD1.5-inpaint width "
          f"(bf16, 512² / 64² latents, RGB + normal SDS"
          f"{''.join(f', {k}={v}' for k, v in guidance.items())}): "
          f"{ms:.3f} ms per step (median of the groups of {every} after the "
          f"first: {', '.join(f'{g:.3f}' for g in group_ms)}); peak memory "
          f"{peak_gib:.2f} GiB ({peak_gib - base_gib:.2f} above the "
          f"{base_gib:.2f} GiB held before the run); SD build "
          f"{times['sd_build_s']:.3f} s, "
          f"masked-latents cache of {len(scene.images)} views "
          f"{times['masked_latents_s']:.3f} s; K7 launches UNet {unet}, "
          f"VAE {vae}")
    if profile_dir is not None:
        profile_step(cfg, dev, out, scene, profile_dir, label, ms)
    return out, ms, launches, cfg, peak_gib


def sds_gradient_check(cfg, dev, out, scene):
    """The SDS term alone, on one batch of the trained stage-2 state: its
    gradient reaches the fine field's lines (render → VAE → latents)."""
    from gbnerf_tpu_torch.data.rays_bank import build_ray_banks
    from gbnerf_tpu_torch.train.loop import banks_to_device, scene_to_device
    from gbnerf_tpu_torch.guidance import make_guidance_fn
    from gbnerf_tpu_torch.guidance.stable import precompute_masked_latents
    from gbnerf_tpu_torch.train.step import (make_train_step_stage2,
                                             select_stage2_view)

    state, mods = out["state"], out["guidance"]
    banks = build_ray_banks(scene.images, scene.masks, scene.inpainted_depths,
                            scene.poses, scene.hwf[2])
    scene_dev = scene_to_device(scene, banks, dev)
    gen = torch.Generator(device=dev).manual_seed(11)
    scene_dev["masked_latents"] = precompute_masked_latents(
        mods, scene_dev["images"][:2], scene_dev["masks"][:2], generator=gen)
    step = make_train_step_stage2(
        cfg, state.coarse, state.fine, scene.near, scene.far, scene.hwf,
        guidance_fn=make_guidance_fn(mods, cfg.guidance))
    batch = select_stage2_view(scene_dev, banks_to_device(banks, dev),
                               cfg.train.N_rand, gen, img_i=1)
    _, m = step.loss_fn(batch, state.step, gen)
    lines = state.fine.lines()
    grads = torch.autograd.grad(m["sds_loss"], lines)
    norms = [float(g.norm()) for g in grads]
    print(f"sds gradient: sds_loss {m['sds_loss'].detach().item():.6g}; "
          f"|d sds / d "
          f"fine lines_l| = {', '.join(f'{x:.4g}' for x in norms)}")
    if not (all(np.isfinite(norms)) and sum(norms) > 0):
        raise AssertionError(f"the SDS term gives the fine lines no finite "
                             f"gradient: {norms}")
    return norms


def stage2_step_vs_plain(cfg, dev, state, np_rng, key=None,
                         variants=("rgb+normal", "rgb", "colla", "perpneg")):
    """One stage-2 loss and gradient on the card vs the CPU plain path, at
    the tiny SD widths in f32 and sd_latent_size 512, on a small view: RGB
    + normal, RGB alone, RGB + colla (the four neighbour views injected,
    rendered with gradient), and Perp-Neg's RGB (its orbit uniforms
    injected). key: a JaxKey, whose guidance draws (the SDS steps' ε and
    posterior ε, Perp-Neg's orbit) replace the injected ones, drawn on
    each device."""
    from gbnerf_tpu_torch.data.rays_bank import build_ray_banks
    from gbnerf_tpu_torch.guidance import build_sd_modules, make_guidance_fn
    from gbnerf_tpu_torch.guidance.text import CLIPTextConfig
    from gbnerf_tpu_torch.guidance.unet import UNetConfig
    from gbnerf_tpu_torch.guidance.vae import VAEConfig
    from gbnerf_tpu_torch.ops import attention as at
    from gbnerf_tpu_torch.train.loop import banks_to_device, scene_to_device
    from gbnerf_tpu_torch.train.step import (make_train_step_stage2,
                                             select_stage2_view)

    H, W = STEP2_VIEW
    scene, depth_gts = spinnerf_scene(4, H, W, n_test=1, seed=3)
    cfg = cfg.replace(
        render=dataclasses.replace(cfg.render, perturb=0.0,
                                   raw_noise_std=0.0),
        train=dataclasses.replace(cfg.train, N_rand=STEP_RAYS,
                                  first_stage=False),
        guidance=dataclasses.replace(cfg.guidance, normal_start_iter=0,
                                     cache_masked_latents=False))
    mods_cpu = build_sd_modules(
        dataclasses.replace(cfg.guidance, perpneg=True),
        torch.Generator().manual_seed(4),
        unet_config=UNetConfig.tiny(), vae_config=VAEConfig.tiny(),
        text_config=CLIPTextConfig(vocab_size=49408, width=32, layers=2,
                                   heads=2),
        latent_size=STEP2_LATENT, dtype=torch.float32)
    banks = build_ray_banks(scene.images, scene.masks,
                            scene.inpainted_depths, scene.poses,
                            scene.hwf[2], depth_gts)
    idx = {name: torch.from_numpy(np_rng.integers(0, len(s), STEP_RAYS))
           for name, s in (("clf", banks.rgb_clf), ("inp", banks.inp),
                           ("depth", banks.depth))}
    idx["colla"] = torch.tensor([2, 0, 3, 1])
    lr = STEP2_LATENT // 8
    draws = {mod: {k: torch.from_numpy(np_rng.standard_normal(
        (b, lr, lr, 4)).astype(np.float32))
        for k in ("noise", "enc_eps", "enc_masked_eps")}
        for mod, b in (("rgb", 1), ("normal", 1), ("colla", 4))}
    draws_pn = dict(draws, rgb=dict(draws["rgb"], u=torch.from_numpy(
        np_rng.random((3, 1)).astype(np.float32))))
    rgb_only = dataclasses.replace(cfg.guidance, is_normal_guidance=False)
    out = {}
    for variant, gcfg, vdraws in (
            ("rgb+normal", cfg.guidance, draws),
            ("rgb", rgb_only, draws),
            ("colla", dataclasses.replace(rgb_only, is_colla_guidance=True),
             draws),
            ("perpneg", dataclasses.replace(rgb_only, perpneg=True),
             draws_pn)):
        if variant not in variants:
            continue
        res, before = {}, all_launches()
        for where, device in (("card", dev), ("cpu", torch.device("cpu"))):
            fields = [copy.deepcopy(f).to(device) for f in state.fields()]
            mods = dataclasses.replace(
                mods_cpu, unet=copy.deepcopy(mods_cpu.unet).to(device),
                vae=copy.deepcopy(mods_cpu.vae).to(device),
                embeds_rgb=mods_cpu.embeds_rgb.to(device),
                embeds_normal=mods_cpu.embeds_normal.to(device),
                embeds_dir={k: v.to(device)
                            for k, v in mods_cpu.embeds_dir.items()})
            step = make_train_step_stage2(
                cfg.replace(guidance=gcfg), fields[0], fields[1], scene.near,
                scene.far, scene.hwf, guidance_fn=make_guidance_fn(mods, gcfg))
            batch = select_stage2_view(
                scene_to_device(scene, banks, device),
                banks_to_device(banks, device), STEP_RAYS, img_i=1, idx=idx,
                n_colla=4 if gcfg.is_colla_guidance else 0)
            loss, m = step.loss_fn(batch, state.step, key, draws=None
                                   if key is not None else {
                mod: {k: v.to(device) for k, v in d.items()}
                for mod, d in vdraws.items()})
            loss.backward()
            res[where] = (loss.item(), m["sds_loss"].detach().item(), {
                f"{name}.{k}": p.grad.detach().cpu().double()
                for name, f in zip(("coarse", "fine"), fields)
                for k, p in f.named_parameters()})
        card_launches = {k: v - before[k] for k, v in all_launches().items()}
        (l_card, s_card, g_card), (l_cpu, s_cpu, g_cpu) = (res["card"],
                                                          res["cpu"])
        rel = abs(l_card - l_cpu) / abs(l_cpu)
        sds_rel = abs(s_card - s_cpu) / abs(s_cpu)
        cos = {k: float(torch.dot(g_card[k].ravel(), g_cpu[k].ravel())
                        / (g_card[k].norm() * g_cpu[k].norm()).clamp_min(
                            1e-300))
               for k in g_cpu}
        worst = min(cos, key=cos.get)
        tag = variant + (", jax draws" if key is not None else "")
        print(f"stage2 step vs plain [{tag}] (tiny SD at {STEP2_LATENT}², "
              f"{H}x{W} view, {STEP_RAYS} rays a stream): loss card "
              f"{l_card!r} cpu {l_cpu!r} (rel err {rel:.3e}, limit "
              f"{STEP2_LOSS_RTOL}); sds_loss card {s_card!r} cpu {s_cpu!r} "
              f"(rel err {sds_rel:.3e}, limit {STEP2_SDS_RTOL}); gradient "
              f"cosine min {cos[worst]:.6f} ({worst}, limit "
              f"{STEP2_GRAD_COS[variant]}) over {len(cos)} parameters: "
              f"{json.dumps({k: round(v, 6) for k, v in cos.items()})}; "
              f"kernel launches of the card's step "
              f"{json.dumps(card_launches)}")
        if card_launches["attention"] <= 0:
            raise AssertionError("the card's stage-2 step launched no K7")
        if (rel > STEP2_LOSS_RTOL or sds_rel > STEP2_SDS_RTOL
                or cos[worst] < STEP2_GRAD_COS[variant]):
            raise AssertionError(f"the card's stage-2 step [{tag}] "
                                 "differs from the plain path")
        out[variant] = {"loss_rel_err": rel, "sds_rel_err": sds_rel,
                        "min_grad_cos": cos[worst]}
    return out


def profile_stage1_step(cfg, dev, state, scene, depth_gts, label: str,
                        outdir: Path, step_ms: float) -> None:
    """--profile: one traced stage-1 step of ``cfg`` (the σ term on) on
    ``state``."""
    from gbnerf_tpu_torch.data.rays_bank import build_ray_banks
    from gbnerf_tpu_torch.train.loop import banks_to_device
    from gbnerf_tpu_torch.train.step import make_train_step_stage1

    tcfg = cfg.replace(train=dataclasses.replace(
        cfg.train, sigma_loss_weight=SIGMA_LOSS_WEIGHT))
    step = make_train_step_stage1(tcfg, state.coarse, state.fine, scene.near,
                                  scene.far, hwf=scene.hwf)
    banks = banks_to_device(build_ray_banks(
        scene.images, scene.masks, scene.inpainted_depths, scene.poses,
        scene.hwf[2], depth_gts), dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    profile_once(lambda: step(state, banks, gen), label, outdir, step_ms)


def profile_step(cfg, dev, out, scene, outdir: Path, label: str,
                 step_ms: float):
    """--profile: one traced stage-2 step of ``cfg`` on the state and SD
    stack of ``out`` (the masked latents zeros) → (state, scene_dev,
    banks_dev, generator) for more timings."""
    from gbnerf_tpu_torch.data.rays_bank import build_ray_banks
    from gbnerf_tpu_torch.guidance import make_guidance_fn
    from gbnerf_tpu_torch.train.loop import banks_to_device, scene_to_device
    from gbnerf_tpu_torch.train.step import make_train_step_stage2

    state, mods = out["state"], out["guidance"]
    banks = build_ray_banks(scene.images, scene.masks, scene.inpainted_depths,
                            scene.poses, scene.hwf[2])
    scene_dev = scene_to_device(scene, banks, dev)
    gen = torch.Generator(device=dev).manual_seed(12)
    scene_dev["masked_latents"] = torch.zeros(
        (len(scene.images), mods.latent_res, mods.latent_res, 4),
        dtype=torch.bfloat16, device=dev)
    banks_dev = banks_to_device(banks, dev)
    step = make_train_step_stage2(
        cfg, state.coarse, state.fine, scene.near, scene.far, scene.hwf,
        guidance_fn=make_guidance_fn(mods, cfg.guidance))
    profile_once(lambda: step(state, scene_dev, banks_dev, gen),
                 f"{label}_step", outdir, step_ms)
    return state, scene_dev, banks_dev, gen


def profile_stage2(cfg, dev, out, scene, outdir: Path, step_ms: float):
    """--profile: one traced stage-2 step, and the step's parts timed alone
    with CUDA events: the UNet forward (2 CFG copies, per modality), the
    VAE encode of a 512² render with its backward, and the NeRF renders of
    the step with their backward (guidance replaced by a stub that keeps
    the masked and normal-map renders)."""
    from gbnerf_tpu_torch.train.step import make_train_step_stage2

    mods = out["guidance"]
    state, scene_dev, banks_dev, gen = profile_step(
        cfg, dev, out, scene, outdir, "stage2", step_ms)

    lr = mods.latent_res
    unet_in = torch.randn((2, lr, lr, 9), generator=gen, device=dev)
    with torch.no_grad():
        unet_ms = cuda_ms(lambda: mods.unet(unet_in, 500,
                                            mods.embeds_rgb[1:]), reps=5)
    img = torch.rand((1, mods.latent_size, mods.latent_size, 3),
                     generator=gen, device=dev, requires_grad=True)
    eps = torch.randn((1, lr, lr, 4), generator=gen, device=dev)

    def vae_fb():
        z = mods.vae.encode(img * 2 - 1, eps)
        torch.autograd.grad(z.float().sum(), img)

    vae_ms = cuda_ms(vae_fb, reps=5)

    def stub(step_i, combin, normal_map, mask, generator=None, **kw):
        return (combin.sum() + normal_map.sum()) * 0.0

    rstep = make_train_step_stage2(cfg, state.coarse, state.fine, scene.near,
                                   scene.far, scene.hwf, guidance_fn=stub)
    render_ms = cuda_ms(lambda: rstep(state, scene_dev, banks_dev, gen),
                        reps=5)
    # per step: one UNet forward and one differentiated VAE encode per
    # modality (RGB, normal), and the normal modality's masked encode
    # (no gradient) — counted here as a second differentiated one
    parts = {"unet_forward": 2 * unet_ms, "vae_encode_fwd_bwd": 3 * vae_ms,
             "renders_fwd_bwd": render_ms}
    print(f"profile stage2 parts (ms, alone): UNet forward {unet_ms:.3f} ×2, "
          f"VAE encode+backward {vae_ms:.3f} ×3 (one of them forward only), "
          f"renders+backward {render_ms:.3f}; shares of the {step_ms:.3f} ms "
          f"step: " + ", ".join(f"{k} {v / step_ms:.3f}"
                                for k, v in parts.items()))


def stage1_train(cfg, dev, scene, depth_gts, workdir: Path, *,
                 expname: str = "stage1", label: str = "train",
                 step_kernels=("field_fused", "merge128", "field_fused_bwd",
                               "field_fused_sigma", "field_fused_bwd_sigma"),
                 eval_kernels=("field_fused", "field_fused_sigma",
                               "merge128")):
    """Stage 1 through train(): TRAIN_STEPS steps, a checkpoint half way and
    at the end (the last restored into a fresh state and compared), one
    eval render of the held-out views; the steps must launch
    ``step_kernels`` and the eval ``eval_kernels``. → (out, ms per step,
    launches of the steps, launches of the eval)."""
    from gbnerf_tpu_torch.train.checkpoint import CheckpointManager
    from gbnerf_tpu_torch.train.loop import train
    from gbnerf_tpu_torch.train.state import create_train_state

    never = 10 ** 9
    cfg = cfg.replace(train=dataclasses.replace(
        cfg.train, first_stage=True, N_iters=TRAIN_STEPS,
        i_print=TRAIN_PRINT, i_weights=TRAIN_STEPS // 2,
        i_evaluate=TRAIN_STEPS, i_testset=never, i_video=never,
        basedir=str(workdir), expname=expname, no_reload=True,
        sigma_loss_weight=SIGMA_LOSS_WEIGHT))
    group_ms, at_last_step = [], {}

    def log_fn(i, m):
        print(f"{label}: [{i}/{TRAIN_STEPS}] " + " ".join(
            f"{k}={v:.5g}" for k, v in m.items()))
        bad = [k for k, v in m.items() if not np.isfinite(v)]
        if bad:
            raise AssertionError(f"non-finite train metrics at {i}: {bad}")
        group_ms.append(1e3 / m["iters_per_sec"])
        if i == TRAIN_STEPS:      # before the eval render of this iteration
            at_last_step.update(all_launches())

    # ---- the stage-1 main path: launches counted from here ...
    zero_launches()
    out = train(cfg, scene=scene, depth_gts=depth_gts, device=dev,
                log_fn=log_fn)
    torch.cuda.synchronize()
    total = all_launches()
    # ... to here
    if not at_last_step:
        raise AssertionError(f"no finite metrics at step {TRAIN_STEPS}: "
                             "the run diverged or stopped early")
    step_launches = at_last_step
    eval_launches = {k: total[k] - step_launches[k] for k in total}
    print(f"{label}: launches by the {TRAIN_STEPS} steps "
          f"{json.dumps(step_launches)}, by the eval "
          f"{json.dumps(eval_launches)}")
    for k in step_kernels:
        if step_launches[k] <= 0:
            raise AssertionError(f"kernel {k} was not launched by the steps")
    for k in eval_kernels:
        if eval_launches[k] <= 0:
            raise AssertionError(f"kernel {k} was not launched by the eval")

    hist = [m["img_loss"] for _, m in out["history"]]
    if not hist[-1] < hist[0]:
        raise AssertionError(f"img_loss did not fall: {hist}")
    exp = workdir / expname
    ckpt = CheckpointManager(str(exp / "ckpt"))
    if ckpt.steps() != [TRAIN_STEPS // 2, TRAIN_STEPS]:
        raise AssertionError(f"checkpoints {ckpt.steps()}")
    fresh, _, _ = create_train_state(cfg, torch.Generator().manual_seed(9),
                                     dev)
    ckpt.restore(fresh)
    state = out["state"]
    same = fresh.step == state.step == TRAIN_STEPS and all(
        torch.equal(a, b) for f, g in zip(fresh.fields(), state.fields())
        for a, b in zip(f.state_dict().values(), g.state_dict().values()))
    if not same:
        raise AssertionError("the restored checkpoint differs from the state")
    last = json.loads((exp / "metrics.jsonl").read_text().splitlines()[-1])
    maps = {k: np.load(exp / f"eval_images_{TRAIN_STEPS}" / f"{k}.npy")
            for k in ("rgb", "disp", "depth", "acc")}
    if not (np.isfinite(last.get("eval_psnr", np.nan))
            and all(np.isfinite(v).all() for v in maps.values())):
        raise AssertionError(f"eval render not finite: {last}")
    ms = float(np.median(group_ms))
    print(f"{label}: {TRAIN_STEPS} steps, 3 × {cfg.train.N_rand} rays a step, "
          f"{cfg.render.N_samples}+{cfg.render.N_importance} samples: "
          f"{ms:.3f} ms per step (median of {len(group_ms)} groups of "
          f"{TRAIN_PRINT}: {', '.join(f'{g:.3f}' for g in group_ms)}), "
          f"{1e3 / ms:.2f} steps/s; img_loss {hist[0]:.5f} → {hist[-1]:.5f}; "
          f"checkpoint restored equal; eval PSNR {last['eval_psnr']:.3f} dB "
          f"on {len(scene.poses_test)} held-out views")
    return out, ms, step_launches, eval_launches


def frozen_sigma_phase(cfg, dev, scene, depth_gts, workdir: Path) -> dict:
    """Stage 1 through train() for FROZEN_STEPS steps with alpha_model_path
    at the stage-1 phase's checkpoints: σ from that run's fine field (K2,
    σ-only, no gradient), the colour from fresh fields (K1, and K4 with a
    zero σ cotangent). Checks that σ of the frozen field along a batch of
    rays is bit-equal to the alpha field's own σ-only call, and that the σ
    column of each field's ws1 (the σ-net's output weight, which feeds σ
    alone) is bit-equal before and after while the rest trained."""
    from gbnerf_tpu_torch.core.fields import (make_field_fn,
                                              make_frozen_sigma_field_fn)
    from gbnerf_tpu_torch.train.loop import load_alpha_model, train
    from gbnerf_tpu_torch.train.state import create_train_state

    never = 10 ** 9
    cfg = cfg.replace(
        field=dataclasses.replace(
            cfg.field, alpha_model_path=str(workdir / "stage1" / "ckpt")),
        train=dataclasses.replace(
            cfg.train, first_stage=True, N_iters=FROZEN_STEPS,
            i_print=FROZEN_PRINT, i_weights=never, i_evaluate=never,
            i_testset=never, i_video=never, basedir=str(workdir),
            expname="frozen", no_reload=True,
            sigma_loss_weight=SIGMA_LOSS_WEIGHT))
    # train() draws the initial fields from a CPU generator seeded with
    # train.seed: the same draw here gives the state before the steps
    init, _, _ = create_train_state(
        cfg, torch.Generator().manual_seed(cfg.train.seed), dev)
    group_ms = []

    def log_fn(i, m):
        print(f"frozen: [{i}/{FROZEN_STEPS}] " + " ".join(
            f"{k}={v:.5g}" for k, v in m.items()))
        if not all(np.isfinite(v) for v in m.values()):
            raise AssertionError(f"non-finite frozen-σ metrics at {i}")
        group_ms.append(1e3 / m["iters_per_sec"])

    # ---- the frozen-σ main path: launches counted from here ...
    zero_launches()
    out = train(cfg, scene=scene, depth_gts=depth_gts, device=dev,
                log_fn=log_fn)
    torch.cuda.synchronize()
    launches = all_launches()
    # ... to here
    print(f"frozen: launches {json.dumps(launches)}")
    for k in ("field_fused", "field_fused_sigma", "merge128",
              "field_fused_bwd"):
        if launches[k] <= 0:
            raise AssertionError(f"kernel {k} was not launched by the "
                                 "frozen-σ steps")
    state = out["state"]
    kept = {name: torch.equal(a.ws1[:, 0], b.ws1[:, 0])
            for name, a, b in zip(("coarse", "fine"), init.fields(),
                                  state.fields())}
    moved = {name: not torch.equal(a.ws1[:, 1:], b.ws1[:, 1:])
             and not torch.equal(a.wc2, b.wc2)
             for name, a, b in zip(("coarse", "fine"), init.fields(),
                                   state.fields())}

    alpha = load_alpha_model(cfg, dev)
    g = torch.Generator(device=dev).manual_seed(13)
    n = FROZEN_SIGMA_RAYS
    ro = torch.randn((n, 3), generator=g, device=dev) * 0.1
    rd = torch.nn.functional.normalize(
        torch.randn((n, 3), generator=g, device=dev), dim=-1)
    z = torch.linspace(scene.near, scene.far, cfg.render.N_samples,
                       device=dev)
    pts = ro[:, None] + rd[:, None] * z[:, None]
    with torch.no_grad():
        frozen = make_frozen_sigma_field_fn(make_field_fn(state.fine),
                                            make_field_fn(alpha))
        sigma = frozen(pts, rd)[..., 3]
        sigma_alpha = make_field_fn(alpha)(pts, rd, sigma_only=True)[..., 3]
    bit_equal = torch.equal(sigma, sigma_alpha)
    ms = float(np.median(group_ms[1:] or group_ms))
    print(f"frozen: {FROZEN_STEPS} stage-1 steps with alpha_model_path (σ "
          f"from the stage-1 run's fine field): {ms:.3f} ms per step "
          f"(median of the groups of {FROZEN_PRINT} after the first: "
          f"{', '.join(f'{x:.3f}' for x in group_ms)}); σ of {n} rays × "
          f"{cfg.render.N_samples} points bit-equal to the alpha field's: "
          f"{bit_equal}; ws1's σ column unchanged {json.dumps(kept)}, the "
          f"rest trained {json.dumps(moved)}")
    if not (bit_equal and all(kept.values()) and all(moved.values())):
        raise AssertionError("the frozen-σ run changed σ or its parameters, "
                             "or trained nothing")
    return {"ms": ms, "launches": launches}


def check_clip(dev) -> dict:
    """CLIPGuidance at the ViT-B/16 size (the text tower ViT-L/14's): the
    loss and its gradient with respect to a 189 × 252 image on the card
    against the CPU, the same towers and projection."""
    from gbnerf_tpu_torch.guidance.clip_guidance import CLIPGuidance

    cpu = CLIPGuidance("a stone park bench",
                       torch.Generator().manual_seed(14))
    card = copy.copy(cpu)
    card.vision = copy.deepcopy(cpu.vision).to(dev)
    card.text_embed = cpu.text_embed.to(dev)
    img = torch.rand((VIEW_H, VIEW_W, 3),
                     generator=torch.Generator().manual_seed(15))
    res = {}
    for where, g, dv in (("card", card, dev), ("cpu", cpu, "cpu")):
        x = img.to(dv).clone().requires_grad_(True)
        loss = g.loss(x, 1.0)
        loss.backward()
        res[where] = (loss.item(), x.grad.cpu().double())
    (l_card, g_card), (l_cpu, g_cpu) = res["card"], res["cpu"]
    rel = abs(l_card - l_cpu) / abs(l_cpu)
    gerr = float((g_card - g_cpu).abs().max() / g_cpu.abs().max())
    t0 = time.perf_counter()
    x = img.to(dev).requires_grad_(True)
    for _ in range(5):
        card.loss(x, 1.0).backward()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / 5
    r = {"loss_card": l_card, "loss_cpu": l_cpu, "loss_rel_err": rel,
         "grad_err_over_max": gerr, "ms_fwd_bwd": ms,
         "limits": [CLIP_LOSS_RTOL, CLIP_GRAD_ATOL_FRAC]}
    print(f"check clip (ViT-B/16 vision, ViT-L/14 text, {VIEW_H}x{VIEW_W} "
          f"image): {json.dumps(r)}")
    if rel > CLIP_LOSS_RTOL or gerr > CLIP_GRAD_ATOL_FRAC:
        raise AssertionError("CLIP guidance on the card differs from the CPU")
    return r


def step_vs_plain(cfg, dev, state, scene, depth_gts, label: str = "step",
                  f64: bool = False):
    """One stage-1 loss and gradient on the card vs the CPU plain path, on
    the same weights and injected batch indices, STEP_RAYS rays a stream:
    the loss to STEP_LOSS_RTOL, every parameter's gradient (the hash
    field's table too) to cosine STEP_GRAD_COS. f64: both sides run the
    fields, the rays and the render in float64 (K3 merges the f32-rounded
    depths, the hash encode's cell arithmetic stays f32, on both sides)."""
    from gbnerf_tpu_torch.data.rays_bank import build_ray_banks, sample_batch
    from gbnerf_tpu_torch.train.loop import banks_to_device
    from gbnerf_tpu_torch.train.step import make_train_step_stage1

    cfg = cfg.replace(
        render=dataclasses.replace(cfg.render, perturb=0.0,
                                   raw_noise_std=0.0),
        train=dataclasses.replace(cfg.train, N_rand=STEP_RAYS,
                                  sigma_loss_weight=SIGMA_LOSS_WEIGHT))
    banks = build_ray_banks(scene.images, scene.masks,
                            scene.inpainted_depths, scene.poses,
                            scene.hwf[2], depth_gts)
    rng = np.random.default_rng(2)
    idx = {name: torch.from_numpy(rng.integers(0, len(s), STEP_RAYS))
           for name, s in (("rgb_clf", banks.rgb_clf), ("inp", banks.inp),
                           ("depth", banks.depth))}
    res, before = {}, all_launches()
    for where, device in (("card", dev), ("cpu", torch.device("cpu"))):
        fields = [copy.deepcopy(f).to(device) for f in state.fields()]
        for f in fields:
            if f64:
                f.double().compute_dtype = torch.float64
            for p in f.parameters():
                p.grad = None
        step = make_train_step_stage1(cfg, fields[0], fields[1], scene.near,
                                      scene.far, hwf=scene.hwf)
        bank = banks_to_device(banks, device)
        batches = {key: sample_batch(bank[name], STEP_RAYS, idx=idx[name])
                   for key, name in (("clf", "rgb_clf"), ("inp", "inp"),
                                     ("depth", "depth"))}
        if f64:
            batches = {k: {kk: vv.double() for kk, vv in b.items()}
                       for k, b in batches.items()}
        loss, _ = step.loss_fn(batches)
        loss.backward()
        res[where] = (loss.item(), {
            f"{name}.{k}": p.grad.detach().cpu().double()
            for name, f in zip(("coarse", "fine"), fields)
            for k, p in f.named_parameters()})
    card_launches = {k: v - before[k] for k, v in all_launches().items()}
    (l_card, g_card), (l_cpu, g_cpu) = res["card"], res["cpu"]
    rel = abs(l_card - l_cpu) / abs(l_cpu)
    cos = {k: float(torch.dot(g_card[k].ravel(), g_cpu[k].ravel())
                    / (g_card[k].norm() * g_cpu[k].norm()).clamp_min(1e-300))
           for k in g_cpu}
    worst = min(cos, key=cos.get)
    print(f"{label} vs plain ({STEP_RAYS} rays a stream"
          f"{', float64' if f64 else ''}): loss card {l_card!r}"
          f" cpu {l_cpu!r} (rel err {rel:.3e}, limit {STEP_LOSS_RTOL}); "
          f"gradient cosine min {cos[worst]:.6f} ({worst}, limit "
          f"{STEP_GRAD_COS}) over {len(cos)} parameters; kernel launches "
          f"of the card's step {json.dumps(card_launches)}")
    if rel > STEP_LOSS_RTOL or cos[worst] < STEP_GRAD_COS:
        raise AssertionError(f"the card's step differs from the plain path: "
                             f"{json.dumps(cos)}")
    return {"loss_rel_err": rel, "min_grad_cos": cos[worst]}


def stage1_step_twice(cfg, dev, state, scene, depth_gts,
                      kernel: str = "field_fused_bwd", label: str = "stage1"):
    """One full-width stage-1 step (N_rand rays a stream, the σ term on),
    run twice from the same trained state and the same injected batch,
    perturb and σ noise off: K4/K5 (the hash field: the gather's sorted
    backward) sum in a fixed order, so the parameters and Adam moments
    after the two steps must be bit-equal; the step must launch
    ``kernel``."""
    from gbnerf_tpu_torch.data.rays_bank import build_ray_banks
    from gbnerf_tpu_torch.train.loop import banks_to_device
    from gbnerf_tpu_torch.train.state import create_train_state
    from gbnerf_tpu_torch.train.step import make_train_step_stage1

    cfg = cfg.replace(
        render=dataclasses.replace(cfg.render, perturb=0.0,
                                   raw_noise_std=0.0),
        train=dataclasses.replace(cfg.train,
                                  sigma_loss_weight=SIGMA_LOSS_WEIGHT))
    host = build_ray_banks(scene.images, scene.masks, scene.inpainted_depths,
                           scene.poses, scene.hwf[2], depth_gts)
    banks = banks_to_device(host, dev)
    rng = np.random.default_rng(4)
    idx = {key: torch.from_numpy(rng.integers(0, len(s), cfg.train.N_rand))
           for key, s in (("clf", host.rgb_clf), ("inp", host.inp),
                          ("depth", host.depth))}
    before = all_launches()
    after = []
    for _ in range(2):
        run, _, _ = create_train_state(cfg, torch.Generator().manual_seed(9),
                                       dev)
        run.load_state_dict(copy.deepcopy(state.state_dict()))
        step = make_train_step_stage1(cfg, run.coarse, run.fine, scene.near,
                                      scene.far, hwf=scene.hwf)
        step(run, banks, torch.Generator(device=dev).manual_seed(3), idx=idx)
        torch.cuda.synchronize()
        tensors = {f"{name}.{k}": p.detach().clone()
                   for name, f in zip(("coarse", "fine"), run.fields())
                   for k, p in f.named_parameters()}
        for i, st in run.optimizer.state_dict()["state"].items():
            tensors.update({f"adam.{i}.{k}": v.clone() for k, v in st.items()
                            if torch.is_tensor(v)})
        after.append(tensors)
    launches = {k: v - before[k] for k, v in all_launches().items()}
    differ = [k for k in after[0] if not torch.equal(after[0][k], after[1][k])]
    moved = sum(not torch.equal(after[0][k], p.detach())
                for k, p in ((f"{name}.{n}", q) for name, f in
                             zip(("coarse", "fine"), state.fields())
                             for n, q in f.named_parameters()))
    r = {"rays_a_stream": cfg.train.N_rand, "tensors": len(after[0]),
         "parameters_moved": moved, "deterministic": not differ,
         "launches": launches}
    print(f"{label} step twice {json.dumps(r)}")
    if differ or launches[kernel] <= 0 or moved == 0:
        raise AssertionError(f"two {label} steps from one state differ in "
                             f"{differ[:8]} (or launched no {kernel}, or "
                             "moved nothing)")
    return r


def cp_operands(n: int, r_max: int, feat: int, np_rng):
    """x01 [n, 3] (the corners 0 and 1, points past them and 4096 points on
    grid nodes first, then uniform) and unified lines [3, R_max, F]."""
    x = np_rng.random((n, 3), dtype=np.float32)
    x[0], x[1], x[2] = 0.0, 1.0, (-0.25, 1.5, 0.5)
    x[3:3 + 4096] = np_rng.integers(0, r_max, (4096, 3)) / (r_max - 1)
    ul = np_rng.standard_normal((3, r_max, feat), dtype=np.float32) * 0.1
    return torch.from_numpy(x), torch.from_numpy(ul)


def check_cp_encode(dev, np_rng):
    """K6 against its plain version at CP_CASES, times at the non-ragged
    shapes; then the gradient of cp_encode_unified, card vs CPU."""
    from gbnerf_tpu_torch.ops import cp_pallas as cp

    results = []
    for label, n, r_max, feat in CP_CASES:
        x, ul = (t.to(dev) for t in cp_operands(n, r_max, feat, np_rng))
        with torch.no_grad():
            got = cp.encode_kernel(x, ul, r_max)
            ref = cp.encode_plain(x, ul, r_max)
        torch.cuda.synchronize()
        r = {"shape": label, "points": n, "R_max": r_max, "F": feat,
             "max_abs_err": float((got - ref).abs().max()),
             "bit_equal": bool(torch.equal(got, ref)),
             "atol": CP_ATOL_FRAC * float(ref.abs().max()),
             "finite": bool(torch.isfinite(got).all())}
        del got, ref
        if label != "ragged":
            r["ms"] = cuda_ms(lambda: cp.encode_kernel(x, ul, r_max), reps=20)
            # the device alone, as K1–K5 and K7 are timed beside events
            r["graph_ms"] = graph_ms(lambda: cp.encode_kernel(x, ul, r_max),
                                     reps=10)
            r["plain_ms"] = cuda_ms(lambda: cp.encode_plain(x, ul, r_max),
                                    reps=3)
            r.update(kernel_bound("cp_encode", r))
        print(f"check cp_encode [{label}] {json.dumps(r)}")
        if r["max_abs_err"] > r["atol"] or not r["finite"]:
            raise AssertionError(f"cp_encode [{label}]: differs from the "
                                 f"plain version by {r['max_abs_err']}")
        results.append(r)

    # a NaN coordinate gives a row of NaN features, as the plain version's
    # clip and maximum make it; the other rows stay bit-equal
    x, ul = (t.to(dev) for t in cp_operands(4099, 257, 80, np_rng))
    x[7, 0] = x[100, 2] = float("nan")
    with torch.no_grad():
        got, ref = cp.encode_kernel(x, ul, 257), cp.encode_plain(x, ul, 257)
    r = {"points": 4099, "nan_points": 2,
         "nan_rows": int(got.isnan().all(dim=1).sum()),
         "nan_where_plain": bool(torch.equal(got.isnan(), ref.isnan())),
         "rest_bit_equal": bool(torch.equal(got.nan_to_num(0.0),
                                            ref.nan_to_num(0.0)))}
    print(f"check cp_encode [nan] {json.dumps(r)}")
    if r["nan_rows"] != 2 or not (r["nan_where_plain"]
                                  and r["rest_bit_equal"]):
        raise AssertionError("cp_encode: a NaN point differs from the plain "
                             "version")

    x, ul = cp_operands(CP_GRAD_POINTS, 257, 80, np_rng)
    g = torch.from_numpy(np_rng.standard_normal((CP_GRAD_POINTS, 80),
                                                dtype=np.float32))
    res = {}
    for where, device in (("card", dev), ("cpu", torch.device("cpu"))):
        xd = x.to(device).requires_grad_(True)
        ld = ul.to(device).requires_grad_(True)
        out = cp.cp_encode_unified(xd, ld, 257)
        dx, dl = torch.autograd.grad(out, (xd, ld), g.to(device))
        res[where] = [t.detach().cpu() for t in (out, dx, dl)]
    r = {"points": CP_GRAD_POINTS,
         "out_bit_equal": bool(torch.equal(res["card"][0], res["cpu"][0]))}
    for name, a, b in zip(("dx", "dlines"), res["card"][1:], res["cpu"][1:]):
        r[name] = compare_field(a, b, rtol=CP_GRAD_RTOL,
                                atol_frac=CP_GRAD_ATOL_FRAC)
    print(f"check cp_encode gradient (card vs cpu) {json.dumps(r)}")
    if not r["out_bit_equal"] or r["dx"]["n_out_of_tol"] or \
            r["dlines"]["n_out_of_tol"]:
        raise AssertionError("cp_encode_unified's gradient on the card "
                             "differs from the CPU plain path")
    return results


def check_lpips(dev) -> dict:
    """LPIPS (random VGG, the same seeded weights) on the card against the
    CPU: the distance and its input gradient on LPIPS_SHAPE patches."""
    from gbnerf_tpu_torch.utils.lpips import LPIPS

    gen = torch.Generator().manual_seed(21)
    a, b = (torch.rand(LPIPS_SHAPE, generator=gen) for _ in range(2))
    res = {}
    for where, device in (("card", dev), ("cpu", torch.device("cpu"))):
        fn = LPIPS(torch.Generator().manual_seed(3), device=device)
        ta = a.to(device).requires_grad_(True)
        tb = b.to(device)
        d = fn(ta, tb)
        (g,) = torch.autograd.grad(d.sum(), ta)
        res[where] = (d.detach().cpu().double(), g.cpu().double())
        if where == "card":
            def fwd_bwd():
                torch.autograd.grad(fn(ta, tb).sum(), ta)

            ms = cuda_ms(fwd_bwd, reps=10)
    (d_card, g_card), (d_cpu, g_cpu) = res["card"], res["cpu"]
    r = {"patches": list(LPIPS_SHAPE),
         "distance_max_rel_err": float(((d_card - d_cpu).abs()
                                        / d_cpu.abs()).max()),
         "grad_max_abs_err": float((g_card - g_cpu).abs().max()),
         "grad_atol": LPIPS_GRAD_ATOL_FRAC * float(g_cpu.abs().max()),
         "distance_rtol": LPIPS_RTOL, "fwd_bwd_ms": ms,
         "distance": [float(x) for x in d_cpu]}
    print(f"check lpips (card vs cpu) {json.dumps(r)}")
    if (r["distance_max_rel_err"] > LPIPS_RTOL
            or r["grad_max_abs_err"] > r["grad_atol"]
            or not torch.isfinite(g_card).all()):
        raise AssertionError("LPIPS on the card differs from the CPU")
    return r


def _disk_train(cfg, dev, label: str, total: int, every: int):
    """train() on cfg (the scene loaded from disk by train itself), its
    own launch counts → (out, ms per step, launches)."""
    from gbnerf_tpu_torch.train.loop import train

    group_ms = []

    def log_fn(i, m):
        print(f"disk {label}: [{i}/{total}] " + " ".join(
            f"{k}={v:.5g}" for k, v in m.items()))
        bad = [k for k, v in m.items() if not np.isfinite(v)]
        if bad:
            raise AssertionError(f"non-finite {label} metrics at {i}: {bad}")
        group_ms.append(1e3 / m["iters_per_sec"])

    # ---- the disk phase's main path: launches counted from here ...
    zero_launches()
    out = train(cfg, device=dev, log_fn=log_fn)
    torch.cuda.synchronize()
    launches = all_launches()
    # ... to here
    if out["state"].step != total or not group_ms:
        raise AssertionError(f"disk {label} stopped at {out['state'].step}")
    return out, float(np.median(group_ms)), group_ms, launches


def abl_args(iters2: int, n_test: int):
    """The ablation twin's round-5 command line (--production --colmap
    --lindisp --combine sds) at the disk phase's sizes."""
    from gbnerf_tpu_torch.tools import run_ablation

    return run_ablation.parse_args([
        "OUT", "--production", "--colmap", "--lindisp", "--combine", "sds",
        "--iters1", str(DISK_S1_STEPS), "--iters2", str(iters2),
        "--n_test", str(n_test), "--latent", "256", "--lora_steps",
        str(LORA_TINY_STEPS)])


def disk_phase(dev, workdir: Path) -> dict:
    """The round-5 ablation scene written to disk by the synthetic-scene
    twin at full size, read back by load_scene with imageio and cv2
    blocked (the PNG codec), then s1 and nog from the ablation twin's
    configs through train(), which loads the scene itself."""
    import shutil

    from gbnerf_tpu_torch.config import load_reference_config
    from gbnerf_tpu_torch.tools import make_synthetic_scene, run_ablation
    from gbnerf_tpu_torch.train.loop import load_scene
    from gbnerf_tpu_torch.utils.metrics import to8b
    from gbnerf_tpu_torch.utils.png import read_png

    n_train, n_test = DISK_VIEWS
    blocked = {m: sys.modules.get(m) for m in ("imageio", "cv2")}
    sys.modules.update({m: None for m in blocked})   # the card's machine
    try:
        t0 = time.perf_counter()
        written = make_synthetic_scene.main([
            str(workdir / "scene"), "--task", "inpaint", "--H", str(VIEW_H),
            "--W", str(VIEW_W), "--n_train", str(n_train), "--n_test",
            str(n_test), "--seed", "0", "--colmap_sparse"])
        write_s = time.perf_counter() - t0
        paths = run_ablation.write_configs(str(workdir), abl_args(
            DISK_NOG_STEPS, n_test))
        never = 10 ** 9

        def cfg_of(arm, every):
            cfg = load_reference_config(paths[arm])
            return cfg.replace(train=dataclasses.replace(
                cfg.train, i_print=every, i_weights=never))

        s1_cfg = cfg_of("s1", DISK_S1_PRINT)
        nog_cfg = cfg_of("nog", DISK_NOG_PRINT)
        t0 = time.perf_counter()
        scene = load_scene(s1_cfg)
        decode_s = time.perf_counter() - t0

        def stack(fmt, ks):
            return np.stack([written[f"images_4/{fmt.format(k)}"]
                             for k in ks]).astype(np.float32) / 255.0

        train_ks = range(n_test, n_test + n_train)
        same = {
            "images": np.array_equal(
                scene.images, stack("RGB_inpainted/img_{:03d}.png",
                                    train_ks)),
            "masks": np.array_equal(
                scene.masks, stack("label/img_{:03d}.png", train_ks)),
            "images_test": np.array_equal(
                scene.images_test, stack("test_gt/img_{:03d}.png",
                                         range(n_test))),
            "masks_test": np.array_equal(
                scene.masks_test, stack("test_gt/mask_{:03d}.png",
                                        range(n_test)))}
        n_px = sum(a.shape[0] * a.shape[1] for a in written.values())
        print(f"disk: scene of {n_train} + {n_test} views at {VIEW_H}x"
              f"{VIEW_W} written in {write_s:.3f} s ({len(written)} PNGs); "
              f"load_scene (PNG codec, imageio and cv2 blocked) "
              f"{decode_s:.3f} s for {n_px} pixels; equal to the arrays "
              f"written: {json.dumps(same)}")
        if not all(same.values()):
            raise AssertionError(f"the scene read back differs: {same}")

        s1, s1_ms, s1_groups, s1_launches = _disk_train(
            s1_cfg, dev, "s1", DISK_S1_STEPS, DISK_S1_PRINT)
        s1_eval = s1["last_eval"]
        nog_dir = workdir / "logs" / "nog"
        nog_dir.mkdir(parents=True)
        shutil.copytree(workdir / "logs" / "s1" / "ckpt", nog_dir / "ckpt")
        total = DISK_S1_STEPS + DISK_NOG_STEPS
        nog, nog_ms, nog_groups, nog_launches = _disk_train(
            nog_cfg, dev, "nog", total, DISK_NOG_PRINT)
    finally:
        for m, mod in blocked.items():
            if mod is None:
                sys.modules.pop(m, None)
            else:
                sys.modules[m] = mod
    nog_eval = nog["last_eval"]
    hist = [m for _, m in nog["history"]]
    if not all(m["lpips_loss"] > 0 and m["sds_loss"] == 0 for m in hist):
        raise AssertionError(f"nog: lpips_loss / sds_loss {hist}")
    for label, launches in (("s1", s1_launches), ("nog", nog_launches)):
        for k in ("field_fused", "field_fused_sigma", "merge128",
                  "field_fused_bwd"):
            if launches[k] <= 0:
                raise AssertionError(f"kernel {k} was not launched by disk "
                                     f"{label}")
    evdir = nog_dir / f"eval_images_{total}"
    rgb = np.load(evdir / "rgb.npy")
    pngs = sorted((evdir / "rgb").glob("*.png"))
    if len(pngs) != n_test or not all(
            np.array_equal(read_png(str(p)), to8b(rgb[k]))
            for k, p in enumerate(pngs)):
        raise AssertionError(f"eval PNGs under {evdir} differ from the maps")
    for label, ev in (("s1", s1_eval), ("nog", nog_eval)):
        if not (ev and all(np.isfinite(ev[f"eval_{k}"]) for k in
                           ("psnr", "psnr_masked", "psnr_unmasked"))):
            raise AssertionError(f"disk {label}: eval {ev}")
    print(f"disk s1: {DISK_S1_STEPS} steps from the disk scene: {s1_ms:.3f} "
          f"ms per step (median of {len(s1_groups)} groups of "
          f"{DISK_S1_PRINT}); launches {json.dumps(s1_launches)}; eval "
          f"{json.dumps(s1_eval)}")
    print(f"disk nog: {DISK_NOG_STEPS} steps from s1's checkpoint (LPIPS "
          f"patches {nog_cfg.train.n_patches} x {nog_cfg.train.patch_len}², "
          f"random VGG, gradient_clip {nog_cfg.train.gradient_clip}, no "
          f"guidance): {nog_ms:.3f} ms per step (median of "
          f"{len(nog_groups)} groups of {DISK_NOG_PRINT}: "
          f"{', '.join(f'{g:.3f}' for g in nog_groups)}); launches "
          f"{json.dumps(nog_launches)}; eval {json.dumps(nog_eval)}; "
          f"{len(pngs)} eval PNGs equal to8b of the maps")
    launches = {k: s1_launches[k] + nog_launches[k] for k in s1_launches}
    return {"launches": launches, "nog": nog, "nog_cfg": nog_cfg,
            "nog_ms": nog_ms, "datadir": str(workdir / "scene")}


def _blender_view(k: int, split: str, theta: float, phi: float, out: Path,
                  with_mask: bool) -> np.ndarray:
    """One Blender-layout view: the synthetic sphere rendered by the twin's
    render_scene at BLENDER_SIZE², alpha = hit_id >= 0, written as an RGBA
    PNG by the port's codec; with_mask also writes mask/m_k.png, the
    dilated silhouette of the twin's intruder sphere. → the RGBA array."""
    from gbnerf_tpu_torch.data.blender import pose_spherical
    from gbnerf_tpu_torch.utils.png import write_png

    syn = synthetic_tool()
    n = BLENDER_SIZE
    focal = 0.5 * n / np.tan(0.5 * BLENDER_ANGLE_X)
    c2w = pose_spherical(theta, phi, BLENDER_RADIUS)[:3, :4]
    img, _, hit = syn.render_scene(n, n, focal, c2w)
    rgba = np.concatenate([(np.clip(img, 0, 1) * 255).astype(np.uint8),
                           ((hit >= 0) * 255).astype(np.uint8)[..., None]], -1)
    write_png(str(out / split / f"r_{k}.png"), rgba)
    if with_mask:
        _, _, hit_i = syn.render_scene(n, n, focal, c2w, (syn.INTRUDER,))
        mask = syn.dilate(hit_i == 0, it=2)
        write_png(str(out / split / "mask" / f"m_{k}.png"),
                  (mask * 255).astype(np.uint8))
    return rgba


def write_blender_scene(out: Path, seed: int = 0) -> dict:
    """nerf_synthetic's layout (transforms_{train,val,test}.json with
    camera_angle_x and c2w from pose_spherical, r_k.png RGBA) with mask/
    companions for the train views; the views rendered on a thread pool.
    → {split: [RGBA arrays]} of the views loaded with testskip."""
    from concurrent.futures import ThreadPoolExecutor

    from gbnerf_tpu_torch.data.blender import pose_spherical

    rng = np.random.default_rng(seed)
    jobs, metas = [], {}
    for split, n in zip(("train", "val", "test"), BLENDER_VIEWS):
        (out / split / "mask").mkdir(parents=True, exist_ok=True)
        frames = []
        for k in range(n):
            theta = float(rng.uniform(-180.0, 180.0))
            phi = float(rng.uniform(-70.0, -10.0))
            frames.append({"file_path": f"./{split}/r_{k}",
                           "transform_matrix": pose_spherical(
                               theta, phi, BLENDER_RADIUS).tolist()})
            jobs.append((k, split, theta, phi, split == "train"))
        metas[split] = {"camera_angle_x": BLENDER_ANGLE_X, "frames": frames}
        (out / f"transforms_{split}.json").write_text(
            json.dumps(metas[split]))
    with ThreadPoolExecutor(8) as ex:
        rgba = list(ex.map(lambda j: _blender_view(*j[:4], out, j[4]), jobs))
    kept, i = {}, 0
    for split, n in zip(("train", "val", "test"), BLENDER_VIEWS):
        skip = 1 if split == "train" else BLENDER_TESTSKIP
        kept[split] = rgba[i:i + n][::skip]
        i += n
    return kept


def sphere_depth_rays(scene, n_rays: int, seed: int) -> list:
    """Depth supervision for each train view of a loaded Blender scene:
    n_rays pixels (x, y) whose ray (get_rays' pixel convention) meets the
    analytic sphere, with the hit's z-depth and DS-NeRF-style weights
    2·exp(−(err/ē)²) of seeded errors, as spinnerf_scene makes them."""
    from gbnerf_tpu_torch.tools.make_synthetic_scene import MAIN_SPHERE

    rng = np.random.default_rng(seed)
    H, W, focal = scene.hwf
    center, radius = MAIN_SPHERE[0], MAIN_SPHERE[1]
    out = []
    for pose in scene.poses:
        x = rng.integers(0, W, 8 * n_rays).astype(np.float64)
        y = rng.integers(0, H, 8 * n_rays).astype(np.float64)
        d = np.stack([(x - W * 0.5) / focal, -(y - H * 0.5) / focal,
                      -np.ones_like(x)], -1) @ pose[:3, :3].T
        oc = pose[:3, 3] - center
        a, b = (d * d).sum(-1), 2.0 * d @ oc
        disc = b * b - 4.0 * a * (oc @ oc - radius ** 2)
        hit = np.nonzero(disc > 0)[0][:n_rays]
        t = (-b[hit] - np.sqrt(disc[hit])) / (2.0 * a[hit])   # = z-depth
        err = rng.uniform(0.3, 1.5, len(hit))
        out.append({"coord": np.stack([x[hit], y[hit]], -1).astype(
                        np.float32),
                    "depth": t.astype(np.float32),
                    "weight": (2.0 * np.exp(-(err / err.mean()) ** 2)
                               ).astype(np.float32)})
    return out


def read_ply(path: str):
    """utils/mesh.py's binary PLY → (verts [V, 3], faces [F, 3], colours
    [V, 3] or None)."""
    blob = Path(path).read_bytes()
    end = blob.index(b"end_header\n") + len(b"end_header\n")
    hdr = blob[:end].decode().splitlines()
    n_v = int(next(h for h in hdr if h.startswith("element vertex")).split()[-1])
    n_f = int(next(h for h in hdr if h.startswith("element face")).split()[-1])
    rgb = "property uchar red" in hdr
    vdt = np.dtype([("xyz", "<f4", 3)] + ([("rgb", "u1", 3)] if rgb else []))
    v = np.frombuffer(blob, vdt, n_v, end)
    f = np.frombuffer(blob, np.dtype([("n", "u1"), ("idx", "<i4", 3)]), n_f,
                      end + n_v * vdt.itemsize)
    if not (f["n"] == 3).all():
        raise AssertionError(f"{path}: a face that is not a triangle")
    return v["xyz"], f["idx"], (v["rgb"] if rgb else None)


def check_blender_kernels(dev, fine, scene, verts: np.ndarray,
                          results: dict) -> None:
    """The field kernels at the shapes the Blender phase gives them, each
    against its plain version at the check tolerances: K1 at
    render_test_ray's 64 points (the central ray of the first test pose,
    the trained fine field), K2 on one mesh slab of MESH_SLAB·MESH_RES²
    grid points, and field_normals at up to NORMAL_POINTS mesh vertices
    (K2 forward, K5 backward with the point gradient dx) against the same
    normals through the plain σ-only field and autograd."""
    from gbnerf_tpu_torch.core.encoding import sh_encode
    from gbnerf_tpu_torch.core.fields import make_field_fn
    from gbnerf_tpu_torch.core.normals import field_normals
    from gbnerf_tpu_torch.core.rays import get_rays
    from gbnerf_tpu_torch.ops import field_fused as ff
    from gbnerf_tpu_torch.ops.cp_pallas import upsample_lines

    b = fine.bound
    r_max = max(fine.resolutions)
    ul = upsample_lines([l.detach() for l in fine.lines()], r_max)
    Ws = {k: getattr(fine, k).detach() for k in ff.W_KEYS}
    # K1: render_test_ray's call, the fine field at 64 points of one ray
    # ([1, 64, 3] and one view direction [1, 3]: its SH rows are a
    # broadcast, copied dense by CPGridField.forward)
    H, W, focal = scene.hwf
    ro, rd = get_rays(int(H), int(W), focal, torch.as_tensor(
        scene.poses_test[0][:3, :4], device=dev))
    ro, rd = ro[int(H) // 2, int(W) // 2], rd[int(H) // 2, int(W) // 2]
    z = torch.linspace(scene.near, scene.far, 64, device=dev)
    pts, vd = (ro + rd * z[:, None])[None], (rd / torch.linalg.norm(rd))[None]
    field_fn = make_field_fn(fine)
    x = ((pts[0] + b) / (2.0 * b)).contiguous()
    sh = sh_encode(vd).expand(64, 16).contiguous()
    before = all_launches()
    with torch.no_grad():
        got = field_fn(pts, vd)[0]
        used = all_launches()["field_fused"] - before["field_fused"]
        r = compare_field(got, ff.field_plain(x, sh, ul, Ws))
        r.update(points=64, F=ul.shape[2], R_max=r_max, launches=used,
                 ms=cuda_ms(lambda: field_fn(pts, vd), 20),
                 plain_ms=cuda_ms(lambda: ff.field_plain(x, sh, ul, Ws), 5))
    print(f"check field_fused [test ray, 64 points] {json.dumps(r)}")
    if r["n_out_of_tol"] or used != 1:
        raise AssertionError(f"K1 at 64 points: {r}")
    results["field_fused"].append(r)
    # K2: the middle mesh slab
    ax = torch.from_numpy(np.linspace(-MESH_BOUND, MESH_BOUND, MESH_RES,
                                      dtype=np.float32)).to(dev)
    z0 = MESH_RES // 2
    X, Y, Z = torch.meshgrid(ax, ax, ax[z0:z0 + MESH_SLAB], indexing="ij")
    x = ((torch.stack([X, Y, Z], -1).reshape(-1, 3) + b) / (2.0 * b))
    x = x.contiguous()
    sw = {k: Ws[k] for k in ("ws0", "ws1")}
    with torch.no_grad():
        r = compare_field(ff.cp_field_fused(x, None, ul, sw, sigma_only=True),
                          ff.field_plain(x, None, ul, sw, sigma_only=True))
        r.update(points=int(x.shape[0]), F=ul.shape[2], R_max=r_max,
                 ms=cuda_ms(lambda: ff.cp_field_fused(
                     x, None, ul, sw, sigma_only=True), 10))
    print(f"check field_fused_sigma [mesh slab] {json.dumps(r)}")
    if r["n_out_of_tol"]:
        raise AssertionError(f"K2 on a mesh slab: {r}")
    results["field_fused_sigma"].append(r)
    # field_normals: K2 + K5 (dx) against the plain σ-only field. Mesh
    # vertices on a grid plane that passes through CP nodes (here x, y or
    # z = ±0.5) sit on a tie of the 2-tap interpolation, where the kernels
    # take the JAX Pallas kernel's subgradient (sign(0) = 0: that partial
    # is 0) and autograd of the plain encode another: the comparison runs
    # on the other vertices, and at the ties checks the kernel's zero
    pts = torch.from_numpy(np.ascontiguousarray(verts[:NORMAL_POINTS])).to(dev)
    u = (pts + b) / (2.0 * b) * (r_max - 1)
    tie = u == torch.round(u)
    free = ~tie.any(1)

    def sigma_kernel(p):
        return fine(p[:, None, :], None, sigma_only=True)[:, 0, 3]

    def sigma_plain(p):
        return ff.field_plain(((p + b) / (2.0 * b)).contiguous(), None, ul,
                              sw, sigma_only=True)[:, 3]

    def dx(fn):
        with torch.enable_grad():
            p = pts.clone().requires_grad_(True)
            return torch.autograd.grad(fn(p).sum(), p)[0]

    before = all_launches()
    n_kernel = field_normals(sigma_kernel, pts)
    torch.cuda.synchronize()
    used = {k: all_launches()[k] - before[k] for k in before}
    n_plain = field_normals(sigma_plain, pts)
    dx_kernel = dx(sigma_kernel)
    r = {"dx": compare_field(dx_kernel[free], dx(sigma_plain)[free],
                             rtol=5e-2, atol_frac=8e-3)}
    cos = (n_kernel * n_plain).sum(-1)[free]
    r.update(points=int(pts.shape[0]), tie_points=int((~free).sum()),
             tie_partials_zero=bool((dx_kernel[tie] == 0).all()),
             cos_min=float(cos.min()), cos_median=float(cos.median()),
             finite=bool(torch.isfinite(n_kernel).all()),
             launches={k: used[k] for k in ("field_fused_sigma",
                                            "field_fused_bwd_sigma")})
    print(f"check field_normals [mesh vertices] {json.dumps(r)}")
    if (r["dx"]["n_out_of_tol"] or r["cos_min"] < NORMAL_COS_MIN
            or r["cos_median"] < NORMAL_COS_MEDIAN or not r["finite"]
            or not r["tie_partials_zero"]
            or min(r["launches"].values()) < 1):
        raise AssertionError(f"field_normals on the card: {r}")
    results["field_fused_bwd_sigma"].append(
        {"max_abs_err": r["dx"]["max_abs_err"]})


def blender_phase(dev, workdir: Path, field_res: dict) -> dict:
    """A Blender scene from disk through the port's user paths, with
    imageio, cv2 and matplotlib blocked (the card's machine has none):
    write it (write_blender_scene), load_scene with half_res, stage 1
    through train() with the shipped field at full width, render_only with
    render_test_ray, and the export_mesh CLI at MESH_RES³; then the field
    kernels at this phase's new shapes (check_blender_kernels)."""
    from gbnerf_tpu_torch.config import load_reference_config
    from gbnerf_tpu_torch.data.llff import resize_area
    from gbnerf_tpu_torch.tools import export_mesh
    from gbnerf_tpu_torch.train.eval import (SIGMA_CANVAS, SIGMA_DEPTH,
                                             eval_summary, render_pose_path)
    from gbnerf_tpu_torch.train.loop import load_scene, render_only, train
    from gbnerf_tpu_torch.train.state import create_train_state
    from gbnerf_tpu_torch.train.step import make_render_fn
    from gbnerf_tpu_torch.utils.gif import read_gif
    from gbnerf_tpu_torch.utils.png import read_png

    blocked = {m: sys.modules.get(m) for m in ("imageio", "cv2",
                                               "matplotlib")}
    sys.modules.update({m: None for m in blocked})   # the card's machine
    try:
        t0 = time.perf_counter()
        kept = write_blender_scene(workdir / "scene")
        write_s = time.perf_counter() - t0
        never = 10 ** 9
        cfg = load_reference_config(str(ROOT / "configs" /
                                         "spinnerf_scene.txt"))
        cfg = cfg.replace(
            data=dataclasses.replace(
                cfg.data, dataset_type="blender",
                datadir=str(workdir / "scene"), half_res=True,
                testskip=BLENDER_TESTSKIP, colmap_depth=False),
            render=dataclasses.replace(cfg.render, white_bkgd=True,
                                       lindisp=False),
            train=dataclasses.replace(
                cfg.train, first_stage=True, N_iters=BLENDER_STEPS,
                i_print=BLENDER_PRINT, i_weights=BLENDER_STEPS,
                i_evaluate=BLENDER_STEPS, i_testset=never, i_video=never,
                basedir=str(workdir / "logs"), expname="blender",
                no_reload=True, sigma_loss_weight=SIGMA_LOSS_WEIGHT))
        t0 = time.perf_counter()
        scene = load_scene(cfg)
        decode_s = time.perf_counter() - t0
        # the held-out ground truth, as load_scene composites it
        half = BLENDER_SIZE // 2
        gt = np.stack([resize_area(a.astype(np.float32) / 255.0, half, half)
                       for a in kept["test"]])
        scene.images_test = gt[..., :3] * gt[..., 3:] + (1.0 - gt[..., 3:])
        print(f"blender: {sum(BLENDER_VIEWS)} views of {BLENDER_SIZE}² "
              f"(+ {BLENDER_VIEWS[0]} masks) written in {write_s:.3f} s; "
              f"load_scene (half_res, testskip {BLENDER_TESTSKIP}; PNG "
              f"codec, imageio, cv2 and matplotlib blocked) {decode_s:.3f} s "
              f"→ {len(scene.images)} train views at "
              f"{scene.images.shape[1]}x{scene.images.shape[2]}, "
              f"{len(scene.poses_test)} held out, focal "
              f"{scene.hwf[2]:.3f}, masks {scene.masks.shape}")
        if scene.images.shape[1:] != (half, half, 3) or len(scene.masks) != \
                BLENDER_VIEWS[0]:
            raise AssertionError(f"blender scene {scene.images.shape}")
        depth_gts = sphere_depth_rays(scene, 200, seed=1)
        # the held-out PSNR of the initial fields (the run's seed)
        state0, c0, f0 = create_train_state(
            cfg, torch.Generator().manual_seed(cfg.train.seed), dev)
        before = eval_summary(render_pose_path(
            make_render_fn(cfg, c0, f0, scene.near, scene.far,
                           hwf=scene.hwf),
            scene.poses_test, scene.hwf, block=cfg.render.render_block,
            device=dev), scene.images_test)["psnr"]
        del state0, c0, f0

        group_ms = []

        def log_fn(i, m):
            print(f"blender: [{i}/{BLENDER_STEPS}] " + " ".join(
                f"{k}={v:.5g}" for k, v in m.items()))
            bad = [k for k, v in m.items() if not np.isfinite(v)]
            if bad:
                raise AssertionError(f"non-finite blender metrics at {i}: "
                                     f"{bad}")
            group_ms.append(1e3 / m["iters_per_sec"])

        # ---- the Blender path: launches counted from here (load_scene,
        # above, launches none) ...
        zero_launches()
        out = train(cfg, scene=scene, depth_gts=depth_gts, device=dev,
                    log_fn=log_fn)
        torch.cuda.synchronize()
        launches_at = {"train": all_launches()}
        after = (out["last_eval"] or {}).get("eval_psnr", float("nan"))
        ms = float(np.median(group_ms))
        print(f"blender: stage 1, {BLENDER_STEPS} steps, 3 × "
              f"{cfg.train.N_rand} rays a step (σ term on "
              f"{sum(len(d['depth']) for d in depth_gts)} sphere depth "
              f"rays): {ms:.3f} ms per step (median of {len(group_ms)} "
              f"groups of {BLENDER_PRINT}: "
              f"{', '.join(f'{g:.3f}' for g in group_ms)}); held-out PSNR "
              f"{before:.3f} → {after:.3f} dB on {len(scene.poses_test)} "
              f"views at {half}²")
        if not after > before:
            raise AssertionError(f"blender: held-out PSNR did not rise "
                                 f"({before} → {after})")

        ro_cfg = cfg.replace(train=dataclasses.replace(
            cfg.train, render_test_ray=True))
        t0 = time.perf_counter()
        ro = render_only(ro_cfg, scene=scene, device=dev)
        torch.cuda.synchronize()
        ro_s = time.perf_counter() - t0
        launches_at["render_only"] = all_launches()
        rdir = Path(ro["outdir"])
        n_views = len(scene.poses_test) + len(scene.render_poses)
        frames, delays = read_gif(str(rdir / "spiral_rgb.gif"))
        tests = sorted((rdir / "test" / "rgb").glob("*.png"))
        test_rgb = np.stack([read_png(str(p)) for p in tests])
        sigma_png = read_png(str(rdir / "sigma.png"))
        with np.load(rdir / "test_ray.npz") as prof:
            prof = {k: prof[k] for k in prof.files}
        red_cols = np.unique(np.nonzero((sigma_png == SIGMA_DEPTH).all(-1))[1])
        maps_ok = all(np.isfinite(np.load(rdir / f"{k}.npy")).all()
                      for k in ("depth", "disp", "acc"))
        print(f"blender: render_only with render_test_ray {ro_s:.3f} s for "
              f"{n_views} views ({ro_s / n_views:.3f} s a view at {half}², "
              f"GIF and PNG writes included): spiral_rgb.gif "
              f"{frames.shape} at {delays[0]} ms a frame, "
              f"{len(tests)} test PNGs {test_rgb.shape}, sigma.png "
              f"{sigma_png.shape} (depth column {red_cols.tolist()}), "
              f"test_ray.npz depth {float(prof['depth']):.4f}, σ max "
              f"{float(prof['sigma'].max()):.3f} over "
              f"{prof['z_vals'].shape[0]} samples")
        if (frames.shape != (len(scene.render_poses), half, half, 3)
                or len(scene.render_poses) != 40
                or test_rgb.shape != (len(scene.poses_test), half, half, 3)
                or sigma_png.shape != SIGMA_CANVAS + (3,)
                or len(red_cols) != 1
                or prof["sigma"].shape != (cfg.render.N_samples,)
                or not maps_ok):
            raise AssertionError("blender: render_only's artifacts")

        t0 = time.perf_counter()
        mesh = export_mesh.main([
            "--config", str(workdir / "logs" / "blender" / "config.txt"),
            "--res", str(MESH_RES), "--bound", str(MESH_BOUND), "--color"])
        mesh_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        launches_at["export_mesh"] = all_launches()
        # ... to here
    finally:
        for m, mod in blocked.items():
            if mod is None:
                sys.modules.pop(m, None)
            else:
                sys.modules[m] = mod
    verts, faces, cols = read_ply(mesh["out"])
    cell = 2.0 * MESH_BOUND / (MESH_RES - 1)
    radius = synthetic_tool().MAIN_SPHERE[1]
    dist = np.abs(np.linalg.norm(verts, axis=1) - radius) / cell
    parts = {}
    prev = {k: 0 for k in launches_at["export_mesh"]}
    for part in ("train", "render_only", "export_mesh"):
        parts[part] = {k: launches_at[part][k] - prev[k] for k in prev}
        prev = launches_at[part]
    print(f"blender: export_mesh --res {MESH_RES} --bound {MESH_BOUND} "
          f"--color {mesh_s:.3f} s (σ grid {mesh['times']['grid_s']:.3f} s "
          f"in {parts['export_mesh']['field_fused_sigma']} K2 calls, "
          f"triangulation {mesh['times']['triangulate_s']:.3f} s, colours "
          f"{mesh['times']['color_s']:.3f} s in "
          f"{parts['export_mesh']['field_fused']} K1 calls): {len(verts)} "
          f"vertices, {len(faces)} faces, {cols is not None and len(cols)} "
          f"colours; vertices from the analytic sphere (r {radius}) in grid "
          f"cells of {cell:.5f}: median {float(np.median(dist)):.3f}, 90th "
          f"percentile {float(np.percentile(dist, 90)):.3f}")
    if not (len(faces) and cols is not None and len(cols) == len(verts)
            and np.array_equal(verts, mesh["verts"])):
        raise AssertionError("blender: the PLY is empty, uncoloured, or "
                             "differs from the mesh")
    launches = launches_at["export_mesh"]
    print(f"blender: launches by part {json.dumps(parts)}")
    for k in ("field_fused", "field_fused_sigma", "merge128",
              "field_fused_bwd", "field_fused_bwd_sigma"):
        if launches[k] <= 0:
            raise AssertionError(f"kernel {k} was not launched by the "
                                 "Blender path")
    check_blender_kernels(dev, out["state"].fine, scene, verts, field_res)
    return {"launches": launches, "step_ms": ms}


def profile_nog(dev, disk: dict, outdir: Path) -> None:
    """--profile: one traced nog step on the disk phase's trained state."""
    from gbnerf_tpu_torch.data.llff import load_colmap_depth
    from gbnerf_tpu_torch.data.rays_bank import build_ray_banks
    from gbnerf_tpu_torch.train.loop import banks_to_device, scene_to_device
    from gbnerf_tpu_torch.train.step import make_train_step_stage2

    out, cfg = disk["nog"], disk["nog_cfg"]
    state, scene = out["state"], out["scene"]
    depth_gts = load_colmap_depth(disk["datadir"], cfg.data.factor,
                                  skip_first=cfg.data.test_split_count)
    banks = build_ray_banks(scene.images, scene.masks, scene.inpainted_depths,
                            scene.poses, scene.hwf[2], depth_gts)
    scene_dev = scene_to_device(scene, banks, dev)
    banks_dev = banks_to_device(banks, dev)
    step = make_train_step_stage2(cfg, state.coarse, state.fine, scene.near,
                                  scene.far, scene.hwf, lpips_fn=out["lpips"])
    gen = torch.Generator(device=dev).manual_seed(13)
    profile_once(lambda: step(state, scene_dev, banks_dev, gen), "nog_step",
                 outdir, disk["nog_ms"])


def guided_phase(dev, workdir: Path) -> dict:
    """The ablation's guided arms on the disk phase's scene: a tiny prior
    from the tiny-prior CLI (PRIOR_STEPS VAE and UNet steps at latent 256),
    the scene LoRA from the LoRA CLI on it (LORA_TINY_STEPS steps, batch
    4, the label masks out of the loss), then the twin's priorNL-sds
    config for PRIOR_NL_STEPS steps through train() from s1's checkpoint
    (the prior loaded, the adapters merged, RGB and normal-map SDS from the
    first step). Each with its own launch counts."""
    import shutil

    from gbnerf_tpu_torch import train_lora
    from gbnerf_tpu_torch.config import load_reference_config
    from gbnerf_tpu_torch.ops import attention as at
    from gbnerf_tpu_torch.tools import run_ablation, train_tiny_prior

    smi = nvidia_smi_line()
    prior = workdir / "prior.msgpack"
    launches = {}
    # ---- the prior trainer: launches counted from here ...
    zero_launches()
    t0 = time.perf_counter()
    train_tiny_prior.main([
        str(prior), "--res", "256", "--n_domain", str(PRIOR_DOMAIN),
        "--steps_vae", str(PRIOR_STEPS), "--steps_unet", str(PRIOR_STEPS),
        "--chunk", str(PRIOR_STEPS), "--device", DEVICE])
    torch.cuda.synchronize()
    prior_s = time.perf_counter() - t0
    launches["prior"] = all_launches()
    prior_shapes = dict(at.LAUNCHES_BY_SHAPE)
    shapes = {f"{n}x{d}": c for (n, d), c in prior_shapes.items()}
    # ... to here; the LoRA trainer: launches counted from here ...
    zero_launches()
    scene = workdir / "scene" / "images_4"
    t0 = time.perf_counter()
    train_lora.main([
        "--tiny", "--sd_prior_ckpt", str(prior), "--latent_size", "256",
        "--instance_data_dir", str(scene / "RGB_inpainted"),
        "--instance_mask_dir", str(scene / "label"),
        "--output_dir", str(workdir / "lora"),
        "--max_train_steps", str(LORA_TINY_STEPS), "--train_batch_size",
        "4", "--checkpointing_steps", str(LORA_TINY_STEPS),
        "--device", DEVICE])
    torch.cuda.synchronize()
    lora_s = time.perf_counter() - t0
    launches["lora"] = all_launches()
    # ... to here
    print(f"guided: tiny prior ({PRIOR_DOMAIN} domain images at 256², "
          f"{PRIOR_STEPS} + {PRIOR_STEPS} steps) in {prior_s:.3f} s, K7 by "
          f"(N, D) {json.dumps(shapes)}"
          f"; scene LoRA ({LORA_TINY_STEPS} steps) in {lora_s:.3f} s | "
          f"{smi}")
    n_test = DISK_VIEWS[1]
    paths = run_ablation.write_configs(str(workdir), abl_args(
        PRIOR_NL_STEPS, n_test), arms=("s1", "priorNL"))
    cfg = load_reference_config(paths["priorNL"])
    never = 10 ** 9
    cfg = cfg.replace(train=dataclasses.replace(
        cfg.train, i_print=PRIOR_NL_PRINT, i_weights=never))
    expdir = workdir / "logs" / "priorNL-sds"
    expdir.mkdir(parents=True)
    shutil.copytree(workdir / "logs" / "s1" / "ckpt", expdir / "ckpt")
    total = DISK_S1_STEPS + PRIOR_NL_STEPS
    out, ms, groups, launches["priorNL"] = _disk_train(
        cfg, dev, "priorNL-sds", total, PRIOR_NL_PRINT)
    hist = [m for _, m in out["history"]]
    if not all(m["sds_loss"] != 0 and m["lpips_loss"] > 0 for m in hist):
        raise AssertionError(f"priorNL-sds: sds_loss / lpips_loss {hist}")
    for label, want in (("prior", ("attention",)),
                        ("lora", ("attention",)),
                        ("priorNL", ("field_fused", "merge128",
                                     "field_fused_bwd", "attention"))):
        for k in want:
            if launches[label][k] <= 0:
                raise AssertionError(f"kernel {k} was not launched by "
                                     f"{label}")
    if not {(1024, 16), (1024, 32)} <= set(prior_shapes):
        raise AssertionError(f"the prior's K7 shapes: {prior_shapes}")
    ev = out["last_eval"]
    if not (ev and all(np.isfinite(ev[f"eval_{k}"]) for k in
                       ("psnr", "psnr_masked", "psnr_unmasked"))):
        raise AssertionError(f"priorNL-sds: eval {ev}")
    print(f"guided priorNL-sds: {PRIOR_NL_STEPS} steps from s1's checkpoint "
          f"(tiny prior + scene LoRA at 256², RGB and normal SDS, LPIPS): "
          f"{ms:.3f} ms per step (median of {len(groups)} groups of "
          f"{PRIOR_NL_PRINT}: {', '.join(f'{g:.3f}' for g in groups)}); "
          f"launches {json.dumps(launches)}; eval {json.dumps(ev)} | {smi}")
    total_launches = {k: sum(v[k] for v in launches.values())
                      for k in launches["prior"]}
    return {"launches": total_launches, "out": out, "cfg": cfg, "ms": ms}


def profile_prior_nl(dev, guided: dict, outdir: Path) -> None:
    """--profile: one traced priorNL-sds step on the guided phase's state."""
    from gbnerf_tpu_torch.data.llff import load_colmap_depth
    from gbnerf_tpu_torch.data.rays_bank import build_ray_banks
    from gbnerf_tpu_torch.train.loop import (banks_to_device, build_guidance,
                                             scene_to_device)
    from gbnerf_tpu_torch.train.step import make_train_step_stage2

    out, cfg = guided["out"], guided["cfg"]
    state, scene = out["state"], out["scene"]
    depth_gts = load_colmap_depth(cfg.data.datadir, cfg.data.factor,
                                  skip_first=cfg.data.test_split_count)
    banks = build_ray_banks(scene.images, scene.masks, scene.inpainted_depths,
                            scene.poses, scene.hwf[2], depth_gts)
    scene_dev = scene_to_device(scene, banks, dev)
    guidance_fn, _, _ = build_guidance(cfg, scene_dev, dev, 1)
    step = make_train_step_stage2(cfg, state.coarse, state.fine, scene.near,
                                  scene.far, scene.hwf,
                                  guidance_fn=guidance_fn,
                                  lpips_fn=out["lpips"])
    banks_dev = banks_to_device(banks, dev)
    gen = torch.Generator(device=dev).manual_seed(17)
    profile_once(lambda: step(state, scene_dev, banks_dev, gen),
                 "prior_nl_step", outdir, guided["ms"])


def _lora_batch(ds, host_rng, mods, batch: int, dev) -> dict:
    imgs, masks, captions, imasks = ds.batch(host_rng, batch)
    with torch.no_grad():
        embeds = mods.text_model(mods.tokenizer(captions))
    return {"image": torch.as_tensor(imgs, device=dev),
            "mask": torch.as_tensor(masks, device=dev),
            "instance_mask": torch.as_tensor(imasks, device=dev),
            "embeds": embeds}


def _tiny_lora_vs_cpu(dev, key=None) -> dict:
    """One tiny LoRA step's loss and adapter gradients, card against CPU:
    the same weights (the CPU's init, copied), adapters (B drawn), batch
    and draws; latent 512, so K7 runs in the UNet and the VAE. key: a
    JaxKey for the JAX package's draws: the stack's init from it, and
    the adapters' A and the step's t, ε and posterior ε drawn from its
    two splits on each device (within JAX_ULP card vs CPU, t equal)."""
    from gbnerf_tpu_torch.config import GuidanceConfig
    from gbnerf_tpu_torch.guidance import lora
    from gbnerf_tpu_torch.guidance.stable import build_sd_modules
    from gbnerf_tpu_torch.guidance.text import CLIPTextConfig
    from gbnerf_tpu_torch.guidance.unet import UNetConfig
    from gbnerf_tpu_torch.guidance.vae import VAEConfig
    from gbnerf_tpu_torch.ops import attention as at
    from gbnerf_tpu_torch.train import lora_trainer as lt
    from gbnerf_tpu_torch.utils import jax_random as jr

    S, B = 512, 2
    cpu = build_sd_modules(
        GuidanceConfig(prompt="a photo"),
        torch.Generator().manual_seed(0) if key is None else jr.PRNGKey(0),
        unet_config=UNetConfig.tiny(), vae_config=VAEConfig.tiny(),
        text_config=CLIPTextConfig(vocab_size=49408, width=32, layers=2,
                                   heads=2), latent_size=S,
        dtype=torch.float32)
    card = dataclasses.replace(cpu, unet=copy.deepcopy(cpu.unet).to(dev),
                               vae=copy.deepcopy(cpu.vae).to(dev))
    k_init, k_step = jr.key_split(key) if key is not None else (None, None)
    gen = torch.Generator().manual_seed(1)
    ad = lora.init_lora(cpu.unet, rank=4, generator=k_init or gen)
    ad = {k: (v if k.endswith("lora_A") else
              0.05 * torch.randn(v.shape, generator=gen))
          for k, v in ad.items()}
    rng = np.random.default_rng(2)
    batch = {"image": torch.from_numpy(rng.integers(0, 256, (B, S, S, 3),
                                                    dtype=np.uint8)),
             "mask": torch.from_numpy(np.stack([
                 lt.random_mask(rng, S, S) for _ in range(B)]).astype(
                     np.uint8)),
             "instance_mask": None,
             "embeds": cpu.embeds_rgb[[1, 2]].clone()}
    draws = lt.draw_step(torch.Generator().manual_seed(3), B, S // 8, "cpu")
    res = {}
    for name, mods, d in (("cpu", cpu, torch.device("cpu")),
                          ("card", card, dev)):
        _, step = lt.make_lora_train_step(mods, rank=4)
        if key is None:
            a = {k: v.to(d) for k, v in ad.items()}
            dd = {k: v.to(d) for k, v in draws.items()}
        else:       # A and the draws from the key on this device
            a = {k: (ad[k].to(d) if k.endswith("lora_B") else v) for k, v in
                 lora.init_lora(mods.unet, rank=4, generator=k_init).items()}
            dd = lt.draw_step(k_step, B, S // 8, d)
        a = {k: v.detach().clone().requires_grad_(True) for k, v in a.items()}
        b = {k: (v.to(d) if v is not None else None)
             for k, v in batch.items()}
        before = at.LAUNCHES["attention"]
        loss = step.loss_fn(a, b, dd)
        loss.backward()
        res[name] = (loss.item(), {k: v.grad.detach().cpu()
                                   for k, v in a.items()},
                     {k: v.detach().cpu() for k, v in a.items()},
                     {k: v.cpu() for k, v in dd.items()},
                     at.LAUNCHES["attention"] - before)
    (l_cpu, g_cpu, a_cpu, d_cpu, _), (l_card, g_card, a_card, d_card, k7) = (
        res["cpu"], res["card"])
    cos = {k: float(torch.nn.functional.cosine_similarity(
        g_card[k].flatten().double(), g_cpu[k].flatten().double(), dim=0))
        for k in g_cpu}
    worst = min(cos, key=cos.get)
    r = {"loss_card": l_card, "loss_cpu": l_cpu,
         "loss_rel_err": abs(l_card - l_cpu) / abs(l_cpu),
         "grad_cos_min": cos[worst], "worst": worst, "k7_calls": k7,
         "adapters": len(cos)}
    ok = True
    if key is not None:
        r.update(a_ulp=max(_ulp32(a_card[k], a_cpu[k]) for k in a_cpu),
                 draws_ulp=max(_ulp32(d_card[k], d_cpu[k])
                               for k in d_cpu if k != "t"),
                 t_equal=bool(torch.equal(d_card["t"], d_cpu["t"])))
        ok = (r["a_ulp"] <= JAX_ULP and r["draws_ulp"] <= JAX_ULP
              and r["t_equal"])
    print(f"lora tiny step vs cpu{'' if key is None else ', jax draws'}: "
          f"{json.dumps(r)}")
    if (not ok or r["loss_rel_err"] > LORA_TINY_LOSS_RTOL
            or r["grad_cos_min"] < LORA_TINY_GRAD_COS or k7 <= 0):
        raise AssertionError(f"tiny LoRA step, card vs CPU: {r}")
    return r


def lora_phase(dev, datadir: str, outdir=None) -> dict:
    """The full-size LoRA fine-tune (train/lora_trainer.py) and DDIM inpaint
    (guidance/pipeline.py) on the card, with their launch counts; then the
    card-vs-CPU tiny step and a prior written and read back through
    utils/msgpack.py. See LORA_* above."""
    from gbnerf_tpu_torch.config import GuidanceConfig
    from gbnerf_tpu_torch.guidance import lora, weights
    from gbnerf_tpu_torch.guidance.pipeline import inpaint
    from gbnerf_tpu_torch.guidance.stable import build_sd_modules
    from gbnerf_tpu_torch.guidance.text import CLIPTextConfig
    from gbnerf_tpu_torch.guidance.unet import UNetConfig
    from gbnerf_tpu_torch.guidance.vae import VAEConfig
    from gbnerf_tpu_torch.ops import attention as at
    from gbnerf_tpu_torch.train import lora_trainer as lt

    smi = nvidia_smi_line()
    # ---- the LoRA and inpaint main path: launches counted from here ...
    zero_launches()
    gcfg = GuidanceConfig(prompt="a photo of a scene",
                          negative_prompt="blurry")
    t0 = time.perf_counter()
    mods = build_sd_modules(gcfg, torch.Generator(device=dev).manual_seed(0),
                            device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    n_base = sum(p.numel() for p in mods.unet.parameters())
    ds = lt.DreamBoothInpaintDataset(
        str(Path(datadir) / "images_4" / "RGB_inpainted"),
        mask_dir=str(Path(datadir) / "images_4" / "label"), resolution=512,
        default_caption="a photo of a scene")
    host_rng = np.random.default_rng(0)
    gen = torch.Generator(device=dev).manual_seed(1)
    batch_size, oom = LORA_BATCH, None
    while True:
        init_fn, step = lt.make_lora_train_step(mods, rank=LORA_RANK,
                                                lr=1e-4, masked_loss=True)
        adapters, opt = init_fn(torch.Generator(device=dev).manual_seed(2))
        n_ad = lora.lora_param_count(adapters)
        t0 = time.perf_counter()
        batches = [_lora_batch(ds, host_rng, mods, batch_size, dev)
                   for _ in range(LORA_WARM + LORA_STEPS)]
        batch_s = (time.perf_counter() - t0) / len(batches)
        torch.cuda.reset_peak_memory_stats(dev)
        try:
            losses = [float(step(adapters, opt, b, gen)["loss"])
                      for b in batches[:LORA_WARM]]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for b in batches[LORA_WARM:]:
                m = step(adapters, opt, b, gen)
            torch.cuda.synchronize()
            step_ms = (time.perf_counter() - t0) * 1e3 / LORA_STEPS
            losses.append(float(m["loss"]))
            break
        except torch.cuda.OutOfMemoryError as e:
            if batch_size == 2:
                raise
            oom = {"batch": batch_size, "peak_gib":
                   torch.cuda.max_memory_allocated(dev) / 2 ** 30,
                   "error": str(e).splitlines()[0]}
            print(f"lora: batch {batch_size} does not fit: {json.dumps(oom)}"
                  " — running batch 2")
            del adapters, opt, batches
            torch.cuda.empty_cache()
            batch_size = 2
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    # K7's re-linearised backward: its share of a step (CUDA events around
    # each call of _Attend.backward over two more steps)
    spans, orig = [], at._Attend.backward

    def timed(ctx, g):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        r = orig(ctx, g)
        b.record()
        spans.append((a, b))
        return r

    at._Attend.backward = staticmethod(timed)
    try:
        for b in batches[:2]:
            step(adapters, opt, b, gen)
        torch.cuda.synchronize()
    finally:
        at._Attend.backward = staticmethod(orig)
    attn_bwd_ms = sum(a.elapsed_time(b) for a, b in spans) / 2
    # the DDIM inpaint at full size: DDIM_STEPS and 2 steps, the
    # difference a step (the VAE encode and decode cancel)
    img = torch.as_tensor(ds.image(0), device=dev).float() / 255.0
    mask = torch.as_tensor(lt.random_mask(np.random.default_rng(5), 512, 512),
                           device=dev)
    g2 = torch.Generator(device=dev).manual_seed(6)
    inpaint(mods, mods.embeds_rgb, img, mask, g2, num_inference_steps=2)
    times = {}
    for n in (DDIM_STEPS, 2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gen_img = inpaint(mods, mods.embeds_rgb, img, mask, g2,
                          num_inference_steps=n)
        torch.cuda.synchronize()
        times[n] = (time.perf_counter() - t0) * 1e3
        if n == DDIM_STEPS:
            out_img = gen_img
    ddim_ms = (times[DDIM_STEPS] - times[2]) / (DDIM_STEPS - 2)
    launches, by_shape = all_launches(), dict(at.LAUNCHES_BY_SHAPE)
    # ... to here
    if not (out_img.shape == (512, 512, 3) and bool(torch.isfinite(
            out_img).all()) and 0 <= float(out_img.min())
            and float(out_img.max()) <= 1):
        raise AssertionError(f"inpaint: {out_img.shape}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"LoRA losses {losses}")
    if n_ad != LORA_ADAPTERS or len(lora.lora_targets(mods.unet)) != \
            LORA_KERNELS:
        raise AssertionError(f"{n_ad} adapter parameters on "
                             f"{len(lora.lora_targets(mods.unet))} kernels, "
                             f"not {LORA_ADAPTERS} on {LORA_KERNELS}")
    want = {(4096, 40), (1024, 80), (4096, 512)}
    if launches["attention"] <= 0 or not want <= set(by_shape):
        raise AssertionError(f"K7 by (N, D) in the LoRA phase: {by_shape}")
    r = {"batch": batch_size, "oom_at_4": oom, "rank": LORA_RANK,
         "adapter_params": n_ad, "adapted_kernels": LORA_KERNELS,
         "base_params": n_base, "sd_build_s": build_s,
         "host_batch_ms": batch_s * 1e3, "step_ms": step_ms,
         "peak_gib": peak_gib, "attention_bwd_ms": attn_bwd_ms,
         "attention_bwd_share": attn_bwd_ms / step_ms, "losses": losses,
         "ddim_step_ms": ddim_ms, "ddim_total_ms": times,
         "k7_by_shape": {f"{n}x{d}": c for (n, d), c in by_shape.items()},
         "launches": launches}
    print(f"lora: full-size SD1.5-inpaint UNet (bf16, random), rank "
          f"{LORA_RANK}, batch {batch_size} at 512²: {step_ms:.3f} ms a step "
          f"(mean of {LORA_STEPS} after {LORA_WARM} warm-up), peak "
          f"{peak_gib:.2f} GiB, K7 backward {attn_bwd_ms:.3f} ms a step; "
          f"DDIM inpaint {ddim_ms:.3f} ms a step | {smi}")
    print(f"lora: {json.dumps(r)}")

    # the merged UNet against the functional path (not counted)
    x = torch.randn((2, 64, 64, 9), generator=gen, device=dev)
    emb = mods.embeds_rgb[1:]
    with torch.no_grad():
        eps_f = torch.func.functional_call(
            mods.unet, lora.apply_lora(mods.unet, adapters), (x, 500, emb))
        lora.merge_lora_strict(mods.unet, {k: v.detach() for k, v in
                                           adapters.items()},
                               source="the LoRA phase")
        eps_m = mods.unet(x, 500, emb)
    cos = float(torch.nn.functional.cosine_similarity(
        eps_m.flatten().double(), eps_f.flatten().double(), dim=0))
    print(f"lora: merged vs functional ε cosine {cos:.9f} (max |Δ| "
          f"{float((eps_m - eps_f).abs().max()):.3e})")
    if cos < LORA_MERGE_COS:
        raise AssertionError(f"merged vs functional ε cosine {cos}")
    step_fn = (lambda: step(adapters, opt, batches[0], gen))
    if outdir is not None:
        profile_once(step_fn, "lora_step", outdir, step_ms)
    del mods, adapters, opt, batches, step, step_fn
    torch.cuda.empty_cache()

    r["tiny_vs_cpu"] = _tiny_lora_vs_cpu(dev)
    # a prior written and read back through utils/msgpack.py on the card
    kw = dict(unet_config=UNetConfig.tiny(), vae_config=VAEConfig.tiny(),
              text_config=CLIPTextConfig(vocab_size=49408, width=32,
                                         layers=2, heads=2), latent_size=256,
              dtype=torch.float32, device=dev)
    a = build_sd_modules(gcfg, torch.Generator(device=dev).manual_seed(8),
                         **kw)
    b = build_sd_modules(gcfg, torch.Generator(device=dev).manual_seed(9),
                         **kw)
    with tempfile.TemporaryDirectory() as tmp:
        weights.save_prior_ckpt(f"{tmp}/prior.msgpack", a)
        nbytes = Path(f"{tmp}/prior.msgpack").stat().st_size
        weights.load_prior_ckpt(f"{tmp}/prior.msgpack", b)
    same = all(torch.equal(x, y) for m, n in ((a.unet, b.unet),
                                              (a.vae, b.vae))
               for x, y in zip(m.state_dict().values(),
                               n.state_dict().values()))
    same = same and torch.equal(a.embeds_rgb, b.embeds_rgb) and \
        torch.equal(a.embeds_normal, b.embeds_normal)
    print(f"lora: prior of {nbytes} bytes written and read back through "
          f"utils/msgpack.py, arrays equal: {same}")
    if not same:
        raise AssertionError("the prior read back differs")
    return r


def profile_paths(workdir: Path) -> dict:
    """The profiling entry points in-process, each with its own launch
    counts → {path: launches}. prof_field at its full workload is K6's
    path; prof_train and prof_guidance run at a few reps."""
    from gbnerf_tpu_torch.tools import prof_field, prof_guidance, prof_train

    name = torch.cuda.get_device_name(0)
    out = {}
    # ---- prof_field: launches counted from here ...
    zero_launches()
    lines = prof_field.main(["--rays", str(BENCH_RAYS), "--reps",
                             str(PROF_FIELD_REPS)])
    torch.cuda.synchronize()
    out["prof_field"] = all_launches()
    # ... to here
    want = {"full_render", "encode_dense_plain", "encode_dense_kernel",
            "encode_kr", "mlp_heads", "resample+merge", "raw2outputs_128"}
    if {l["component"] for l in lines} != want or not all(
            l["device"] == name and np.isfinite(l["ms"]) and l["ms"] > 0
            for l in lines):
        raise AssertionError(f"prof_field's lines: {lines}")
    # ---- prof_train: launches counted from here ...
    zero_launches()
    summary = prof_train.main(["--reps", str(PROF_TRAIN_REPS), "--out",
                               str(workdir / "prof_train")])
    torch.cuda.synchronize()
    out["prof_train"] = all_launches()
    # ... to here
    if summary["device"] != "cuda" or not summary["busy_ms"] > 0:
        raise AssertionError(f"prof_train traced no device time: {summary}")
    # ---- prof_guidance: launches counted from here ...
    zero_launches()
    glines = prof_guidance.main(["--reps", str(PROF_GUIDANCE_REPS)])
    torch.cuda.synchronize()
    out["prof_guidance"] = all_launches()
    # ... to here
    if not all(l["device"] == name and np.isfinite(l.get("ms", l.get("s")))
               for l in glines):
        raise AssertionError(f"prof_guidance's lines: {glines}")
    print(f"profilers: launches {json.dumps(out)}")
    for path, kernels in (("prof_field", ("cp_encode", "field_fused",
                                          "field_fused_sigma", "merge128")),
                          ("prof_train", ("field_fused", "field_fused_bwd",
                                          "merge128")),
                          ("prof_guidance", ("attention",))):
        for k in kernels:
            if out[path][k] <= 0:
                raise AssertionError(f"kernel {k} was not launched by {path}")
    return out


def hash_phase(cfg, dev, scene, depth_gts, workdir: Path, ro, rd,
               profile_dir=None) -> dict:
    """The hash-grid field (field_type = hash, the reference's tcnn
    topology) at full width, f32, on the stage-1 phase's scene: stage 1
    through train() (TRAIN_STEPS steps, checkpoint save and restore, one
    eval render), the card's step against the CPU's, one step twice from
    one state (bit-equal), the render phase's 16384 rays, HASH_STAGE2_STEPS
    stage-2 steps from its checkpoint with the full-size SD stack, and the
    native host library. The hash encode is plain PyTorch (as in the JAX
    package); the paths' kernels are K3 (every render) and K7 (stage 2),
    and none of the CP field's may run. With ``profile_dir``, one render
    and one stage-1 step are traced. → {"launches": [the main paths'
    counts]}"""
    from gbnerf_tpu_torch.core.fields import HashGridField, level_resolutions
    from gbnerf_tpu_torch.data import native
    from gbnerf_tpu_torch.train.step import make_render_fn

    hcfg = cfg.replace(field=dataclasses.replace(
        cfg.field, field_type="hash", compute_dtype="float32"))
    f = hcfg.field
    # ---- stage 1 through train() (its own counts)
    out, step_ms, step_launches, eval_launches = stage1_train(
        hcfg, dev, scene, depth_gts, workdir, expname="hash_stage1",
        label="hash", step_kernels=("merge128",), eval_kernels=("merge128",))
    state = out["state"]
    if not isinstance(state.fine, HashGridField):
        raise AssertionError(f"field_type = hash built {type(state.fine)}")
    res = level_resolutions(f.n_levels, f.base_res,
                            state.fine.per_level_scale)
    print(f"hash: L {f.n_levels}, T 2^{f.log2_hashmap_size}, F "
          f"{f.n_features}, bound {f.bound}, resolutions {res}, "
          f"{sum((r + 1) ** 3 <= 2 ** f.log2_hashmap_size for r in res)} "
          f"dense levels; {state.fine.hash_table.numel() * 4 / 2 ** 20:.0f} "
          f"MiB of table a field")
    cp_kernels = ("field_fused", "field_fused_sigma", "field_fused_bwd",
                  "field_fused_bwd_sigma", "cp_encode")
    # ---- the card's step against the CPU's, in f32 and in float64; one
    # step twice (bit-equal)
    step_vs_plain(hcfg, dev, state, scene, depth_gts, label="hash step")
    step_vs_plain(hcfg, dev, state, scene, depth_gts, label="hash step",
                  f64=True)
    stage1_step_twice(hcfg, dev, state, scene, depth_gts, kernel="merge128",
                      label="hash stage1")
    # ---- the render phase's rays with the trained hash fields (own counts)
    render = make_render_fn(hcfg, state.coarse, state.fine, near=NEAR,
                            far=FAR)
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    with torch.no_grad():
        render(ro, rd, train=False)                          # warm
        torch.cuda.synchronize()
        group_ms = []
        for _ in range(HASH_BENCH_GROUPS):
            t0 = time.perf_counter()
            for _ in range(HASH_BENCH_REPS):
                out_r = render(ro, rd, train=False)
            torch.cuda.synchronize()
            group_ms.append((time.perf_counter() - t0) * 1e3
                            / HASH_BENCH_REPS)
    render_launches = all_launches()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    ms = float(np.median(group_ms))
    print(f"hash bench: {BENCH_RAYS} rays, 64+64 samples: {ms:.3f} ms per "
          f"render (median of {HASH_BENCH_GROUPS} groups of "
          f"{HASH_BENCH_REPS}: {', '.join(f'{g:.3f}' for g in group_ms)}), "
          f"{BENCH_RAYS / (ms / 1e3):.1f} rays/s; peak memory "
          f"{peak_gib:.2f} GiB; launches {json.dumps(render_launches)}")
    for k in ("rgb", "acc", "depth", "disp"):
        if not bool(torch.isfinite(getattr(out_r, k)).all()):
            raise AssertionError(f"hash bench {k} not finite")
    if profile_dir is not None:
        with torch.no_grad():
            profile_once(lambda: render(ro, rd, train=False), "hash_render",
                         profile_dir, ms)
        profile_stage1_step(hcfg, dev, state, scene, depth_gts,
                            "hash_train_step", profile_dir, step_ms)
    # ---- stage 2 from the hash checkpoint, the full-size SD stack (own
    # counts; train() builds the stack itself)
    s2_launches = stage2_train(
        hcfg, dev, scene, depth_gts, workdir, TRAIN_STEPS,
        label="hash stage2", steps=HASH_STAGE2_STEPS,
        every=HASH_STAGE2_PRINT, src="hash_stage1",
        kernels=("merge128", "attention"))[2]
    paths = [step_launches, eval_launches, render_launches, s2_launches]
    for k in cp_kernels:
        if any(p[k] for p in paths):
            raise AssertionError(f"the hash paths launched the CP field's "
                                 f"{k}: {[p[k] for p in paths]}")
    # ---- the native host library, built from native/csrc at first use
    if not native.available():
        raise AssertionError(f"native library unavailable: "
                             f"{native.build_error}")
    rng = np.random.default_rng(12)
    a = np.sort(rng.random((1024, 129)).astype(np.float32), -1)
    v = rng.random((1024, 64)).astype(np.float32) * 1.2 - 0.1
    for side in ("left", "right"):
        want = np.stack([np.searchsorted(a[i], v[i], side)
                         for i in range(len(v))])
        if not np.array_equal(native.searchsorted(a, v, side), want):
            raise AssertionError(f"native searchsorted ({side}) differs "
                                 "from numpy")
    print(f"native: available, built at "
          f"{native.build_library().relative_to(ROOT)}; searchsorted "
          f"[1024, 129] × [1024, 64] both sides equal to numpy")
    return {"launches": paths}


def check_cp_positions(dev) -> dict:
    """The CP field's x01 (core/cp_field.py::positions) on the card against
    the CPU, bit for bit, at the shipped bound 8 and at 3 and 1.5, where the
    reciprocal of 2·bound is inexact; beside it, how many entries a
    Python-scalar divisor (which CUDA turns into a product with the
    reciprocal) would put off the CPU's."""
    from gbnerf_tpu_torch.core.cp_field import positions

    pts = torch.randn(CP_POS_POINTS, 3,
                      generator=torch.Generator().manual_seed(0)) * 4
    res = {}
    for b in (8.0, 3.0, 1.5):
        ref = positions(pts, b)
        got = positions(pts.to(dev), b).cpu()
        scalar = ((pts.to(dev) + b) / (2.0 * b)).cpu()
        res[str(b)] = {"field_differs": int((got != ref).sum()),
                       "scalar_divisor_differs": int((scalar != ref).sum())}
    print(f"check cp positions (x01) card vs CPU, {CP_POS_POINTS} x 3: "
          f"{json.dumps(res)}")
    bad = [b for b, r in res.items() if r["field_differs"]]
    if bad:
        raise AssertionError(f"CP x01 on the card differs from the CPU's at "
                             f"bound {bad}")
    return res


def _run_group(cmd, log: Path, timeout: float) -> str:
    """Run cmd in its own process group (torchrun and its ranks), output
    to ``log``; on a timeout the whole group is killed. → its output."""
    import os
    import signal

    env = dict(os.environ, PYTHONPATH=str(ROOT))
    with open(log, "w") as fh:
        proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=fh,
                                stderr=subprocess.STDOUT,
                                start_new_session=True)
        try:
            rc = proc.wait(timeout=timeout)
        except BaseException as e:        # a timeout or an interrupt
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
            if isinstance(e, subprocess.TimeoutExpired):
                raise AssertionError(f"timed out after {timeout} s: "
                                     f"{' '.join(map(str, cmd))}") from e
            raise
    out = log.read_text()
    if rc:
        print(out[-4000:])
        raise AssertionError(f"exit {rc}: {' '.join(map(str, cmd))}")
    return out


def _torchrun(nproc: int) -> list:
    return [sys.executable, "-m", "torch.distributed.run", "--standalone",
            f"--nproc_per_node={nproc}"]


def _cosines(got: dict, ref: dict) -> dict:
    out = {}
    for n in ref:
        for k, r in ref[n].items():
            g, r = got[n][k].double().reshape(-1), r.double().reshape(-1)
            den = float(torch.linalg.norm(g) * torch.linalg.norm(r))
            out[f"{n}.{k}"] = float(g @ r) / den if den else (
                1.0 if float(torch.linalg.norm(g - r)) == 0 else 0.0)
    return out


def _sds_readings(got: dict, ref: dict, w: float) -> dict:
    """A stage-2 step with ``sds_record`` against another: the loss's
    relative error; its error against the scale of its terms, the rest of
    the loss plus S = w·Σ|latents·g| (the SDS scalar's terms, which cancel);
    the rest's relative error; the SDS term's error against S; each
    modality's g by cosine; the field gradients' least cosine."""
    sds, ref_sds = got["metrics"]["sds_loss"], ref["metrics"]["sds_loss"]
    rest, ref_rest = got["loss"] - w * sds, ref["loss"] - w * ref_sds
    scale = w * sum(ref["sds_abs"])
    cos_g = []
    for a, b in zip(got["sds_g"], ref["sds_g"]):
        a, b = a.double().reshape(-1), b.double().reshape(-1)
        cos_g.append(float(a @ b / max(float(torch.linalg.norm(a)
                                             * torch.linalg.norm(b)),
                                       1e-300)))
    d = abs(got["loss"] - ref["loss"])
    return {"loss_rel_err": d / max(abs(ref["loss"]), 1e-30),
            "loss_cond_err": d / max(abs(ref_rest) + scale, 1e-30),
            "rest_rel_err": abs(rest - ref_rest) / max(abs(ref_rest), 1e-30),
            "sds_cond_err": w * abs(sds - ref_sds) / max(scale, 1e-30),
            "sds_rel_err": abs(sds - ref_sds) / max(abs(ref_sds), 1e-30),
            "sds_terms_scale": scale, "sds_term": w * ref_sds,
            "g_min_cos": min(cos_g) if cos_g else 0.0,
            "n_injections": len(cos_g),
            "min_grad_cos": min(_cosines(got["grads"], ref["grads"])
                                .values())}


def _sds_within(r: dict) -> bool:
    """(c)'s bounds on _sds_readings (see PAR_LOSS_RTOL's note)."""
    return (r["loss_cond_err"] <= PAR_LOSS_RTOL
            and r["rest_rel_err"] <= PAR_LOSS_RTOL
            and r["sds_cond_err"] <= PAR_SDS_RTOL
            and r["g_min_cos"] >= PAR_G_COS and r["n_injections"] > 0
            and r["min_grad_cos"] >= PAR_COS)


def _sub_banks(banks, n: int, seed: int) -> dict:
    """Each stream of a RayBanks cut to n rays (a seeded draw), on the
    host."""
    rng = np.random.default_rng(seed)
    out = {}
    for name in ("rgb_clf", "inp", "depth"):
        st = getattr(banks, name).to("cpu")
        size = st["o"].shape[0]
        keep = torch.from_numpy(rng.choice(size, min(n, size), replace=False))
        out[name] = {k: v[keep].contiguous() for k, v in st.items()}
    return out


def plain_kernels():
    """The render's kernels off on the card (tools/plain_path.py): K1/K2
    through ``field_plain``, K4/K5 through ``field_bwd_plain`` and K3
    through ``merge128_plain``, on the same CUDA tensors (no launch
    counted)."""
    from gbnerf_tpu_torch.tools.plain_path import plain_kernels as plain

    return plain()


def bench_twin_phase(dev) -> dict:
    """bench.py's workload through the port's benchmark
    (gbnerf_tpu_torch/tools/bench.py), its functions called in-process:
    TWIN_REPS renders of TWIN_RAYS rays a loop, best of 3 by CUDA events;
    its JSON line; the K1, K2 and K3 launches of one render (each > 0);
    one render against the plain path of the same fields on the card
    (the kernels off), at MAP_ATOL."""
    from gbnerf_tpu_torch.tools import bench

    _, render, coarse, fine = bench.build(None, dev)
    ro, rd = bench.rays(TWIN_RAYS, torch.Generator().manual_seed(1), dev)
    zero_launches()
    one = bench.one_render_launches(render, ro, rd)
    res = bench.run(render, ro, rd, TWIN_REPS)
    launches = all_launches()
    print(f"bench twin: {TWIN_RAYS} rays x {TWIN_REPS} renders a loop, "
          f"bench.py's fields (coarse {coarse.resolutions} r{coarse.rank}, "
          f"fine {fine.resolutions} r{fine.rank}): "
          f"{res['ms_per_render']:.4f} ms per render, loops "
          f"{', '.join(f'{s:.4f}' for s in res['loop_s'])} s (CUDA events, "
          f"best of {len(res['loop_s'])}), {res['rays_per_s']:.1f} rays/s; "
          f"launches of one render {json.dumps(one)} | {nvidia_smi_line()}")
    print(json.dumps(bench.result_line(res)))
    idle = [k for k, v in one.items() if v <= 0]
    if idle:
        raise AssertionError(f"bench twin: one render launched no {idle}")
    if not (math.isfinite(res["rays_per_s"])
            and math.isfinite(res["checksum"])):
        raise AssertionError(f"bench twin: not finite {res}")
    with torch.no_grad():
        got = render(ro, rd, train=False)
        with plain_kernels():
            ref = render(ro, rd, train=False)
    errs = {}
    for k, atol in MAP_ATOL.items():
        g, r = getattr(got, k), getattr(ref, k)
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"bench twin {k} not finite")
        d = (g - r).abs()
        errs[k] = {"max_abs_err": float(d.max()),
                   "mean_abs_err": float(d.mean()), "atol": atol}
    print(f"bench twin vs plain ({TWIN_RAYS} rays, the kernels off on the "
          f"card): {json.dumps(errs)}")
    for k, e in errs.items():
        if e["max_abs_err"] > e["atol"]:
            raise AssertionError(f"bench twin {k} differs from the plain "
                                 f"path by {e['max_abs_err']} > {e['atol']}")
    return {"launches": launches}


def weights_phase(dev, workdir: Path) -> dict:
    """The real-weights check at WEIGHTS_SD's widths: the port's fake
    checkpoint twin writes a diffusers-layout SD1.5-inpainting checkpoint
    (≈ 1.07 G f32 values) into workdir, then check_weights' main loads it
    in bf16 (strict keys, every parameter overwritten) and runs a 2-step
    DDIM inpaint at 512² through K7; its failure exits (never caught).
    The directory is deleted afterwards."""
    import shutil

    from gbnerf_tpu_torch.ops import attention as at
    from gbnerf_tpu_torch.tools import check_weights, make_fake_sd_ckpt

    tiny = WEIGHTS_SD == "tiny"
    ckpt = workdir / "fake_sd"
    t0 = time.perf_counter()
    make_fake_sd_ckpt.save_ckpt(str(ckpt), tiny=tiny)
    write_s = time.perf_counter() - t0
    nbytes = sum(p.stat().st_size for p in ckpt.rglob("*.safetensors"))
    zero_launches()
    t0 = time.perf_counter()
    times = check_weights.main(
        [str(ckpt), "--allow_hash_tokenizer", "--device", str(dev)]
        + (["--tiny"] if tiny else []))
    check_s = time.perf_counter() - t0
    launches, by_shape = all_launches(), dict(at.LAUNCHES_BY_SHAPE)
    shutil.rmtree(ckpt)
    print(f"weights: fake {WEIGHTS_SD} SD1.5-inpainting checkpoint, "
          f"{nbytes / 1e9:.3f} GB, written in {write_s:.2f} s; check_weights "
          f"{check_s:.2f} s: strict load {times['load_s']:.2f} s, 2-step "
          f"DDIM inpaint {times['ddim_s']:.3f} s; K7 by (N, D) "
          f"{json.dumps({f'{n}x{d}': c for (n, d), c in by_shape.items()})}"
          f" | {nvidia_smi_line()}")
    if launches["attention"] <= 0:
        raise AssertionError("weights: the DDIM inpaint launched no K7")
    return {"launches": launches}


def require_launches(report: dict) -> None:
    """The ranks of (b) launched K1–K5 and those of (c) K1, K3, K4 and
    K7."""
    for label, names in (("b", ("field_fused", "field_fused_sigma",
                                "merge128", "field_fused_bwd",
                                "field_fused_bwd_sigma")),
                         ("c", ("field_fused", "merge128", "field_fused_bwd",
                                "attention"))):
        idle = [n for n in names if report[label]["launches"][n] <= 0]
        if idle:
            raise AssertionError(f"parallel ({label}) launched no {idle}")


def parallel_phase(cfg, dev, scene, depth_gts, disk_datadir: str,
                   workdir: Path) -> dict:
    """torchrun on the card. (a) one NCCL rank through run.py; (b) two gloo
    ranks sharing the card: the data-parallel full-width stage-1 step
    against the one-process step, twice (bit-equal), then timed steps;
    (c) two gloo ranks: the stage-2 step with the full-size SD stack
    tensor-parallel (model = 2) against the unsharded step; (d) the SPMD
    demo twin at its micro size. Two ranks on one card measure
    contention, not scaling. → {"launches": [(b)'s, (c)'s] (summed over
    the ranks), ...}."""
    from gbnerf_tpu_torch.data.rays_bank import build_ray_banks
    from gbnerf_tpu_torch.tools import parallel_check as pc

    torch.cuda.empty_cache()
    never = 10 ** 9
    on = ["--device", dev.type]
    # ---- (a) one NCCL rank through run.py
    sets = [f"data.datadir={disk_datadir}",
            f"data.test_split_count={DISK_VIEWS[1]}",
            "train.first_stage=True", f"train.N_iters={NCCL_STEPS}",
            f"train.i_print={NCCL_PRINT}", f"train.i_weights={never}",
            f"train.i_video={never}", f"train.i_evaluate={never}",
            f"train.i_testset={never}", f"train.basedir={workdir}",
            "train.expname=nccl1", "train.no_reload=True",
            f"train.sigma_loss_weight={SIGMA_LOSS_WEIGHT}"]
    cmd = _torchrun(1) + ["-m", "gbnerf_tpu_torch.run", "--config",
                          str(ROOT / "configs" / "spinnerf_scene.txt"), *on]
    for kv in sets:
        cmd += ["--set", kv]
    t0 = time.perf_counter()
    out = _run_group(cmd, workdir / "nccl1.log", PAR_TIMEOUT)
    wall_a = time.perf_counter() - t0
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if f"rank 0 of 1 ({backend})" not in out:
        raise AssertionError(f"run.py under torchrun did not join a "
                             f"{backend} group of one rank")
    recs = [json.loads(line) for line in
            open(workdir / "nccl1" / "metrics.jsonl")]
    ms_a = [1e3 / r["iters_per_sec"] for r in recs if "iters_per_sec" in r]
    if recs[-1].get("iter") != NCCL_STEPS or not all(
            np.isfinite(v) for v in recs[-1].values() if v is not None):
        raise AssertionError(f"nccl run ended at {recs[-1]}")
    print(f"parallel (a) run.py under torchrun: backend {backend}, world 1, "
          f"{NCCL_STEPS} stage-1 steps of spinnerf_scene (full width, "
          f"N_rand {cfg.train.N_rand}) on the disk scene: ms a step by "
          f"groups of {NCCL_PRINT} {[round(m, 3) for m in ms_a]}, "
          f"img_loss {recs[-1]['img_loss']:.5g}, wall {wall_a:.1f} s "
          f"(process start and kernel load included)")

    # ---- (b) and (c): two gloo ranks on the card, one torchrun
    H, W, focal = scene.hwf
    banks = build_ray_banks(scene.images, scene.masks,
                            scene.inpainted_depths, scene.poses, focal,
                            depth_gts)
    g = torch.Generator().manual_seed(11)

    def draws(cut):
        return {k: torch.randint(0, len(cut[b]["o"]), (PAR_N_RAND,),
                                 generator=g)
                for k, b in (("clf", "rgb_clf"), ("inp", "inp"),
                             ("depth", "depth"))}

    cfg1 = cfg.replace(train=dataclasses.replace(
        cfg.train, first_stage=True, N_rand=PAR_N_RAND,
        sigma_loss_weight=SIGMA_LOSS_WEIGHT))
    cut_b = _sub_banks(banks, PAR_BANK, 0)
    case_b = {"kind": "stage1", "cfg": cfg1, "near": scene.near,
              "far": scene.far, "hwf": scene.hwf, "banks": cut_b, "seed": 1,
              "idx": draws(cut_b), "mesh": (2,), "repeat": True,
              "steps": PAR_STEPS}
    k = PAR_VIEWS
    sub = build_ray_banks(scene.images[:k], scene.masks[:k],
                          scene.inpainted_depths[:k], scene.poses[:k], focal,
                          depth_gts[:k])
    cfg2 = cfg.replace(
        train=dataclasses.replace(cfg.train, first_stage=False,
                                  N_rand=PAR_N_RAND,
                                  sigma_loss_weight=SIGMA_LOSS_WEIGHT),
        guidance=dataclasses.replace(cfg.guidance, sd_allow_random=True,
                                     normal_start_iter=0))
    cut_c = _sub_banks(sub, PAR_BANK, 1)
    case_c = {"kind": "stage2", "cfg": cfg2, "near": scene.near,
              "far": scene.far, "hwf": scene.hwf,
              "scene_dev": {
                  "images": torch.from_numpy(scene.images[:k]),
                  "masks": torch.from_numpy(scene.masks[:k]),
                  "poses": torch.from_numpy(scene.poses[:k]),
                  "mask_coords": torch.from_numpy(sub.mask_coords),
                  "mask_valid": torch.from_numpy(sub.mask_valid)},
              "banks": cut_c, "seed": 2, "idx": dict(draws(cut_c), img=1),
              "guidance": {"sd": PAR_SD[0], "seed": 3,
                           "latent_size": PAR_SD[1], "tp": True},
              "sds_record": True,
              "mesh": (1, 2), "mesh_axes": ("data", "model")}
    spec = workdir / "parallel_spec.pt"
    torch.save({"cases": [case_b, case_c],
                "out": str(workdir / "parallel_out.pt")}, spec)
    t0 = time.perf_counter()
    _run_group(_torchrun(2) + ["-m", "gbnerf_tpu_torch.tools.parallel_check",
                               str(spec), "--dist_backend", "gloo", *on],
               workdir / "parallel.log", PAR_TIMEOUT)
    wall_bc = time.perf_counter() - t0
    got_b, got_c = torch.load(workdir / "parallel_out.pt", weights_only=False)
    # the one-process references, in this process (not main-path launches)
    ref_b = pc.run_case(dict(case_b, repeat=False, steps=0), dev)
    ref_c = pc.run_case(case_c, dev)
    torch.cuda.empty_cache()
    # the same one-process step: another order of summation, f32, and two
    # controls that must fail (the CFG scales 1.1×, other draws)
    g2 = cfg2.guidance
    cfg_x = cfg2.replace(guidance=dataclasses.replace(
        g2, guidance_scale=1.1 * g2.guidance_scale,
        normal_guidance_scale=1.1 * g2.normal_guidance_scale))
    others = {"order": dict(case_c, sd_order="alt"),
              "f32": dict(case_c, guidance=dict(case_c["guidance"],
                                                dtype="float32")),
              "cfg_x1.1": dict(case_c, cfg=cfg_x),
              "draws": dict(case_c, seed=case_c["seed"] + 1)}
    floor = {}
    for name, case in others.items():
        floor[name] = _sds_readings(pc.run_case(case, dev), ref_c,
                                    cfg2.guidance.sds_loss_weight)
        torch.cuda.empty_cache()

    def rel_err(a, b):
        return abs(a - b) / max(abs(b), 1e-30)

    report = {}
    for label, got, ref in (("b", got_b, ref_b), ("c", got_c, ref_c)):
        rel = rel_err(got["loss"], ref["loss"])
        cos = _cosines(got["grads"], ref["grads"])
        worst = min(cos, key=cos.get)
        report[label] = {"world": got["world"], "backend": got["backend"],
                         "loss": got["loss"], "ref_loss": ref["loss"],
                         "loss_rel_err": rel, "min_grad_cos": cos[worst],
                         "min_grad_cos_at": worst,
                         "step_s": got["first_step_s"],
                         "case_s": got["seconds"],
                         "launches": got["launches"]}
        bad = cos[worst] < PAR_COS
        if label == "c":        # the SDS term against its terms' scale
            r = _sds_readings(got, ref, cfg2.guidance.sds_loss_weight)
            report[label].update(r)
            bad = bad or not _sds_within(r)
            for name, rf in floor.items():
                rf["within"] = _sds_within(rf)
            print(f"parallel (c) the one-process step against itself "
                  f"(order: another order of summation; f32; the controls "
                  f"cfg_x1.1 and draws must fail): {json.dumps(floor)}")
            bad = bad or not (floor["order"]["within"]
                              and not floor["cfg_x1.1"]["within"]
                              and not floor["draws"]["within"])
        else:
            bad = bad or rel > PAR_LOSS_RTOL
        if bad:
            raise AssertionError(f"parallel ({label}) differs from one "
                                 f"process: {json.dumps(report[label])}")
    ms_b = got_b["step_ms"]
    report["b"].update(repeat_bit_equal=got_b["repeat_equal"],
                       step_ms_median=float(np.median(ms_b)),
                       last_loss=got_b["last_loss"])
    if not got_b["repeat_equal"]:
        raise AssertionError("the two-rank stage-1 step run twice is not "
                             "bit-equal")
    ratio = got_c["unet_bytes_max"] / ref_c["unet_bytes_max"]
    report["c"].update(unet_bytes_rank=got_c["unet_bytes_max"],
                       unet_bytes_whole=ref_c["unet_bytes_max"],
                       unet_bytes_ratio=ratio,
                       sds_loss=got_c["metrics"]["sds_loss"])
    sds = got_c["metrics"]["sds_loss"]
    if ratio > PAR_BYTES_MAX or not (np.isfinite(sds) and sds != 0.0):
        raise AssertionError(f"parallel (c): {json.dumps(report['c'])}")
    require_launches(report)
    print(f"parallel (b) two gloo ranks on one card, stage 1 at full width, "
          f"{PAR_N_RAND // 2} rays a stream a rank: "
          f"{json.dumps(report['b'])}")
    print(f"parallel (b) {PAR_STEPS} two-rank steps (contention of two "
          f"processes on one card, not scaling): ms a step median "
          f"{report['b']['step_ms_median']:.3f}, groups "
          f"{[round(float(np.median(ms_b[i:i + 10])), 3) for i in range(0, len(ms_b), 10)]}")
    print(f"parallel (c) two gloo ranks, data×model = 1×2, stage 2 with the "
          f"full-size SD stack tensor-parallel: {json.dumps(report['c'])}")
    print(f"parallel (c) UNet parameter bytes a rank {got_c['unet_bytes_max']}"
          f" of {ref_c['unet_bytes_max']} ({ratio:.4f}); (b)+(c) wall "
          f"{wall_bc:.1f} s")

    # ---- (d) the SPMD demo twin at its micro size
    t0 = time.perf_counter()
    demo = workdir / "spmd_demo"
    _run_group([sys.executable, "-m", "gbnerf_tpu_torch.tools.run_spmd_demo",
                str(demo), "--nproc", "2", "--tp", "2", "--dist_backend",
                "gloo", "--iters1", "8", "--iters2", "4", "--n_rand", "128",
                *on],
               workdir / "spmd_demo.log", PAR_TIMEOUT)
    rep = json.loads((demo / "spmd_demo.json").read_text())
    if rep["s1"].get("iter") != 8 or rep["s2"].get("iter") != 12:
        raise AssertionError(f"spmd demo: {rep}")
    print(f"parallel (d) run_spmd_demo --nproc 2 --tp 2 (gloo, micro): "
          f"{json.dumps(rep)}, wall {time.perf_counter() - t0:.1f} s")
    return {"launches": [report["b"]["launches"], report["c"]["launches"]],
            "report": report, "nccl_ms": ms_a}


def _ulp32(a: torch.Tensor, b: torch.Tensor) -> int:
    """max |a − b| in f32 units in the last place."""
    def ordered(x):
        i = x.detach().float().cpu().contiguous().view(torch.int32).long()
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    return int((ordered(a) - ordered(b)).abs().max())


def _twin_draws(key, dev) -> dict:
    """Every draw kind of the twin from ``key`` on ``dev``."""
    from gbnerf_tpu_torch.utils import jax_random as jr

    shape = (1024, 65)
    return {"bits": jr.random_bits(key, shape, dev),
            "uniform": jr.uniform(key, shape, torch.float32, dev),
            "uniform_span": jr.uniform(key, shape, torch.float32, dev,
                                       -3.5, 7.25),
            "randint": jr.randint(key, shape, 0, 100003, dev),
            "normal": jr.normal(key, shape, torch.float32, dev),
            "exponential": jr.exponential(key, shape, torch.float32, dev),
            "truncated_normal": jr.truncated_normal(key, -2.0, 2.0, shape,
                                                    torch.float32, dev)}


def _twin_draws_bf16(key, dev) -> dict:
    """The twin's bf16 draws from ``key`` on ``dev``: the 8-bit words of a
    bf16 uniform, the uniform, the normal (as int16 bit patterns)."""
    from gbnerf_tpu_torch.utils import jax_random as jr

    shape = (1024, 65)
    return {"bits8": jr.random_bits(key, shape, dev, 8),
            "uniform_bf16": jr.uniform(key, shape, torch.bfloat16,
                                       dev).view(torch.int16),
            "normal_bf16": jr.normal(key, shape, torch.bfloat16,
                                     dev).view(torch.int16)}


def _bf16_ulp(a: torch.Tensor, b: torch.Tensor) -> int:
    """max |a − b| in bf16 units in the last place, a and b int16 bit
    patterns."""
    def ordered(x):
        i = x.cpu().to(torch.int64) & 0xFFFF
        return torch.where(i >= 0x8000, -(i & 0x7FFF), i)
    return int((ordered(a) - ordered(b)).abs().max())


def _lora_steps_by_draws(dev) -> dict:
    """ms a full-width LoRA step (the SD1.5-inpainting stack in bf16, rank
    LORA_RANK, batch LORA_BATCH at 512²) with torch's draws and with the
    JAX package's (a JaxKey split once a step as the JAX trainer's loop:
    t, ε and the bf16 posterior ε from the twin), JAX_LORA_REPS steps a
    turn in turns torch, jax, jax, torch."""
    from gbnerf_tpu_torch.config import GuidanceConfig
    from gbnerf_tpu_torch.guidance.stable import build_sd_modules
    from gbnerf_tpu_torch.train import lora_trainer as lt
    from gbnerf_tpu_torch.utils import jax_random as jr

    mods = build_sd_modules(GuidanceConfig(prompt="a photo of a scene"),
                            torch.Generator(device=dev).manual_seed(0),
                            device=dev)
    init_fn, step = lt.make_lora_train_step(mods, rank=LORA_RANK, lr=1e-4,
                                            masked_loss=True)
    adapters, opt = init_fn(jr.PRNGKey(0))
    rng, S = np.random.default_rng(3), mods.latent_size
    with torch.no_grad():
        embeds = mods.text_model(mods.tokenizer(["a photo of a scene"]
                                                * LORA_BATCH))
    batch = {"image": torch.as_tensor(rng.integers(
                 0, 256, (LORA_BATCH, S, S, 3), dtype=np.uint8), device=dev),
             "mask": torch.as_tensor(np.stack([
                 lt.random_mask(rng, S, S) for _ in range(LORA_BATCH)]),
                 device=dev),
             "instance_mask": torch.as_tensor(np.stack([
                 lt.random_mask(rng, S, S) for _ in range(LORA_BATCH)]),
                 device=dev),
             "embeds": embeds}
    gen, key = torch.Generator(device=dev).manual_seed(1), jr.PRNGKey(1)
    times, losses = {"torch": [], "jax": []}, []
    for kind in ("torch", "jax", "jax", "torch"):
        for i in range(JAX_LORA_REPS + 1):
            if i == 1:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            if kind == "jax":
                key, sk = jr.split(key)
            else:
                sk = gen
            losses.append(step(adapters, opt, batch, sk)["loss"])
        torch.cuda.synchronize()
        times[kind].append((time.perf_counter() - t0) * 1e3 / JAX_LORA_REPS)
    if not all(math.isfinite(float(x)) for x in losses):
        raise AssertionError("a full-width LoRA step's loss is not finite")
    del mods, adapters, opt
    torch.cuda.empty_cache()
    return times, S


def jax_draws_phase(cfg, dev, state, scene, depth_gts) -> dict:
    """The twin of jax.random and of the JAX package's init on the card
    (see 23): card against CPU, against jax's literal values (f32 and
    bf16), the CP fields' init, one stage-1 loss and gradient with the
    JAX package's draws against the CPU plain path; a tiny LoRA step, a
    colla step and a Perp-Neg step with the JAX draws against the CPU; ms
    a stage-1 and a full-width LoRA step by draw kind."""
    from gbnerf_tpu_torch.data.rays_bank import build_ray_banks, sample_batch
    from gbnerf_tpu_torch.train.loop import banks_to_device
    from gbnerf_tpu_torch.train.state import create_params, create_train_state
    from gbnerf_tpu_torch.train.step import make_train_step_stage1
    from gbnerf_tpu_torch.utils import jax_random as jr

    cpu = torch.device("cpu")
    worst_ulp = 0
    for part in (True, False):
        # (a) the card against the CPU
        key = jr.key_fold_in(jr.PRNGKey(7, partitionable=part), 3)
        card, host = _twin_draws(key, dev), _twin_draws(key, cpu)
        for k in card:
            if k in ("bits", "uniform", "uniform_span", "randint"):
                if not torch.equal(card[k].cpu(), host[k]):
                    raise AssertionError(f"twin {k} differs card vs CPU")
            else:
                u = _ulp32(card[k], host[k])
                worst_ulp = max(worst_ulp, u)
                if u > JAX_ULP:
                    raise AssertionError(f"twin {k}: {u} ulp card vs CPU")
        card, host = _twin_draws_bf16(key, dev), _twin_draws_bf16(key, cpu)
        for k in ("bits8", "uniform_bf16"):
            if not torch.equal(card[k].cpu(), host[k]):
                raise AssertionError(f"twin {k} differs card vs CPU")
        bf16_ulp = _bf16_ulp(card["normal_bf16"], host["normal_bf16"])
        if bf16_ulp > 1:
            raise AssertionError(f"twin bf16 normal: {bf16_ulp} ulp card vs "
                                 "CPU")
        # (b) against jax's values
        gold = JAX_GOLDEN[part]
        k1, k2, k3 = jr.key_split(jr.PRNGKey(42, partitionable=part), 3)
        f = jr.key_fold_in(k2, 7)
        if ([x.words() for x in (k1, k2, k3)] != gold["split"]
                or f.words() != tuple(gold["fold_in"])):
            raise AssertionError(f"twin keys differ from jax's ({part})")
        got = {"bits": jr.random_bits(f, (5,), dev),
               "uniform": jr.uniform(f, (5,), torch.float32, dev),
               "randint": jr.randint(f, (5,), 0, 100003, dev),
               "normal": jr.normal(f, (5,), torch.float32, dev),
               "exponential": jr.exponential(f, (5,), torch.float32, dev),
               "truncated_normal": jr.truncated_normal(
                   f, -2.0, 2.0, (5,), torch.float32, dev)}
        for k, v in got.items():
            ref = torch.tensor(gold[k], dtype=v.dtype)
            if k in ("bits", "uniform", "randint"):
                if not torch.equal(v.cpu(), ref):
                    raise AssertionError(f"twin {k} differs from jax's")
            elif _ulp32(v, ref) > JAX_ULP:
                raise AssertionError(f"twin {k}: {_ulp32(v, ref)} ulp from "
                                     "jax's")
        got = {"bits8": jr.random_bits(f, (5,), dev, 8),
               "uniform_bf16": jr.uniform(f, (5,), torch.bfloat16,
                                          dev).view(torch.int16),
               "normal_bf16": jr.normal(f, (5,), torch.bfloat16,
                                        dev).view(torch.int16)}
        for k, v in got.items():
            ref = torch.tensor(gold[k], dtype=torch.int64)
            if not torch.equal(v.cpu().to(torch.int64) & 0xFFFF, ref):
                raise AssertionError(f"twin {k} differs from jax's")
    # (c) the full-width CP fields' init from PRNGKey(0)
    t0 = time.perf_counter()
    card_f = create_params(cfg, jr.PRNGKey(0), dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    host_f = create_params(cfg, jr.PRNGKey(0), cpu)
    init_ulp = max(_ulp32(a, b)
                   for fc, fh in zip(card_f, host_f)
                   for a, b in zip(fc.parameters(), fh.parameters()))
    if init_ulp > JAX_ULP:
        raise AssertionError(f"CP init: {init_ulp} ulp card vs CPU")
    # (d) one stage-1 loss and gradient of a JAX-draw run, jitter on (the
    # jitter, the fine samples' sorted uniforms and the streams' indices
    # are the JAX package's draws; σ noise off, as in 6: with it,
    # relu(σ + noise) sits on its kink for some samples, where the
    # kernels' bf16 σ and the plain path's part; the noise itself is held
    # in (a) and (b)), on the fields of (c) and on the trained fields of 5
    banks = build_ray_banks(scene.images, scene.masks, scene.inpainted_depths,
                            scene.poses, scene.hwf[2], depth_gts)
    scfg = cfg.replace(
        render=dataclasses.replace(cfg.render, perturb=1.0,
                                   raw_noise_std=0.0),
        train=dataclasses.replace(cfg.train, N_rand=STEP_RAYS,
                                  sigma_loss_weight=SIGMA_LOSS_WEIGHT))

    def grads(fields, device, rng, plain=False):
        fields = [copy.deepcopy(f).to(device) for f in fields]
        for f in fields:
            for p in f.parameters():
                p.grad = None
        step = make_train_step_stage1(scfg, fields[0], fields[1],
                                      scene.near, scene.far, hwf=scene.hwf)
        bank = banks_to_device(banks, device)
        k_batch, k_loss = jr.split(rng)
        ks = jr.split(k_batch, 3)
        batches = {k: sample_batch(bank[name], STEP_RAYS, kk)
                   for k, name, kk in (("clf", "rgb_clf", ks[0]),
                                       ("inp", "inp", ks[1]),
                                       ("depth", "depth", ks[2]))}
        with plain_kernels() if plain else contextlib.nullcontext():
            loss, _ = step.loss_fn(batches, k_loss)
            loss.backward()
        return loss.item(), {
            f"{n}.{k}": p.grad.detach().cpu().double()
            for n, f in zip(("coarse", "fine"), fields)
            for k, p in f.named_parameters()}

    def compare(a, b):
        (l_a, g_a), (l_b, g_b) = a, b
        cos = {k: float(torch.dot(g_a[k].ravel(), g_b[k].ravel())
                        / (g_a[k].norm() * g_b[k].norm()).clamp_min(1e-300))
               for k in g_b}
        worst = min(cos, key=cos.get)
        return abs(l_a - l_b) / abs(l_b), cos[worst], worst

    key, trained = jr.PRNGKey(JAX_STEP_SEED), state.fields()
    card_gen = lambda: torch.Generator(device=dev).manual_seed(  # noqa
        JAX_STEP_SEED)
    init_cmp = compare(grads(card_f, dev, key), grads(host_f, cpu, key))
    jk, jp = grads(trained, dev, key), grads(trained, dev, key, plain=True)
    cmp = {"init: card vs cpu": init_cmp,
           "trained: card vs cpu": compare(jk, grads(trained, cpu, key)),
           "trained: card plain vs cpu": compare(jp, grads(trained, cpu,
                                                           key)),
           "trained: card vs card plain": compare(jk, jp),
           "trained, torch draws: card vs card plain": compare(
               grads(trained, dev, card_gen()),
               grads(trained, dev, card_gen(), plain=True))}
    print("jax draws: stage-1 loss rel err / min gradient cosine, jitter on: "
          + json.dumps({k: [v[0], v[1], v[2]] for k, v in cmp.items()}))
    # the draws are the subject here: from the same fields, the card replays
    # the CPU's run at the step bounds of 6, with the kernels (the JAX
    # init) and with the card's plain path (the trained fields). The
    # trained fields with the kernels on are held to JAX_TRAINED_COS: on
    # those fields, with jitter, the kernels' bf16 σ moves the fine
    # samples, and their gap to the card's own plain path is the whole
    # card-vs-CPU gap (the last two cases; see JAX_TRAINED_COS)
    for what, bound in (("init: card vs cpu", STEP_GRAD_COS),
                        ("trained: card plain vs cpu", STEP_GRAD_COS),
                        ("trained: card vs cpu", JAX_TRAINED_COS)):
        rel, c, worst = cmp[what]
        if rel > STEP_LOSS_RTOL or c < bound:
            raise AssertionError(f"the JAX-draw step differs, {what}: loss "
                                 f"rel {rel} (limit {STEP_LOSS_RTOL}), "
                                 f"cosine {c} ({worst}, limit {bound})")
    # (f) a tiny LoRA step, a colla step and a Perp-Neg step with the JAX
    # package's draws, card against CPU, at the step bounds of 6 and 9
    lora_jax = _tiny_lora_vs_cpu(dev, jr.PRNGKey(JAX_STEP_SEED))
    s2_jax = stage2_step_vs_plain(cfg, dev, state, np.random.default_rng(8),
                                  key=jr.PRNGKey(JAX_STEP_SEED),
                                  variants=("colla", "perpneg"))
    # (e) ms a full-width stage-1 step by draw kind, in turns (the step
    # of 5)
    tcfg = cfg.replace(train=dataclasses.replace(
        cfg.train, first_stage=True, sigma_loss_weight=SIGMA_LOSS_WEIGHT))
    st, c, f = create_train_state(tcfg, torch.Generator().manual_seed(0),
                                  dev)
    step = make_train_step_stage1(tcfg, c, f, scene.near, scene.far,
                                  hwf=scene.hwf)
    bank = banks_to_device(banks, dev)
    gen, key = torch.Generator(device=dev).manual_seed(0), jr.PRNGKey(0)
    times = {"torch": [], "jax": []}
    zero_launches()
    for kind in ("torch", "jax", "jax", "torch"):
        for i in range(JAX_STEP_REPS + 1):
            if i == 1:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            if kind == "jax":
                key, sk = jr.split(key)
            else:
                sk = gen
            st, m = step(st, bank, sk)
        torch.cuda.synchronize()
        times[kind].append((time.perf_counter() - t0) * 1e3 / JAX_STEP_REPS)
    if not math.isfinite(float(m["loss"])):
        raise AssertionError("the JAX-draw steps' loss is not finite")
    # (g) ms a full-width LoRA step by draw kind
    lora_times, lora_res = _lora_steps_by_draws(dev)
    launches = all_launches()
    ms = {k: float(np.mean(v)) for k, v in times.items()}
    rounded = {k: [round(x, 3) for x in v] for k, v in times.items()}
    lora_ms = {k: float(np.mean(v)) for k, v in lora_times.items()}
    print(f"jax draws: full-width LoRA step (rank {LORA_RANK}, batch "
          f"{LORA_BATCH} at {lora_res}², bf16) {lora_ms['jax']:.3f} ms with the "
          f"JAX package's draws, {lora_ms['torch']:.3f} ms with torch's "
          f"(means of {JAX_LORA_REPS} steps in turns torch, jax, jax, "
          f"torch: {json.dumps({k: [round(x, 3) for x in v] for k, v in lora_times.items()})})")
    print(f"jax draws: the twin card vs CPU in both threefry layouts: keys, "
          f"bits, uniforms, randint equal, the others within {worst_ulp} ulp "
          f"(limit {JAX_ULP}); bf16 words and uniforms equal, bf16 normals "
          f"within 1 bf16 ulp; jax 0.9.0's literal values matched (f32 and "
          f"bf16); the CP "
          f"fields' init from PRNGKey(0) on the card in {init_s:.3f} s, "
          f"{init_ulp} ulp from the CPU's; the stage-1 step with the JAX "
          f"package's draws ({STEP_RAYS} rays a stream) within the bounds "
          f"above; "
          f"full-width stage-1 step ({cfg.train.N_rand} rays a stream) "
          f"{ms['jax']:.3f} ms with the JAX package's draws, "
          f"{ms['torch']:.3f} ms with torch's (means of {JAX_STEP_REPS} "
          f"steps in turns torch, jax, jax, torch: {json.dumps(rounded)}); "
          f"kernel launches {json.dumps(launches)}")
    return {"launches": launches, "ms": ms, "lora_ms": lora_ms,
            "init_ulp": init_ulp, "lora_tiny": lora_jax, "stage2": s2_jax,
            "steps": {k: {"loss_rel_err": v[0], "min_grad_cos": v[1]}
                      for k, v in cmp.items()}}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", type=Path, default=None,
                    help="trace one render and one train step into "
                         "this directory")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this check needs an NVIDIA GPU")
    if not (ROOT / "gbnerf_tpu_torch" / "csrc").is_dir():
        raise SystemExit(f"chip_smoke: no gbnerf_tpu_torch/ beside {ROOT}; "
                         "run it from the root of a checkout")
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from gbnerf_tpu_torch.config import load_reference_config
    from gbnerf_tpu_torch.core.cp_field import CPGridField
    from gbnerf_tpu_torch.ops import _build
    from gbnerf_tpu_torch.train.eval import render_pose_path, save_maps
    from gbnerf_tpu_torch.train.state import create_params
    from gbnerf_tpu_torch.train.step import make_render_fn

    smi = nvidia_smi_line()
    dev = torch.device(DEVICE)
    print(f"card: {smi} | torch {torch.__version__} cuda {torch.version.cuda}")
    # seconds from the start to the end of each phase (host clock)
    t_start, phase_s = time.perf_counter(), {}

    def phase_done(name: str) -> None:
        phase_s[name] = round(time.perf_counter() - t_start, 1)

    # ---- 1. build
    t0 = time.perf_counter()
    lib = _build.build_library()
    _build.load_library()
    print(f"build: {time.perf_counter() - t0:.2f} s (nvcc "
          f"{_build.build_seconds if _build.build_seconds is not None else 0.0:.2f} s, "
          f"one process per source) -> {lib.relative_to(ROOT)}")
    for line in _build.ptxas_log.splitlines():
        if "registers" in line or "spill" in line or "Performance" in line:
            print(f"ptxas: {line.strip()}")

    # ---- 2. fields of the shipped config, seeded
    cfg = load_reference_config(str(ROOT / "configs" / "spinnerf_scene.txt"))
    coarse, fine = create_params(cfg, torch.Generator().manual_seed(0), dev)
    proposal = CPGridField(bound=cfg.field.cp_bound, resolutions=(17, 33, 65),
                           rank=8, device=dev,
                           generator=torch.Generator().manual_seed(1))
    np_rng = np.random.default_rng(0)
    field_kernel_info(fine, coarse, proposal)

    # ---- 3. each kernel vs its plain version, at main-path shapes
    with torch.no_grad():
        field_res = check_fields(dev, fine, coarse, proposal, np_rng)
        merge_res = check_merge(dev, np_rng)
    field_res.update(check_field_bwd(dev, fine, coarse, np_rng))
    check_field_widths(dev, np_rng)
    attn_res = check_attention(dev)
    cp_res = check_cp_encode(dev, np_rng)
    check_cp_positions(dev)
    phase_done("build and kernel checks")

    # ---- 4. the eval render path: launches counted from here ...
    render = make_render_fn(cfg, coarse, fine, near=NEAR, far=FAR)
    rng = np.random.default_rng(1)
    ro_np = (rng.standard_normal((BENCH_RAYS, 3)) * 0.1).astype(np.float32)
    rd_np = rng.standard_normal((BENCH_RAYS, 3)).astype(np.float32)
    rd_np /= np.linalg.norm(rd_np, axis=-1, keepdims=True)
    ro, rd = torch.from_numpy(ro_np).to(dev), torch.from_numpy(rd_np).to(dev)
    zero_launches()
    with torch.no_grad():
        # (a) 16384 rays of the shipped config's fields
        out = render(ro, rd, train=False)                  # warm
        torch.cuda.synchronize()
        group_ms = []                 # host time shares its cores: 5 groups
        for _ in range(5):
            t0 = time.perf_counter()
            for _ in range(5):
                out = render(ro, rd, train=False)
            torch.cuda.synchronize()
            group_ms.append((time.perf_counter() - t0) * 1e3 / 5)
    ms = float(np.median(group_ms))
    rays_per_s = BENCH_RAYS / (ms / 1e3)
    print(f"render (configs/spinnerf_scene.txt fields): {BENCH_RAYS} rays, "
          f"64+64 samples, coarse field {coarse.resolutions} "
          f"r{coarse.rank}, fine {fine.resolutions} r{fine.rank}: {ms:.3f} "
          f"ms per render (median of 5 groups of 5: "
          f"{', '.join(f'{g:.3f}' for g in group_ms)}), {rays_per_s:.1f} "
          f"rays/s")
    for k in ("rgb", "acc", "depth", "disp"):
        t = getattr(out, k)
        assert bool(torch.isfinite(t).all()), f"render {k} not finite"

    # (b) full views through render_pose_path at the config's render_block
    focal = 0.5 * VIEW_W / np.tan(0.5 * np.deg2rad(60.0))
    poses = camera_arc(N_VIEWS)
    render_pose_path(render, poses[:1], (VIEW_H, VIEW_W, focal),
                     block=cfg.render.render_block, device=dev)   # warm
    t0 = time.perf_counter()
    maps = render_pose_path(render, poses, (VIEW_H, VIEW_W, focal),
                            block=cfg.render.render_block, device=dev)
    view_ms = (time.perf_counter() - t0) * 1e3 / N_VIEWS
    render_launches = all_launches()
    # ... to here
    print(f"views: {N_VIEWS} x {VIEW_H}x{VIEW_W} at render_block "
          f"{cfg.render.render_block}: {view_ms:.3f} ms per image "
          f"(maps to host included)")
    print(f"launches on the render path: {json.dumps(render_launches)}")
    for k, v in maps.items():
        assert np.isfinite(v).all(), f"view {k} not finite"
    assert maps["rgb"].shape == (N_VIEWS, VIEW_H, VIEW_W, 3)
    acc_lo, acc_hi = float(maps["acc"].min()), float(maps["acc"].max())
    print(f"views: acc in [{acc_lo:.6f}, {acc_hi:.6f}], rgb in "
          f"[{maps['rgb'].min():.4f}, {maps['rgb'].max():.4f}], depth mean "
          f"{maps['depth'].mean():.4f}")
    assert acc_lo >= 0.0 and acc_hi <= 1.0 + ACC_SLACK, "acc outside [0, 1]"
    with tempfile.TemporaryDirectory() as tmp:
        for k, p in save_maps(maps, tmp).items():
            assert np.array_equal(np.load(p), maps[k]), f"{k}.npy round trip"
    for k in ("field_fused", "field_fused_sigma", "merge128"):
        if render_launches[k] <= 0:
            raise AssertionError(f"kernel {k} was not launched by the path")

    # (c) the path vs the plain path (same fields on the CPU), ray subset
    sub = slice(0, SUBSET_RAYS)
    with torch.no_grad():
        got = render(ro[sub], rd[sub], train=False)
        cpu_render = make_render_fn(cfg, copy.deepcopy(coarse).cpu(),
                                    copy.deepcopy(fine).cpu(), NEAR, FAR)
        ref = cpu_render(torch.from_numpy(ro_np[sub]),
                         torch.from_numpy(rd_np[sub]), train=False)
    slice_err = {}
    for k, atol in MAP_ATOL.items():
        d = (getattr(got, k).cpu() - getattr(ref, k)).abs()
        slice_err[k] = {"max_abs_err": float(d.max()),
                        "mean_abs_err": float(d.mean()), "atol": atol}
    print(f"slice vs plain ({SUBSET_RAYS} rays): {json.dumps(slice_err)}")
    for k, e in slice_err.items():
        if e["max_abs_err"] > e["atol"]:
            raise AssertionError(f"slice {k} differs from the plain path by "
                                 f"{e['max_abs_err']} > {e['atol']}")
    if args.profile is not None:
        with torch.no_grad():
            profile_once(lambda: render(ro, rd, train=False), "render",
                         args.profile, ms)
    phase_done("render")
    # ---- 21. the bench twin at bench.py's workload (its own counts)
    twin = bench_twin_phase(dev)
    phase_done("bench twin")
    # ---- 22. a full-width fake SD checkpoint through check_weights (its
    # own counts)
    with tempfile.TemporaryDirectory() as wdir:
        weights = weights_phase(dev, Path(wdir))
    phase_done("weights")

    # ---- 5. stage-1 training through train() (its own launch counts)
    t0 = time.perf_counter()
    scene, depth_gts = spinnerf_scene(TRAIN_VIEWS, VIEW_H, VIEW_W)
    print(f"scene: {len(scene.images)} views of {VIEW_H}x{VIEW_W} + "
          f"{len(scene.poses_test)} held out, "
          f"{sum(len(d['depth']) for d in depth_gts)} depth keypoints, "
          f"made in {time.perf_counter() - t0:.2f} s")
    with tempfile.TemporaryDirectory() as workdir:
        phase_done("scene")
        out, step_ms, step_launches, eval_launches = stage1_train(
            cfg, dev, scene, depth_gts, Path(workdir))
        phase_done("stage 1")
        # ---- 8. stage 2 from the stage-1 checkpoint (its own counts)
        out2, step2_ms, stage2_launches, cfg2, _ = stage2_train(
            cfg, dev, scene, depth_gts, Path(workdir), TRAIN_STEPS)
        phase_done("stage 2")
        # ---- 16. stage 2 with colla and with Perp-Neg, and stage 1 with
        # the frozen σ of the stage-1 checkpoints (each its own counts)
        colla_launches = stage2_train(
            cfg, dev, scene, depth_gts, Path(workdir), TRAIN_STEPS,
            label="colla", steps=COLLA_STEPS, every=VARIANT_PRINT,
            profile_dir=args.profile, is_colla_guidance=True)[2]
        phase_done("colla")
        perpneg_launches = stage2_train(
            cfg, dev, scene, depth_gts, Path(workdir), TRAIN_STEPS,
            label="perpneg", steps=PERPNEG_STEPS, every=VARIANT_PRINT,
            profile_dir=args.profile, perpneg=True)[2]
        phase_done("perpneg")
        frozen = frozen_sigma_phase(cfg, dev, scene, depth_gts,
                                    Path(workdir))
        phase_done("frozen σ")
        # ---- 19. the hash-grid field: stage 1, the checks of 6, the
        # render and stage 2 (each main path its own counts); native
        hash_res = hash_phase(cfg, dev, scene, depth_gts, Path(workdir),
                              ro, rd, args.profile)
        phase_done("hash")
    # ---- 17. CLIP guidance, card vs CPU
    check_clip(dev)
    phase_done("clip")
    state = out["state"]
    sds_gradient_check(cfg2, dev, out2, scene)
    # ---- 13. the disk phase: scene to disk and back, s1 → nog (own counts)
    disk_dir = tempfile.TemporaryDirectory()
    disk = disk_phase(dev, Path(disk_dir.name))
    check_lpips(dev)
    phase_done("disk")
    # ---- 18. a Blender scene from disk through train(), render_only and
    # export_mesh (its own counts), then the kernels at its shapes
    with tempfile.TemporaryDirectory() as blender_dir:
        blender = blender_phase(dev, Path(blender_dir), field_res)
    phase_done("blender")
    # ---- 14. the guided arms on the disk scene: prior → LoRA → priorNL
    guided = guided_phase(dev, Path(disk_dir.name))
    phase_done("guided")
    # ---- 15. the full-size LoRA fine-tune and DDIM inpaint (own counts)
    lora_res = lora_phase(dev, disk["datadir"], args.profile)
    phase_done("lora")

    # ---- 6. one step on the card vs the same step on the CPU plain path,
    # and one full-width step twice from one state (bit-equal)
    step_vs_plain(cfg, dev, state, scene, depth_gts)
    stage1_step_twice(cfg, dev, state, scene, depth_gts)
    phase_done("stage-1 step vs plain, twice")
    # ---- 23. the JAX package's draws on the card (its own counts)
    jax_res = jax_draws_phase(cfg, dev, state, scene, depth_gts)
    phase_done("jax draws")
    # ---- 9. one stage-2 step on the card vs the CPU plain path
    stage2_step_vs_plain(cfg, dev, state, np.random.default_rng(7))
    phase_done("stage-2 steps vs plain")
    # ---- 11. the profiling entry points (their own counts)
    with tempfile.TemporaryDirectory() as workdir:
        prof_launches = profile_paths(Path(workdir))
    phase_done("profilers")
    # ---- 20. the parallel phase: torchrun on the card (ranks' own counts)
    with tempfile.TemporaryDirectory() as workdir:
        par = parallel_phase(cfg, dev, scene, depth_gts, disk["datadir"],
                             Path(workdir))
    phase_done("parallel")

    if args.profile is not None:
        profile_stage1_step(cfg, dev, state, scene, depth_gts, "train_step",
                            args.profile, step_ms)
        profile_stage2(cfg2, dev, out2, scene, args.profile, step2_ms)
        profile_nog(dev, disk, args.profile)
        profile_prior_nl(dev, guided, args.profile)
    disk_dir.cleanup()

    paths = [render_launches, twin["launches"], weights["launches"],
             step_launches, eval_launches, stage2_launches,
             colla_launches, perpneg_launches, frozen["launches"],
             disk["launches"], blender["launches"], guided["launches"],
             lora_res["launches"], jax_res["launches"],
             *hash_res["launches"],
             *prof_launches.values(), *par["launches"]]
    path_launches = {k: sum(p[k] for p in paths) for k in render_launches}
    kernels = [
        {"name": "field_fused", "route": "cuda",
         "source": "gbnerf_tpu_torch/csrc/field_fused.cu",
         "replaces": "gbnerf_tpu/ops/field_fused.py:131"},
        {"name": "field_fused_sigma", "route": "cuda",
         "source": "gbnerf_tpu_torch/csrc/field_fused.cu",
         "replaces": "gbnerf_tpu/ops/field_fused.py:247"},
        {"name": "merge128", "route": "cuda",
         "source": "gbnerf_tpu_torch/csrc/resample.cu",
         "replaces": "gbnerf_tpu/ops/resample.py:154"},
        {"name": "field_fused_bwd", "route": "cuda",
         "source": "gbnerf_tpu_torch/csrc/field_fused_bwd.cu",
         "replaces": "gbnerf_tpu/ops/field_fused.py:379"},
        {"name": "field_fused_bwd_sigma", "route": "cuda",
         "source": "gbnerf_tpu_torch/csrc/field_fused_bwd.cu",
         "replaces": "gbnerf_tpu/ops/field_fused.py:439"},
        {"name": "attention", "route": "cuda",
         "source": "gbnerf_tpu_torch/csrc/attention.cu",
         "replaces": "gbnerf_tpu/ops/attention.py:47"},
        {"name": "cp_encode", "route": "cuda",
         "source": "gbnerf_tpu_torch/csrc/cp_encode.cu",
         "replaces": "gbnerf_tpu/ops/cp_pallas.py:69"},
    ]
    field_res.update(attention=attn_res, merge128=merge_res,
                     cp_encode=cp_res)
    for k in kernels:
        checks = field_res[k["name"]]
        main_shape = checks[0]                    # the main-path shape
        # bound_by in the line's words: K7's check lines name the
        # operations that set it (exp or products)
        by = main_shape["bound_by"]
        k.update(launches=path_launches[k["name"]],
                 max_abs_err=max(c["max_abs_err"] for c in checks),
                 ms=main_shape["ms"], plain_ms=main_shape["plain_ms"],
                 bound_ms=main_shape["bound_ms"],
                 bound_by="bytes" if by == "bytes" else "operations",
                 library_ms=main_shape.get("library_ms"))
        if by not in ("bytes", "operations"):
            k["bound_set_by"] = by
        if k["launches"] <= 0:
            raise AssertionError(f"kernel {k['name']} was launched on no "
                                 "path")
    phase_done("end")
    print(f"phases: seconds from the start at the end of each "
          f"{json.dumps(phase_s)}")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
