"""Work of the NeRF paths at a cell's shapes, counted from the plain
reference's equations (reference/nerf.py), never from the port.

``head_macs`` and ``field_call_work`` are chip_smoke.py's head_macs and
kernel_bound (commit e283e2e), FLOPs and bytes only: a field call reads
its points (and SH directions) and writes raw, and reads the lines and
the weights once; its heads cost 2 FLOPs a multiply-add in bf16, its
encode ENC_OPS f32 operations a feature (three two-tap lerps and the two
products of the axes).
"""
from __future__ import annotations

import math

ENC_OPS = 11
SIGMA_WIDTH, GEO, SH_DIM, COLOR_WIDTH = 64, 16, 16, 64


def head_macs(feat: int, sigma_only: bool) -> int:
    """Multiply-adds a point of the σ (and colour) heads."""
    macs = feat * SIGMA_WIDTH + SIGMA_WIDTH * GEO
    if sigma_only:
        return macs
    return macs + (SH_DIM + GEO - 1) * COLOR_WIDTH \
        + COLOR_WIDTH * COLOR_WIDTH + COLOR_WIDTH * 3


def field_call_work(points: int, feat: int, r_max: int, sigma_only: bool
                    ) -> dict:
    """{bf16_flops, f32_ops, bytes} of one forward call of the fused CP
    field (K1, or K2 when σ-only) over ``points`` points."""
    lines = 3 * r_max * feat * 4
    macs = head_macs(feat, sigma_only)
    per_point = 12 + 16 + (0 if sigma_only else 64)       # x, raw; sh
    return {"bf16_flops": 2.0 * points * macs,
            "f32_ops": float(points) * feat * ENC_OPS,
            "bytes": float(points * per_point + lines + macs * 4)}


def field_feat(cfg) -> int:
    f = cfg.field
    if f.field_type == "hash":
        return f.n_levels * f.n_features
    return len(f.cp_resolutions) * f.cp_rank


def stage1_step_flops(c: dict, cfg) -> float:
    """Model FLOPs of one stage-1 step: three streams of N_rand rays, each
    through the coarse field at N_samples and the fine field at
    N_samples + N_importance points, all with colour; the backward twice
    the forward (the heads' input and weight gradients)."""
    r, feat = cfg.render, field_feat(cfg)
    pts = 3 * cfg.train.N_rand * (r.N_samples + r.N_samples + r.N_importance)
    return 3 * 2.0 * pts * head_macs(feat, False)


def view_work(cfg, H: int, W: int, block: int) -> dict:
    """One full view through the eval render (blocks of ``block`` rays):
    {flops: the heads' model FLOPs (coarse σ-only, fine with colour), k1:
    the fine pass's field calls' field_call_work summed}."""
    r, feat = cfg.render, field_feat(cfg)
    rays = H * W
    r_max = max(cfg.field.cp_resolutions)
    flops = 2.0 * rays * (r.N_samples * head_macs(feat, True)
                          + (r.N_samples + r.N_importance)
                          * head_macs(feat, False))
    k1 = {"bf16_flops": 0.0, "f32_ops": 0.0, "bytes": 0.0}
    for s in range(0, rays, block):
        n = min(block, rays - s) * (r.N_samples + r.N_importance)
        w = field_call_work(n, feat, r_max, False)
        k1 = {k: k1[k] + w[k] for k in k1}
    return {"flops": flops, "k1": k1, "calls": math.ceil(rays / block)}
