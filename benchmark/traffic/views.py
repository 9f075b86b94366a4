"""Traffic kind "views": full views rendered along a seeded camera arc, a
closed loop of one view after another, as render_only renders its path.

Set-up builds the port's coarse and fine CP fields with the benchmark's
seeded weights (untrained fields) and the eval renderer (make_render_fn →
make_image_renderer at the configuration's render_block, as render_only
renders its path), and renders each pose of the pool once to warm up.
The window renders the pool's poses in turn (one pass at least); a view's
latency runs from the call to its maps (rgb, disp, depth, acc) copied to
the host. ``view_ms_p95`` is the 95th percentile of all the window's
views.

After the window the fields are freed and the plain reference
(reference/nerf.py) renders a seeded sample of the pool's poses; each is
compared with the maps the window returned for that pose.
"""
from __future__ import annotations

import time

import numpy as np

from benchmark.harness import nerf as hn
from benchmark.harness import weights as wt
from benchmark.harness.common import span, sub_seed
from benchmark.inputs import scene as sc


def pool_rays(poses, H, W, focal, dev):
    """Each pose's rays [H, W, 3] (origins, directions) on the card: the
    inputs of a view, made once (as render_pose_path's camera rays)."""
    import torch

    j, i = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                          torch.arange(W, dtype=torch.float32, device=dev),
                          indexing="ij")
    out = []
    for c2w in poses:
        c = torch.as_tensor(c2w, device=dev)
        dirs = torch.stack([(i - W * 0.5) / focal, -(j - H * 0.5) / focal,
                            -torch.ones_like(i)], -1)
        d = torch.sum(dirs[..., None, :] * c[:3, :3], -1)
        out.append((c[:3, -1].expand(d.shape).contiguous(), d))
    return out


def run(ctx) -> dict:
    import torch

    from gbnerf_tpu_torch.train.state import create_train_state
    from gbnerf_tpu_torch.train.step import (make_image_renderer,
                                             make_render_fn)

    c, p, dev, seed = ctx.config, ctx.params, ctx.device, ctx.seed
    cfg = hn.port_config(c["flags"], ctx.scratch)
    s = c["scene"]
    H, W = s["H"], s["W"]
    focal = 1.2 * W
    state, coarse, fine = create_train_state(
        cfg, torch.Generator().manual_seed(0), dev)
    wt.fill_field(coarse, sub_seed(seed, 1))
    wt.fill_field(fine, sub_seed(seed, 2))
    p0 = {f"{w}.{k}": v.detach().clone()
          for w, m in (("coarse", coarse), ("fine", fine))
          for k, v in m.named_parameters()}
    render_fn = make_render_fn(cfg, coarse, fine, sc.NEAR, sc.FAR,
                               hwf=(H, W, focal))
    image = make_image_renderer(render_fn, block=cfg.render.render_block)
    poses = sc.camera_arc(p["pool"], seed=sub_seed(seed, 3))
    rays = pool_rays(poses, H, W, focal, dev)
    rng = np.random.default_rng(sub_seed(seed, 4))
    sample = sorted(rng.choice(p["pool"], p["check_views"], replace=False))
    kept = {}

    def view(k):
        with span("render"):
            maps = image(*rays[k % len(rays)])
        with span("to_host"):
            return {name: v.cpu().numpy() for name, v in maps.items()}

    ctx.mark("the fields and the rays")
    for k in range(len(rays)):               # warm-up: every pose once
        view(k)
    ctx.mark("one view of each pose")

    out = {"attempted": 0, "failed": 0, "end_to_end": {}, "work": {}}
    lat = []
    t0 = ctx.window_opens()
    if ctx.trace:
        n = p["trace_views"]
        ctx.traced(lambda: [view(k) for k in range(n)])
    else:
        n = 0
        while True:
            a = time.perf_counter()
            maps = view(n)
            lat.append(time.perf_counter() - a)
            if n % len(rays) in sample and n % len(rays) not in kept:
                kept[n % len(rays)] = maps
            n += 1
            # at least one pass over the pool, so that every sampled view
            # is answered in the window
            if time.perf_counter() - t0 >= ctx.seconds and n >= len(rays):
                break
        ctx.window_closes()
        out["end_to_end"]["view_ms_p95"] = float(
            np.percentile(np.asarray(lat) * 1e3, 95))
    out["attempted"] = out["work"]["views"] = n
    ctx.read_memory_peak()
    if ctx.trace:         # the sample's maps, outside the traced window
        kept = {k: view(k) for k in sample}
    missing = [k for k in sample if k not in kept]
    out["failed"] = len(missing)
    del image, render_fn, state, coarse, fine
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    gaps = compare(cfg, p0, {k: rays[k] for k in sample if k in kept},
                   kept, p["row_block"])
    out["checks"] = [(k, v, p["limits"][k]) for k, v in gaps.items()
                     if k in p["limits"]] + [
        ("views_missing", float(len(missing)), 0.0)]
    out["readings"] = gaps
    if ctx.trace:
        from benchmark.counts import nerf as nc

        w = nc.view_work(cfg, H, W, cfg.render.render_block)
        out["work"]["flops"] = n * w["flops"]
        out["work"]["k1"] = {k: n * v for k, v in w["k1"].items()}
    return out


def render_ref(cfg, p0, rays, row_block, precision="f32") -> dict:
    """One view's maps {rgb, acc} by the reference, row blocks at a time."""
    import torch

    from benchmark.harness.common import no_tf32
    from benchmark.reference import nerf as ref

    bound = cfg.field.cp_bound
    split = {w: {k.split(".", 1)[1]: v.float() for k, v in p0.items()
                 if k.startswith(w + ".")} for w in ("coarse", "fine")}

    def field(pts, vd, sigma_only=False, fine=False):
        return ref.cp_field(split["fine" if fine else "coarse"], bound, pts,
                            vd, sigma_only)

    r = hn.render_dict(cfg)
    o, d = (x.reshape(-1, 3) for x in rays)
    ref.PRECISION["products"] = precision
    try:
        with no_tf32(), torch.no_grad():
            parts = [ref.render(field, o[s:s + row_block],
                                d[s:s + row_block], sc.NEAR, sc.FAR, r,
                                train=False)
                     for s in range(0, o.shape[0], row_block)]
    finally:
        ref.PRECISION["products"] = "f32"
    return {k: torch.cat([q[k] for q in parts]).cpu().numpy()
            for k in ("rgb", "acc")}


def compare(cfg, p0, rays, kept, row_block) -> dict:
    """The reference's maps of the sampled views against the window's:
    for rgb and for acc, the worst view's mean absolute gap over its
    pixels. (A largest gap would judge a few pixels: where an untrained
    field's σ at the last sample lies near 0, its sign under rounding
    decides whether the 1e10 terminal interval makes that pixel opaque,
    and acc there differs by up to 1 between any two precisions.)"""
    gaps = {"rgb_mean_err": 0.0, "acc_mean_err": 0.0}
    for k, r in rays.items():
        want = render_ref(cfg, p0, r, row_block)
        for m in ("rgb", "acc"):
            got = np.asarray(kept[k][m]).reshape(want[m].shape)
            gaps[m + "_mean_err"] = max(gaps[m + "_mean_err"], float(
                np.abs(got - want[m]).mean()))
    return gaps


def control(ctx, precision: str = "fp8"):
    """The control: the reference with its products in fp8 e4m3 (the
    configuration's fields compute in bf16) put in the program's place,
    held against the reference by the run's own checks →
    (checks, readings)."""
    import torch

    from gbnerf_tpu_torch.train.state import create_train_state

    c, p, dev, seed = ctx.config, ctx.params, ctx.device, ctx.seed
    cfg = hn.port_config(c["flags"], ctx.scratch)
    H, W = c["scene"]["H"], c["scene"]["W"]
    _, coarse, fine = create_train_state(
        cfg, torch.Generator().manual_seed(0), dev)
    wt.fill_field(coarse, sub_seed(seed, 1))
    wt.fill_field(fine, sub_seed(seed, 2))
    p0 = {f"{w}.{k}": v.detach().clone()
          for w, m in (("coarse", coarse), ("fine", fine))
          for k, v in m.named_parameters()}
    del coarse, fine
    poses = sc.camera_arc(p["pool"], seed=sub_seed(seed, 3))
    rays = pool_rays(poses, H, W, 1.2 * W, dev)
    rng = np.random.default_rng(sub_seed(seed, 4))
    sample = sorted(rng.choice(p["pool"], p["check_views"], replace=False))
    low = {k: render_ref(cfg, p0, rays[k], p["row_block"], precision)
           for k in sample}
    gaps = compare(cfg, p0, {k: rays[k] for k in sample}, low,
                   p["row_block"])
    return [(k, v, p["limits"][k]) for k, v in gaps.items()
            if k in p["limits"]], gaps
