"""Plain reference of the NeRF side: the CP grid field, the hash grid
field, the hierarchical volume render, the ray banks, the stage-1 loss
and Adam.

A frozen copy of the port's plain equations (gbnerf_tpu_torch/core/
cp_field.py, fields.py, encoding.py, render.py, sampling.py,
ops/resample.py, data/rays_bank.py, train/step.py, train/losses.py and
train/state.py at commit e283e2e), in float32 with no kernel and no
packing; it imports nothing of the port. The CP field interpolates each
level's own lines (the port upsamples them onto the finest grid, which is
the same function) and its products run in float32 (the port's in bf16).

Draws: the port passes one torch.Generator through every split, so its
draws are one stream in the order it makes them. The reference makes the
same draws, of the same kinds and shapes, in the same order, from a
generator seeded alike: per stream the batch indices, then per render
the coarse jitter, the coarse σ noise, the fine-sample exponentials and
the fine σ noise.

``PRECISION["products"]`` = "fp8" rounds each product's operands to fp8
e4m3 (one scale a tensor): the control.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

PRECISION = {"products": "f32"}
_HASH_PRIMES = (1, 2654435761, 805459861)
_C0 = 0.28209479177387814
_C1 = 0.4886025119029199
_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
       -1.0925484305920792, 0.5462742152960396)
_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
       0.3731763325901154, -0.4570457994644658, 1.445305721320277,
       -0.5900435899266435)


def quant(x: torch.Tensor) -> torch.Tensor:
    if PRECISION["products"] == "f32":
        return x
    if PRECISION["products"] == "bf16":
        return x + (x.to(torch.bfloat16).to(x.dtype) - x).detach()
    amax = x.detach().abs().amax().float().clamp_min(1e-30)
    scale = amax / 448.0
    q = (x.float() / scale).to(torch.float8_e4m3fn).float() * scale
    return x + (q - x).detach()


def mm(a, b):
    return quant(a) @ quant(b)


def sh_encode(d: torch.Tensor) -> torch.Tensor:
    """Real spherical harmonics of degree 4 of unit directions →
    [..., 16]."""
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    xx, yy, zz = x * x, y * y, z * z
    xy, yz, xz = x * y, y * z, x * z
    return torch.stack([
        torch.full_like(x, _C0), -_C1 * y, _C1 * z, -_C1 * x,
        _C2[0] * xy, _C2[1] * yz, _C2[2] * (2.0 * zz - xx - yy), _C2[3] * xz,
        _C2[4] * (xx - yy),
        _C3[0] * y * (3.0 * xx - yy), _C3[1] * xy * z,
        _C3[2] * y * (4.0 * zz - xx - yy),
        _C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
        _C3[4] * x * (4.0 * zz - xx - yy), _C3[5] * z * (xx - yy),
        _C3[6] * x * (xx - 3.0 * yy)], dim=-1)


def cp_field(p: Dict[str, torch.Tensor], bound: float, pts, viewdirs,
             sigma_only: bool = False):
    """The CP grid field: per level l and axis a, line lines_l[a] ([R, rank])
    interpolated linearly at the point, the axes multiplied, the levels
    concatenated; a 2 × 64 σ net (16 outputs: σ and 15 geometry features)
    and a 3 × 64 colour net on SH(viewdirs) ‖ geometry. Weights ws0 … wc2
    are [in, out]. → raw [..., 4] (rgb logits ‖ σ)."""
    x = ((pts + bound) / pts.new_full((), 2.0 * bound)).reshape(
        -1, 3).clamp(0.0, 1.0)
    feats = []
    for l in range(sum(1 for k in p if k.startswith("lines_"))):
        line = p[f"lines_{l}"]
        R = line.shape[1]
        prod = None
        for a in range(3):
            u = x[:, a] * (R - 1)
            i0 = torch.clamp(torch.floor(u), 0, R - 2).long()
            f = (u - i0.float())[:, None]
            fa = line[a][i0] * (1.0 - f) + line[a][i0 + 1] * f
            prod = fa if prod is None else prod * fa
        feats.append(prod)
    enc = torch.cat(feats, dim=-1)
    h = mm(torch.relu(mm(enc, p["ws0"])), p["ws1"])
    sigma = h[:, :1]
    if sigma_only:
        rgb = torch.zeros((h.shape[0], 3), device=h.device)
    else:
        sh = sh_encode(viewdirs.float()).expand(
            pts.shape[:-1] + (16,)).reshape(-1, 16)
        hc = torch.cat([sh, h[:, 1:]], dim=-1)
        hc = torch.relu(mm(hc, p["wc0"]))
        rgb = mm(torch.relu(mm(hc, p["wc1"])), p["wc2"])
    return torch.cat([rgb, sigma], dim=-1).reshape(*pts.shape[:-1], 4)


def hash_levels(n_levels: int, base: int, bound: float,
                finest_per_unit: int = 2048) -> List[int]:
    scale = float(np.exp2(np.log2(finest_per_unit * bound / base)
                          / (n_levels - 1)))
    return [int(np.floor(base * scale ** lvl)) for lvl in range(n_levels)]


def hash_field(p: Dict[str, torch.Tensor], c: dict, pts, viewdirs,
               sigma_only: bool = False):
    """The hash grid field (the reference's NeRF_TCNN): per level, the 8
    corners of the point's cell index the level's table densely while
    (N_l + 1)³ ≤ T, else by x ⊕ y·2654435761 ⊕ z·805459861 (mod T);
    the corner features blended trilinearly; a 2 × 64 σ net and a 3 × 64
    colour net without biases (nn.Linear weights [out, in])."""
    table = p["hash_table"]
    L, T, F_ = table.shape
    res = hash_levels(L, c["base_res"], c["bound"])
    x = ((pts + c["bound"]) / pts.new_full((), 2.0 * c["bound"])).reshape(
        -1, 3).float()
    out = []
    for l, r in enumerate(res):
        pos = x * r
        p0 = torch.floor(pos)
        fr = pos - p0
        i0 = p0.long()
        dense = (r + 1) ** 3 <= T
        acc = 0.0
        for corner in range(8):
            o = [(corner >> 2) & 1, (corner >> 1) & 1, corner & 1]
            ci = [i0[:, a] + o[a] for a in range(3)]
            if dense:
                idx = ci[0] + ci[1] * (r + 1) + ci[2] * (r + 1) ** 2
            else:
                idx = (ci[0] * _HASH_PRIMES[0]) ^ (ci[1] * _HASH_PRIMES[1]) \
                    ^ (ci[2] * _HASH_PRIMES[2])
            idx = idx & (T - 1)
            w = 1.0
            for a in range(3):
                w = w * (fr[:, a] if o[a] else 1.0 - fr[:, a])
            acc = acc + table[l][idx] * w[:, None]
        out.append(acc)
    h = torch.cat(out, dim=-1)
    h = torch.relu(mm(h, p["sigma_0.weight"].t()))
    h = mm(h, p["sigma_out.weight"].t())
    sigma = h[:, :1]
    if sigma_only:
        rgb = torch.zeros((h.shape[0], 3), device=h.device)
    else:
        sh = sh_encode(viewdirs.float()).expand(
            pts.shape[:-1] + (16,)).reshape(-1, 16)
        hc = torch.relu(mm(torch.cat([sh, h[:, 1:]], -1),
                           p["color_0.weight"].t()))
        hc = torch.relu(mm(hc, p["color_1.weight"].t()))
        rgb = mm(hc, p["color_out.weight"].t())
    return torch.cat([rgb, sigma], dim=-1).reshape(*pts.shape[:-1], 4)


def raw2outputs(raw, z, rays_d, noise, white_bkgd):
    dists = z[..., 1:] - z[..., :-1]
    dists = torch.cat([dists, torch.full_like(dists[..., :1], 1e10)], -1)
    dists = dists * torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    rgb = torch.sigmoid(raw[..., :3])
    sigma = raw[..., 3] if noise is None else raw[..., 3] + noise
    alpha = 1.0 - torch.exp(-torch.relu(sigma) * dists)
    trans = torch.cumprod(torch.cat([torch.ones_like(alpha[..., :1]),
                                     1.0 - alpha[..., :-1] + 1e-10], -1), -1)
    w = alpha * trans
    rgb_map = torch.sum(w[..., None] * rgb, -2)
    depth = torch.sum(w * z, -1)
    acc = torch.sum(w, -1)
    disp = torch.minimum(
        1.0 / torch.clamp(depth / torch.clamp(acc, min=1e-10), min=1e-10),
        1.0 / torch.clamp(z[..., 0], min=1e-10))
    if white_bkgd:
        rgb_map = rgb_map + (1.0 - acc[..., None])
    return {"rgb": rgb_map, "disp": disp, "acc": acc, "depth": depth,
            "weights": w}


def sample_pdf(bins, weights, n, u):
    """Inverse CDF by the clamp-sum identity z(u) = bins₀ + Σ_b Δbins_b ·
    clamp((u − cdf_b)/pdf_b, 0, 1), weights + 1e-5."""
    w = weights + 1e-5
    pdf = w / torch.sum(w, -1, keepdim=True)
    cdf = torch.cumsum(pdf, -1)
    lo = torch.cat([torch.zeros_like(cdf[..., :1]), cdf[..., :-1]], -1)
    db = bins[..., 1:] - bins[..., :-1]
    frac = torch.clamp((u[..., :, None] - lo[..., None, :])
                       / torch.clamp(pdf, min=1e-12)[..., None, :], 0.0, 1.0)
    return bins[..., :1] + torch.sum(frac * db[..., None, :], -1)


def render(field, rays_o, rays_d, near, far, r: dict, *, train: bool,
           gen: Optional[torch.Generator] = None):
    """The coarse → fine render of a ray batch, as the port's make_render_fn
    and render_rays (non-NDC): stratified samples (linear in disparity
    with lindisp), jittered and σ-noised while training; the fine samples
    at sorted uniforms (linspace at eval) through the coarse weights; the
    merged 64 + 64 depths. field(pts, viewdirs, sigma_only, fine)."""
    dev = rays_o.device
    n_rays = rays_o.shape[0]
    viewdirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    S, I = r["N_samples"], r["N_importance"]
    near_t = torch.full((n_rays, 1), near, device=dev)
    far_t = torch.full((n_rays, 1), far, device=dev)
    t = torch.linspace(0.0, 1.0, S, device=dev)
    if r["lindisp"]:
        z = 1.0 / (1.0 / near_t * (1.0 - t) + 1.0 / far_t * t)
    else:
        z = near_t * (1.0 - t) + far_t * t
    perturb = train and r["perturb"] > 0
    noise_std = r["raw_noise_std"] if train else 0.0

    def noise(shape):
        if noise_std <= 0:
            return None
        return torch.randn(shape, generator=gen, device=dev) * noise_std

    if perturb:
        mids = 0.5 * (z[..., 1:] + z[..., :-1])
        upper = torch.cat([mids, z[..., -1:]], -1)
        lower = torch.cat([z[..., :1], mids], -1)
        z = lower + (upper - lower) * torch.rand(z.shape, generator=gen,
                                                 device=dev)
    vd = viewdirs[:, None, :]
    pts = rays_o[:, None, :] + rays_d[:, None, :] * z[..., None]
    raw = field(pts, vd, sigma_only=not train, fine=False)
    coarse = raw2outputs(raw, z, rays_d, noise(z.shape), r["white_bkgd"])
    mid = 0.5 * (z[..., 1:] + z[..., :-1])
    if perturb:
        e = torch.empty((n_rays, I + 1), device=dev).exponential_(
            generator=gen)
        s = torch.cumsum(e, -1)
        u = s[..., :-1] / s[..., -1:]
    else:
        u = torch.linspace(0.0, 1.0, I, device=dev).expand(n_rays, I)
    zs = sample_pdf(mid, coarse["weights"][..., 1:-1].detach(), I,
                    u).detach()
    z_all = torch.sort(torch.cat([z, zs], -1), dim=-1, stable=True).values
    pts = rays_o[:, None, :] + rays_d[:, None, :] * z_all[..., None]
    raw = field(pts, vd, sigma_only=False, fine=True)
    fine = raw2outputs(raw, z_all, rays_d, noise(z_all.shape),
                       r["white_bkgd"])
    fine["rgb0"] = coarse["rgb"]
    return fine


def pixel_rays(H: int, W: int, focal: float, c2w: torch.Tensor, xs, ys):
    """Rays through pixel coordinates (x, y) of a camera [3, 4]."""
    dirs = torch.stack([(xs - W * 0.5) / focal, -(ys - H * 0.5) / focal,
                        -torch.ones_like(xs)], -1)
    rays_d = torch.sum(dirs[..., None, :] * c2w[:3, :3], -1)
    return c2w[:3, -1].expand(rays_d.shape), rays_d


def banks(scene: dict, dev) -> Dict[str, Dict[str, torch.Tensor]]:
    """The streams the stage-1 step samples: unmasked pixels with their
    colour (clf) and their inpainted disparity (inp), and the COLMAP rays
    outside the mask with (depth, weight) — each in view order, pixels in
    row-major order."""
    imgs, masks = scene["images"], scene["masks"]
    N, H, W = imgs.shape[:3]
    focal = scene["hwf"][2]
    jj, ii = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                            torch.arange(W, dtype=torch.float32, device=dev),
                            indexing="ij")
    o_l, d_l, c_l, inp_l, do_l, dd_l, dt_l = [], [], [], [], [], [], []
    for k in range(N):
        c2w = torch.as_tensor(scene["poses"][k][:3, :4], device=dev)
        keep = torch.as_tensor(masks[k] != 1, device=dev).reshape(-1)
        o, d = pixel_rays(H, W, focal, c2w, ii, jj)
        o_l.append(o.reshape(-1, 3)[keep])
        d_l.append(d.reshape(-1, 3)[keep])
        c_l.append(torch.as_tensor(imgs[k], device=dev).reshape(-1, 3)[keep])
        inp_l.append(torch.as_tensor(scene["inpainted_depths"][k],
                                     device=dev).reshape(-1, 1)[keep])
        g = scene["depth_gts"][k]
        yy = np.minimum(g["coord"][:, 1].astype(int), H - 1)
        xx = np.minimum(g["coord"][:, 0].astype(int), W - 1)
        sel = masks[k][yy, xx] == 0
        coord = torch.as_tensor(g["coord"][sel], device=dev)
        o, d = pixel_rays(H, W, focal, c2w, coord[:, 0], coord[:, 1])
        do_l.append(o)
        dd_l.append(d)
        dt_l.append(torch.as_tensor(np.stack([g["depth"][sel],
                                              g["weight"][sel]], -1),
                                    device=dev))
    cat = torch.cat
    return {"clf": {"o": cat(o_l), "d": cat(d_l), "target": cat(c_l)},
            "inp": {"o": cat(o_l), "d": cat(d_l), "target": cat(inp_l)},
            "depth": {"o": cat(do_l), "d": cat(dd_l), "target": cat(dt_l)}}


def stage1_loss(field, bk, near, far, cfg: dict, n_rand: int, gen):
    """The stage-1 loss of one step: N_rand rays of each stream, drawn
    with replacement; colour MSE of the fine and coarse maps, the
    inpainted disparity's MSE · depth_lambda, the COLMAP depth's weighted
    MSE · sdepth_lambda (the hash field has no CP lines, so no TV term)."""
    r = cfg["render"]
    batch = {k: torch.randint(0, bk[k]["o"].shape[0], (n_rand,),
                              generator=gen, device=bk[k]["o"].device)
             for k in ("clf", "inp", "depth")}
    take = {k: {f: v[batch[k]] for f, v in bk[k].items()} for k in batch}
    out = render(field, take["clf"]["o"], take["clf"]["d"], near, far, r,
                 train=True, gen=gen)
    tgt = take["clf"]["target"]
    loss = torch.mean((out["rgb"] - tgt) ** 2) \
        + torch.mean((out["rgb0"] - tgt) ** 2)
    out_i = render(field, take["inp"]["o"], take["inp"]["d"], near, far, r,
                   train=True, gen=gen)
    loss = loss + cfg["depth_lambda"] * torch.mean(
        (out_i["disp"] - take["inp"]["target"][:, 0]) ** 2)
    out_d = render(field, take["depth"]["o"], take["depth"]["d"], near, far,
                   r, train=True, gen=gen)
    t = take["depth"]["target"]
    loss = loss + cfg["sdepth_lambda"] * torch.mean(
        t[:, 1] * (out_d["depth"] - t[:, 0]) ** 2)
    return loss


class Adam:
    """Adam (β 0.9, 0.999, ε 1e-8) at lr(step) = lrate·0.1^(step /
    (decay·1000)), the step counted before the update."""

    def __init__(self, params: Dict[str, torch.Tensor], lrate: float,
                 decay: int):
        self.p, self.lrate, self.decay = params, lrate, decay
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self):
        lr = self.lrate * 0.1 ** (self.t / (self.decay * 1000.0))
        self.t += 1
        for k, p in self.p.items():
            g = p.grad
            self.m[k].mul_(0.9).add_(g, alpha=0.1)
            self.v[k].mul_(0.999).addcmul_(g, g, value=0.001)
            den = (self.v[k] / (1 - 0.999 ** self.t)).sqrt() + 1e-8
            p.sub_(lr * (self.m[k] / (1 - 0.9 ** self.t)) / den)
