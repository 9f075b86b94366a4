"""The seeded SPIn-NeRF-sized scene, frozen.

Copied from chip_smoke.py::spinnerf_scene and the functions it uses from
gbnerf_tpu_torch/tools/make_synthetic_scene.py (look_at, render_scene,
dilate, MAIN_SPHERE, INTRUDER), both at commit e283e2e, so that later
changes to the port cannot move the benchmark's inputs. Numpy only; it
returns plain arrays, and the traffic kinds hand them to the port's own
scene type.

The scene: n_train views (plus n_test held out) of a lambertian sphere on
a sky gradient along a forward arc, label masks (the dilated silhouette of
an intruder sphere), inpainted disparities, and COLMAP-style depth rays
(200 surface pixels a view, z-depth, weights 2·exp(−(err/ē)²)). The seed
draws the depth rays and their errors; the views are the same for every
seed, so every seed gives the same sizes.
"""
from __future__ import annotations

import numpy as np

MAIN_SPHERE = (np.zeros(3), 0.5, np.array([0.8, 0.35, 0.25]))
INTRUDER = (np.array([0.45, -0.05, 0.95]), 0.22, np.array([0.2, 0.65, 0.3]))
NEAR, FAR = 1.0, 4.5


def look_at(pos, target=np.zeros(3), up=np.array([0.0, 1.0, 0.0])):
    z = pos - target
    z = z / np.linalg.norm(z)            # camera backward (OpenGL)
    x = np.cross(up, z)
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    return np.stack([x, y, z, pos], axis=1).astype(np.float32)  # [3,4]


def render_scene(H, W, focal, c2w, spheres=(MAIN_SPHERE,), *,
                 light=(0.5, 0.7, 0.5), sky_tint=(0.6, 0.7, 0.9)):
    """Analytic render of lambertian spheres on a sky gradient →
    (img [H,W,3], depth [H,W], hit_id [H,W]: −1 sky, else the sphere)."""
    j, i = np.mgrid[0:H, 0:W].astype(np.float32)
    dirs = np.stack([(i - W / 2) / focal, -(j - H / 2) / focal,
                     -np.ones_like(i)], -1)
    rd = dirs @ c2w[:3, :3].T
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    ro = c2w[:3, 3]
    light = np.asarray(light, np.float64)
    light = light / np.linalg.norm(light)
    t_best = np.full((H, W), np.inf, np.float32)
    hit_id = np.full((H, W), -1, np.int32)
    img = np.stack([0.5 + 0.3 * rd[..., 1]] * 3, -1) * np.asarray(sky_tint)
    for si, (center, radius, albedo) in enumerate(spheres):
        oc = ro - np.asarray(center)
        b = 2 * rd @ oc
        c = oc @ oc - radius ** 2
        disc = b ** 2 - 4 * c
        hit = disc > 0
        t = np.where(hit, (-b - np.sqrt(np.maximum(disc, 0))) / 2, np.inf)
        closer = (t > 0) & (t < t_best)
        pts = ro + np.where(closer, t, 0.0)[..., None] * rd
        n = (pts - np.asarray(center)) / radius
        lam = np.clip(n @ light, 0, 1)
        shade = np.asarray(albedo) * (0.2 + 0.8 * lam[..., None])
        img = np.where(closer[..., None], shade, img)
        t_best = np.where(closer, t, t_best)
        hit_id = np.where(closer, si, hit_id)
    depth = np.where(np.isfinite(t_best), t_best, 4.0).astype(np.float32)
    return img.astype(np.float32), depth, hit_id


def dilate(mask: np.ndarray, it: int = 2) -> np.ndarray:
    """Binary dilation by ``it`` 4-neighbourhood steps."""
    m = mask.astype(bool)
    for _ in range(it):
        m = (m | np.roll(m, 1, 0) | np.roll(m, -1, 0)
             | np.roll(m, 1, 1) | np.roll(m, -1, 1))
    return m


def arc_pose(k: int, n: int) -> np.ndarray:
    th = (k / (n - 1) - 0.5) * 0.9
    return look_at(np.array([2.5 * np.sin(th), 0.3 * np.sin(2 * th),
                             2.5 * np.cos(th)]))


def spinnerf_scene(n_train: int, H: int, W: int, n_test: int = 2,
                   seed: int = 0) -> dict:
    """The scene as arrays: images [n,H,W,3], masks [n,H,W], inpainted
    disparities (normalised) [n,H,W], poses [n,3,5] (c2w ‖ hwf), the
    held-out poses and images, hwf, near, far, and depth_gts (one dict a
    training view: coord [k,2] (x, y), depth [k], weight [k])."""
    rng = np.random.default_rng(seed)
    focal = 1.2 * W
    n = n_train + n_test
    test_idx = [(k + 1) * n // (n_test + 1) for k in range(n_test)]
    imgs, masks, disps, poses, depth_gts = [], [], [], [], []
    for k in range(n):
        c2w = arc_pose(k, n)
        img, depth, _ = render_scene(H, W, focal, c2w)
        _, _, hit = render_scene(H, W, focal, c2w, (MAIN_SPHERE, INTRUDER))
        imgs.append(img)
        masks.append(dilate(hit == 1, it=2).astype(np.float32))
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
    return {"images": imgs[train], "masks": masks[train],
            "inpainted_depths": (disps / disps.max())[train].astype(
                np.float32),
            "poses": poses[train], "poses_test": poses[test_idx],
            "images_test": imgs[test_idx], "masks_test": masks[test_idx],
            "hwf": (H, W, focal), "near": NEAR, "far": FAR,
            "depth_gts": [depth_gts[k] for k in train]}


def camera_arc(n: int, radius: float = 2.5, seed: int = 0) -> np.ndarray:
    """n c2w poses [n, 3, 4] along the scene's arc, looking at the origin,
    each at an angle drawn from the seed inside the training views' span
    and sorted: every seed gives n views of the same size."""
    rng = np.random.default_rng(seed)
    th = np.sort(rng.uniform(-0.45, 0.45, n))
    return np.stack([look_at(np.array([radius * np.sin(t),
                                       0.3 * np.sin(2 * t),
                                       radius * np.cos(t)])) for t in th])
