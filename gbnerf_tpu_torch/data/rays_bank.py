"""Ray banks and uniform batch sampling.

Port of gbnerf_tpu/data/rays_bank.py. The banks are built once on the host
as struct-of-arrays float32 numpy (``build_ray_banks``, identical to the
JAX package's), moved to the device once (``RayStream.to``), and each step
gathers a uniform with-replacement batch from them on the device
(``sample_batch``), so the training loop moves no ray data between host
and device.

Streams (the reference's run.py:1126-1146 semantics):
  rgb       rays with mask label == 1 (inpaint region)
  rgb_clf   rays with mask label == 0 (ground-truth supervised)
  rgb_sds   all rays
  inp       mask==0 rays with inpainted-depth (disparity) targets
  depth     COLMAP keypoint rays with depth + error-weight targets
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from ..utils import jax_random as jr


@dataclass
class RayStream:
    """A flat bank of rays with per-ray targets (host numpy)."""

    rays_o: np.ndarray   # [N, 3]
    rays_d: np.ndarray   # [N, 3]
    target: np.ndarray   # [N, C] (rgb: 3; inp: 1 disparity; depth: 2 = depth, weight)

    def __len__(self):
        return len(self.rays_o)

    def to(self, device) -> Dict[str, torch.Tensor]:
        """The stream as {"o", "d", "target"} tensors on ``device``."""
        return {k: torch.as_tensor(np.ascontiguousarray(v), device=device)
                for k, v in (("o", self.rays_o), ("d", self.rays_d),
                             ("target", self.target))}


def _full_image_rays_np(H, W, focal, c2w):
    i, j = np.meshgrid(np.arange(W, dtype=np.float32),
                       np.arange(H, dtype=np.float32), indexing="xy")
    dirs = np.stack([(i - W * 0.5) / focal, -(j - H * 0.5) / focal,
                     -np.ones_like(i)], -1)
    rays_d = np.sum(dirs[..., None, :] * c2w[:3, :3], -1)
    rays_o = np.broadcast_to(c2w[:3, -1], rays_d.shape)
    return rays_o, rays_d


def _rays_by_coord_np(H, W, focal, c2w, coords):
    x = (coords[:, 0] - W * 0.5) / focal
    y = -(coords[:, 1] - H * 0.5) / focal
    dirs = np.stack([x, y, -np.ones_like(x)], -1)
    rays_d = np.sum(dirs[..., None, :] * c2w[:3, :3], -1)
    rays_o = np.broadcast_to(c2w[:3, -1], rays_d.shape)
    return rays_o, rays_d


@dataclass
class RayBanks:
    """All training ray streams + per-image masked-pixel tables."""

    rgb: RayStream            # masked rays (stage-1 only in the reference)
    rgb_clf: RayStream        # unmasked rays, GT rgb targets
    rgb_sds: RayStream        # all rays
    inp: RayStream            # unmasked rays, inpainted-disparity targets
    depth: Optional[RayStream]  # colmap-depth rays (depth, weight targets)
    # Stage-2 per-image masked pixel coords, padded: [N_img, K_max, 2] int32
    mask_coords: np.ndarray
    mask_valid: np.ndarray    # [N_img, K_max] bool
    mask_counts: np.ndarray   # [N_img] int32


def build_ray_banks(
    images: np.ndarray,          # [N, H, W, 3]
    masks: np.ndarray,           # [N, H, W] (1 = inpaint)
    inpainted_depths: np.ndarray,  # [N, H, W]
    poses: np.ndarray,           # [N, 3, 5]
    focal: float,
    depth_gts: Optional[List[dict]] = None,
    *,
    filter_depth_by_mask: bool = True,
) -> RayBanks:
    """Build all ray streams from loaded scene arrays (host, once)."""
    N, H, W = images.shape[:3]
    # Poses may carry the LLFF hwf column ([3, 5]); only the [3, 4] c2w part
    # feeds ray generation (column -1 must be the translation).
    poses = poses[:, :3, :4]
    ro_l, rd_l, rgb_l, msk_l, inp_l = [], [], [], [], []
    for k in range(N):
        ro, rd = _full_image_rays_np(H, W, focal, poses[k])
        ro_l.append(ro.reshape(-1, 3))
        rd_l.append(rd.reshape(-1, 3))
        rgb_l.append(images[k].reshape(-1, 3))
        msk_l.append(masks[k].reshape(-1))
        inp_l.append(inpainted_depths[k].reshape(-1))
    ro = np.concatenate(ro_l).astype(np.float32)
    rd = np.concatenate(rd_l).astype(np.float32)
    rgb = np.concatenate(rgb_l).astype(np.float32)
    msk = np.concatenate(msk_l)
    inp = np.concatenate(inp_l).astype(np.float32)

    masked = msk == 1
    unmasked = ~masked
    streams = dict(
        rgb=RayStream(ro[masked], rd[masked], rgb[masked]),
        rgb_clf=RayStream(ro[unmasked], rd[unmasked], rgb[unmasked]),
        rgb_sds=RayStream(ro, rd, rgb),
        inp=RayStream(ro[unmasked], rd[unmasked], inp[unmasked, None]),
    )

    depth_stream = None
    if depth_gts is not None:
        dro, drd, dt = [], [], []
        for k in range(min(N, len(depth_gts))):
            g = depth_gts[k]
            coord, depth, weight = g["coord"], g["depth"], g["weight"]
            if filter_depth_by_mask and len(coord):
                # Keep only keypoints outside the inpaint mask (run.py:1095-1107).
                yy = np.minimum(coord[:, 1].astype(int), H - 1)
                xx = np.minimum(coord[:, 0].astype(int), W - 1)
                keep = masks[k][yy, xx] == 0
                coord, depth, weight = coord[keep], depth[keep], weight[keep]
            if not len(coord):
                continue
            o, d = _rays_by_coord_np(H, W, focal, poses[k], coord)
            dro.append(o)
            drd.append(d)
            dt.append(np.stack([depth, weight], -1))
        if dro:
            depth_stream = RayStream(
                np.concatenate(dro).astype(np.float32),
                np.concatenate(drd).astype(np.float32),
                np.concatenate(dt).astype(np.float32),
            )

    # Per-image masked pixel tables for stage-2 (static K_max padding).
    counts = np.array([(masks[k] == 1).sum() for k in range(N)], np.int32)
    k_max = max(int(counts.max()), 1)
    coords = np.zeros((N, k_max, 2), np.int32)
    valid = np.zeros((N, k_max), bool)
    for k in range(N):
        yy, xx = np.nonzero(masks[k] == 1)
        coords[k, :len(yy), 0] = xx
        coords[k, :len(yy), 1] = yy
        valid[k, :len(yy)] = True

    return RayBanks(mask_coords=coords, mask_valid=valid, mask_counts=counts,
                    depth=depth_stream, **streams)


def sample_batch(stream: Dict[str, torch.Tensor], n: int,
                 generator: Optional[torch.Generator] = None,
                 idx: Optional[torch.Tensor] = None
                 ) -> Dict[str, torch.Tensor]:
    """A uniform with-replacement batch of ``n`` rays from a device stream.

    The draw comes from ``generator`` (a torch.Generator on the stream's
    device, or a JaxKey: the JAX package's ``randint`` from that key), or
    is injected as ``idx`` [n].
    """
    size = stream["o"].shape[0]
    if idx is None:
        idx = jr.randint_(generator, 0, size, (n,), stream["o"].device)
    else:
        idx = torch.as_tensor(idx, device=stream["o"].device)
    return {k: v.index_select(0, idx) for k, v in stream.items()}
