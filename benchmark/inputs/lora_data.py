"""The LoRA fine-tune's instance data: seeded images, instance masks and
captions, written as files for the port's dataset to read, and the
host-side draws of its batches replayed for the reference.

The images are the scene of inputs/scene.py seen from the seed's cameras
at the training resolution (so the dataset's area resize is the identity
and the reference can take the arrays as written); the instance masks are
the intruder's dilated silhouettes; each image has a caption file.
``random_mask`` and ``batch_draws`` are frozen copies of
gbnerf_tpu_torch/train/lora_trainer.py::random_mask and of the draw order
of DreamBoothInpaintDataset.batch (commit e283e2e).
"""
from __future__ import annotations

import os
import struct
import zlib
from typing import List, Tuple

import numpy as np

from . import scene as sc

PROMPT = "a photo of a stone park bench"


def write_png(path: str, img: np.ndarray) -> None:
    """8-bit grey or RGB PNG (filter 0 on every row)."""
    img = np.ascontiguousarray(img, np.uint8)
    h, w = img.shape[:2]
    ctype = 0 if img.ndim == 2 else 2
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))

    def chunk(tag, data):
        c = struct.pack(">I", len(data)) + tag + data
        return c + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)

    with open(path, "wb") as fh:
        fh.write(b"\x89PNG\r\n\x1a\n")
        fh.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0,
                                            0, 0)))
        fh.write(chunk(b"IDAT", zlib.compress(raw, 1)))
        fh.write(chunk(b"IEND", b""))


def make(out: str, n: int, res: int, seed: int
         ) -> Tuple[np.ndarray, np.ndarray, List[str]]:
    """Write n images, masks and captions under out/{images,masks} →
    (images u8 [n, res, res, 3], instance masks [n, res, res] in {0, 1},
    captions), in the dataset's (sorted file name) order."""
    os.makedirs(os.path.join(out, "images"), exist_ok=True)
    os.makedirs(os.path.join(out, "masks"), exist_ok=True)
    focal = 1.2 * res
    poses = sc.camera_arc(n, seed=seed)
    imgs, masks, caps = [], [], []
    for k in range(n):
        img, _, _ = sc.render_scene(res, res, focal, poses[k])
        _, _, hit = sc.render_scene(res, res, focal, poses[k],
                                    (sc.MAIN_SPHERE, sc.INTRUDER))
        u8 = np.clip(np.rint(img * 255.0), 0, 255).astype(np.uint8)
        m = sc.dilate(hit == 1, it=2)
        stem = f"view_{k:03d}"
        write_png(os.path.join(out, "images", stem + ".png"), u8)
        write_png(os.path.join(out, "masks", stem + ".png"),
                  m.astype(np.uint8) * 255)
        cap = f"{PROMPT}, view {k}"
        with open(os.path.join(out, "images", stem + ".txt"), "w") as fh:
            fh.write(cap)
        imgs.append(u8)
        masks.append(m.astype(np.float32))
        caps.append(cap)
    return np.stack(imgs), np.stack(masks), caps


def random_mask(rng: np.random.Generator, h: int, w: int,
                ratio=(0.25, 1.0)) -> np.ndarray:
    """A random rectangle or ellipse (the reference's random_mask)."""
    mask = np.zeros((h, w), np.float32)
    size = rng.uniform(*ratio)
    mw = max(int(w * size * rng.uniform(0.5, 1.0)), 4)
    mh = max(int(h * size * rng.uniform(0.5, 1.0)), 4)
    x0 = rng.integers(0, max(w - mw, 1))
    y0 = rng.integers(0, max(h - mh, 1))
    if rng.random() < 0.5:
        mask[y0:y0 + mh, x0:x0 + mw] = 1.0
    else:
        yy, xx = np.mgrid[0:h, 0:w]
        cy, cx = y0 + mh / 2, x0 + mw / 2
        mask[((xx - cx) / (mw / 2)) ** 2
             + ((yy - cy) / (mh / 2)) ** 2 <= 1] = 1.0
    return mask


def batch_draws(rng: np.random.Generator, n_images: int, batch: int,
                res: int) -> Tuple[np.ndarray, np.ndarray]:
    """One batch's host draws, in the dataset's order: the image indices,
    then a random mask a sample → (idx [B], masks u8 [B, res, res])."""
    idx = rng.integers(0, n_images, batch)
    masks = np.stack([random_mask(rng, res, res) for _ in range(batch)])
    return idx, masks.astype(np.uint8)
