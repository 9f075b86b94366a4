"""COLMAP sparse-model I/O (cameras / images / points3D, binary and text).

The port's copy of gbnerf_tpu/data/colmap.py: that module is numpy-only,
but importing it through ``gbnerf_tpu.data`` loads JAX (the package's
``__init__`` imports ``rays_bank``), which the machine with the card does
not have. tests/test_torch_data.py holds the two copies equal. One
difference: ``read_images_text`` keeps the empty point line of an image
with no 2-D points (the JAX copy drops it and mis-pairs the images after).

Capability parity with the reference's vendored read_write_model
(the reference DS_NeRF/colmapUtils/read_write_model.py) — written fresh
against the public COLMAP binary format spec
(https://colmap.github.io/format.html). Pure numpy, host-side only; the
training path consumes the derived arrays (poses, per-image depth samples),
never these record objects.
"""
from __future__ import annotations

import os
import struct
from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np

# camera model id → (name, num_params) per the COLMAP spec.
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3), 1: ("PINHOLE", 4), 2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5), 4: ("OPENCV", 8), 5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12), 7: ("FOV", 5), 8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5), 10: ("THIN_PRISM_FISHEYE", 12),
}
CAMERA_MODEL_IDS = {name: mid for mid, (name, _) in CAMERA_MODELS.items()}


@dataclass
class Camera:
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray


@dataclass
class Image:
    id: int
    qvec: np.ndarray        # [4] (w, x, y, z)
    tvec: np.ndarray        # [3]
    camera_id: int
    name: str
    xys: np.ndarray         # [N, 2]
    point3D_ids: np.ndarray  # [N] int64, -1 = unmatched


@dataclass
class Point3D:
    id: int
    xyz: np.ndarray         # [3]
    rgb: np.ndarray         # [3] uint8
    error: float
    image_ids: np.ndarray   # [T]
    point2D_idxs: np.ndarray  # [T]


def qvec2rotmat(q):
    """Quaternion (w, x, y, z) → 3×3 rotation matrix."""
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def rotmat2qvec(R):
    """3×3 rotation → quaternion (w, x, y, z), w >= 0."""
    K = np.array([
        [R[0, 0] - R[1, 1] - R[2, 2], 0, 0, 0],
        [R[0, 1] + R[1, 0], R[1, 1] - R[0, 0] - R[2, 2], 0, 0],
        [R[0, 2] + R[2, 0], R[1, 2] + R[2, 1], R[2, 2] - R[0, 0] - R[1, 1], 0],
        [R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1],
         R[0, 0] + R[1, 1] + R[2, 2]],
    ]) / 3.0
    vals, vecs = np.linalg.eigh(K)
    q = vecs[[3, 0, 1, 2], np.argmax(vals)]
    return q * np.sign(q[0]) if q[0] != 0 else q


def _read(f, fmt):
    return struct.unpack(fmt, f.read(struct.calcsize(fmt)))


def _read_string(f) -> str:
    out = bytearray()
    while True:
        c = f.read(1)
        if not c or c == b"\x00":
            return out.decode("utf-8")
        out += c


def read_cameras_binary(path: str) -> Dict[int, Camera]:
    cams = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            cid, model_id, width, height = _read(f, "<iiQQ")
            name, num_params = CAMERA_MODELS[model_id]
            params = np.array(_read(f, f"<{num_params}d"))
            cams[cid] = Camera(cid, name, width, height, params)
    return cams


def read_images_binary(path: str) -> Dict[int, Image]:
    images = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            vals = _read(f, "<idddddddi")
            iid, qvec, tvec, cam_id = (
                vals[0], np.array(vals[1:5]), np.array(vals[5:8]), vals[8]
            )
            name = _read_string(f)
            (npts,) = _read(f, "<Q")
            data = np.frombuffer(f.read(24 * npts),
                                 dtype=[("xy", "<f8", 2), ("id", "<i8")])
            images[iid] = Image(iid, qvec, tvec, cam_id, name,
                                data["xy"].copy(), data["id"].copy())
    return images


def read_points3d_binary(path: str) -> Dict[int, Point3D]:
    points = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            vals = _read(f, "<QdddBBBd")
            pid = vals[0]
            xyz = np.array(vals[1:4])
            rgb = np.array(vals[4:7], np.uint8)
            error = vals[7]
            (tlen,) = _read(f, "<Q")
            track = np.frombuffer(f.read(8 * tlen),
                                  dtype=[("img", "<i4"), ("p2d", "<i4")])
            points[pid] = Point3D(pid, xyz, rgb, error,
                                  track["img"].copy(), track["p2d"].copy())
    return points


def read_cameras_text(path: str) -> Dict[int, Camera]:
    cams = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            cid = int(parts[0])
            cams[cid] = Camera(cid, parts[1], int(parts[2]), int(parts[3]),
                               np.array([float(p) for p in parts[4:]]))
    return cams


def read_images_text(path: str) -> Dict[int, Image]:
    images = {}
    with open(path) as f:
        lines = iter([ln.strip() for ln in f if not ln.startswith("#")])
    # two lines per image; an image with no 2-D points has an EMPTY second
    # line, which must still be paired with its head (the JAX package's
    # reader drops empty lines and mis-pairs every later image)
    for head in lines:
        if not head:
            continue
        pts = next(lines, "")
        parts = head.split()
        iid = int(parts[0])
        qvec = np.array([float(p) for p in parts[1:5]])
        tvec = np.array([float(p) for p in parts[5:8]])
        cam_id = int(parts[8])
        name = parts[9]
        e = np.array(pts.split(), dtype=np.float64).reshape(-1, 3) if pts else \
            np.zeros((0, 3))
        images[iid] = Image(iid, qvec, tvec, cam_id, name, e[:, :2],
                            e[:, 2].astype(np.int64))
    return images


def read_points3d_text(path: str) -> Dict[int, Point3D]:
    points = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            pid = int(parts[0])
            track = np.array(parts[8:], dtype=np.int64).reshape(-1, 2) \
                if len(parts) > 8 else np.zeros((0, 2), np.int64)
            points[pid] = Point3D(
                pid, np.array(parts[1:4], np.float64),
                np.array(parts[4:7], np.uint8), float(parts[7]),
                track[:, 0].astype(np.int32), track[:, 1].astype(np.int32))
    return points


def write_cameras_text(cams: Dict[int, Camera], path: str) -> None:
    """COLMAP cameras.txt (parity: read_write_model.py write_cameras_text;
    same '# Camera list ...' header scheme)."""
    with open(path, "w") as f:
        f.write("# Camera list with one line of data per camera:\n"
                "#   CAMERA_ID, MODEL, WIDTH, HEIGHT, PARAMS[]\n"
                f"# Number of cameras: {len(cams)}\n")
        for cam in cams.values():
            params = " ".join(repr(float(p)) for p in cam.params)
            f.write(f"{cam.id} {cam.model} {cam.width} {cam.height} "
                    f"{params}\n")


def write_images_text(images: Dict[int, Image], path: str) -> None:
    """COLMAP images.txt: two lines per image (pose head, 2D-point track)."""
    with open(path, "w") as f:
        f.write("# Image list with two lines of data per image:\n"
                "#   IMAGE_ID, QW, QX, QY, QZ, TX, TY, TZ, CAMERA_ID, NAME\n"
                "#   POINTS2D[] as (X, Y, POINT3D_ID)\n"
                f"# Number of images: {len(images)}\n")
        for im in images.values():
            head = [im.id, *im.qvec, *im.tvec, im.camera_id, im.name]
            f.write(" ".join(str(h) for h in head) + "\n")
            pts = " ".join(f"{x} {y} {pid}" for (x, y), pid
                           in zip(im.xys, im.point3D_ids))
            f.write(pts + "\n")


def write_points3d_text(points: Dict[int, Point3D], path: str) -> None:
    """COLMAP points3D.txt: one line per point + (image_id, point2D_idx)
    track pairs."""
    with open(path, "w") as f:
        f.write("# 3D point list with one line of data per point:\n"
                "#   POINT3D_ID, X, Y, Z, R, G, B, ERROR, "
                "TRACK[] as (IMAGE_ID, POINT2D_IDX)\n"
                f"# Number of points: {len(points)}\n")
        for p in points.values():
            head = [p.id, *map(float, p.xyz), *map(int, p.rgb), p.error]
            track = " ".join(f"{int(i)} {int(j)}" for i, j
                             in zip(p.image_ids, p.point2D_idxs))
            f.write(" ".join(str(h) for h in head) + " " + track + "\n")


def write_model(cams, images, points, out_dir: str, ext: str = ".bin"):
    """Write a COLMAP model dir in binary or text format (parity:
    read_write_model.py write_model)."""
    os.makedirs(out_dir, exist_ok=True)
    if ext == ".bin":
        write_cameras_binary(cams, os.path.join(out_dir, "cameras.bin"))
        write_images_binary(images, os.path.join(out_dir, "images.bin"))
        write_points3d_binary(points, os.path.join(out_dir, "points3D.bin"))
    elif ext == ".txt":
        write_cameras_text(cams, os.path.join(out_dir, "cameras.txt"))
        write_images_text(images, os.path.join(out_dir, "images.txt"))
        write_points3d_text(points, os.path.join(out_dir, "points3D.txt"))
    else:
        raise ValueError(f"unknown model ext {ext!r} (use '.bin' or '.txt')")


def write_cameras_binary(cams: Dict[int, Camera], path: str) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(cams)))
        for cam in cams.values():
            mid = CAMERA_MODEL_IDS[cam.model]
            f.write(struct.pack("<iiQQ", cam.id, mid, cam.width, cam.height))
            f.write(struct.pack(f"<{len(cam.params)}d", *cam.params))


def write_images_binary(images: Dict[int, Image], path: str) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for im in images.values():
            f.write(struct.pack("<idddddddi", im.id, *im.qvec, *im.tvec,
                                im.camera_id))
            f.write(im.name.encode("utf-8") + b"\x00")
            f.write(struct.pack("<Q", len(im.xys)))
            for xy, pid in zip(im.xys, im.point3D_ids):
                f.write(struct.pack("<ddq", xy[0], xy[1], pid))


def write_points3d_binary(points: Dict[int, Point3D], path: str) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(points)))
        for p in points.values():
            f.write(struct.pack("<QdddBBBd", p.id, *p.xyz, *p.rgb, p.error))
            f.write(struct.pack("<Q", len(p.image_ids)))
            for img, p2d in zip(p.image_ids, p.point2D_idxs):
                f.write(struct.pack("<ii", img, p2d))


def read_dense_array(path: str) -> np.ndarray:
    """COLMAP dense map (.bin depth/normal): text header
    "width&height&channels&" then float32 data in column-major channel order
    (parity: colmapUtils/read_write_dense.py:40-64)."""
    with open(path, "rb") as f:
        header = b""
        amp = 0
        while amp < 3:
            c = f.read(1)
            header += c
            if c == b"&":
                amp += 1
        w, h, ch = (int(x) for x in header.decode().split("&")[:3])
        data = np.fromfile(f, np.float32)
    return data.reshape((w, h, ch), order="F").transpose(1, 0, 2).squeeze()


def write_dense_array(arr: np.ndarray, path: str) -> None:
    """Inverse of read_dense_array (read_write_dense.py:67-88)."""
    if arr.ndim == 2:
        arr = arr[..., None]
    h, w, ch = arr.shape
    with open(path, "wb") as f:
        f.write(f"{w}&{h}&{ch}&".encode())
        # inverse of read: [h,w,c] → [w,h,c] → column-major flat
        f.write(arr.transpose(1, 0, 2).astype(np.float32)
                .flatten(order="F").tobytes())


def read_model(sparse_dir: str):
    """Read a COLMAP model dir (binary preferred, text fallback)."""
    if os.path.exists(os.path.join(sparse_dir, "cameras.bin")):
        return (read_cameras_binary(os.path.join(sparse_dir, "cameras.bin")),
                read_images_binary(os.path.join(sparse_dir, "images.bin")),
                read_points3d_binary(os.path.join(sparse_dir, "points3D.bin")))
    pts_txt = os.path.join(sparse_dir, "points3D.txt")
    return (read_cameras_text(os.path.join(sparse_dir, "cameras.txt")),
            read_images_text(os.path.join(sparse_dir, "images.txt")),
            read_points3d_text(pts_txt) if os.path.exists(pts_txt) else {})


def image_w2c(im: Image) -> Tuple[np.ndarray, np.ndarray]:
    """World→camera (R, t) for a COLMAP image record."""
    return qvec2rotmat(im.qvec), im.tvec
