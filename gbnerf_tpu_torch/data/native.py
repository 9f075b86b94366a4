"""ctypes binding of the native host library (native/csrc/gbnerf_native.cpp).

The port's own copy of gbnerf_tpu/data/native.py, with the same entry
points: the reference-parity batched ``searchsorted`` (the torchsearchsorted
contract), ``build_rays`` (full-image ray banks) and ``read_points3d_arrays``
(COLMAP points3D.bin as arrays), and ``available()``. Every entry point has
the same numpy fallback, so nothing requires the library.

The library is built at first use from the source in ``native/csrc`` with
native/Makefile's flags less ``-fopenmp`` (g++, or $CXX) into
``build/gbnerf_tpu_torch_native/<hash>/`` at the root of the checkout,
keyed by a hash of the source, the flags and what ``-march=native`` means
on this host, so that a ``build/`` tree copied to another CPU is rebuilt
there, not loaded. ``-fopenmp`` is left out because a compiler may lack
the OpenMP runtime (libgomp); the source guards its OpenMP use, so the
loops run on one thread with the same results. Nothing is written into
``native/``: its prebuilt library and Makefile serve the JAX package. The
build writes under a private name and renames it into place, so workers
that start it together never load a half-written library.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
SOURCE = ROOT / "native" / "csrc" / "gbnerf_native.cpp"
BUILD_ROOT = ROOT / "build" / "gbnerf_tpu_torch_native"
LIB_NAME = "libgbnerf_native.so"
CXXFLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-Wall")

_lib: Optional[ctypes.CDLL] = None
_tried = False
build_error: Optional[str] = None   # why the library is unavailable, if it is


def _cxx() -> str:
    return os.environ.get("CXX", "g++")


@functools.lru_cache(maxsize=None)
def native_target(cxx: str) -> str:
    """The target options ``-march=native`` resolves to on this host, as
    the compiler lists them."""
    proc = subprocess.run([cxx, "-march=native", "-Q", "--help=target"],
                          capture_output=True, text=True, timeout=60)
    if proc.returncode != 0:
        raise RuntimeError(f"{cxx} -march=native -Q --help=target failed "
                           f"(exit {proc.returncode}):\n{proc.stderr}")
    return proc.stdout


def source_hash() -> str:
    h = hashlib.sha256(" ".join(CXXFLAGS).encode())
    h.update(native_target(_cxx()).encode())
    h.update(SOURCE.read_bytes())
    return h.hexdigest()[:16]


def build_library() -> Path:
    """The library (built if its keyed file is missing) → its path; raises
    with the compiler's stderr when the build fails."""
    out_dir = BUILD_ROOT / source_hash()
    lib_path = out_dir / LIB_NAME
    if lib_path.is_file():
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        tmp_lib = Path(tmp) / LIB_NAME
        proc = subprocess.run(
            [_cxx(), *CXXFLAGS, "-shared", "-o",
             str(tmp_lib), str(SOURCE)], capture_output=True, text=True,
            timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"building {SOURCE.name} failed (exit "
                               f"{proc.returncode}):\n{proc.stderr}")
        os.replace(tmp_lib, lib_path)
    return lib_path


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried, build_error
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        lib = ctypes.CDLL(str(build_library()))
    except (OSError, RuntimeError, subprocess.SubprocessError) as e:
        build_error = f"{type(e).__name__}: {e}"
        return None
    i64, i32, f32, f64, u8, cp = (ctypes.c_int64, ctypes.c_int32,
                                  ctypes.c_float, ctypes.c_double,
                                  ctypes.c_uint8, ctypes.c_char_p)
    P = ctypes.POINTER
    lib.searchsorted_f32.argtypes = [P(f32), i64, i64, P(f32), i64, i64,
                                     P(i32), ctypes.c_int]
    lib.searchsorted_f32.restype = None
    lib.build_rays_f32.argtypes = [P(f32), i64, i64, i64, f32, P(f32), P(f32)]
    lib.build_rays_f32.restype = None
    lib.colmap_points3d_stats.argtypes = [cp, P(i64), P(i64)]
    lib.colmap_points3d_stats.restype = ctypes.c_int
    lib.colmap_read_points3d.argtypes = [cp, P(i64), P(f64), P(u8), P(f64),
                                         P(i64), P(i32), P(i32)]
    lib.colmap_read_points3d.restype = ctypes.c_int
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def _ptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def searchsorted(a: np.ndarray, v: np.ndarray,
                 side: str = "left") -> np.ndarray:
    """Batched row-wise searchsorted (the reference's torchsearchsorted
    contract: a [Ba, A] sorted rows, v [Bv, V], Ba ∈ {1, Bv}) → int32
    [Bv, V]."""
    a = np.ascontiguousarray(a, np.float32)
    v = np.ascontiguousarray(v, np.float32)
    if a.ndim != 2 or v.ndim != 2 or a.shape[0] not in (1, v.shape[0]):
        raise ValueError(f"searchsorted: a {a.shape} and v {v.shape} must be "
                         "2-D with a's rows 1 or v's")
    if side not in ("left", "right"):
        raise ValueError(f"side must be 'left' or 'right', not {side!r}")
    lib = _load()
    if lib is None:
        rows = [np.searchsorted(a[0 if a.shape[0] == 1 else i], v[i], side)
                for i in range(v.shape[0])]
        return np.stack(rows).astype(np.int32).reshape(v.shape)
    out = np.empty(v.shape, np.int32)
    lib.searchsorted_f32(_ptr(a, ctypes.c_float), a.shape[0], a.shape[1],
                         _ptr(v, ctypes.c_float), v.shape[0], v.shape[1],
                         _ptr(out, ctypes.c_int32), 1 if side == "right" else 0)
    return out


def build_rays(poses: np.ndarray, H: int, W: int,
               focal: float) -> Tuple[np.ndarray, np.ndarray]:
    """[N, 3, 4+] c2w → (rays_o, rays_d), each [N, H·W, 3] f32."""
    poses = np.ascontiguousarray(poses[:, :3, :4], np.float32)
    n = len(poses)
    lib = _load()
    if lib is None:
        from .rays_bank import _full_image_rays_np

        outs = [_full_image_rays_np(H, W, focal, p) for p in poses]
        return (np.stack([o.reshape(-1, 3) for o, _ in outs]),
                np.stack([d.reshape(-1, 3) for _, d in outs]))
    rays_o = np.empty((n, H * W, 3), np.float32)
    rays_d = np.empty((n, H * W, 3), np.float32)
    lib.build_rays_f32(_ptr(poses, ctypes.c_float), n, H, W,
                       ctypes.c_float(focal),
                       _ptr(rays_o, ctypes.c_float),
                       _ptr(rays_d, ctypes.c_float))
    return rays_o, rays_d


def read_points3d_arrays(path: str) -> dict:
    """COLMAP points3D.bin → struct-of-arrays: ids, xyz, error and, from the
    library, rgb and the tracks (track_offsets [n + 1], track_image_ids,
    track_p2d); the fallback's dict has the first three."""
    lib = _load()
    if lib is None:
        from .colmap import read_points3d_binary

        pts = read_points3d_binary(path)
        ids = np.array(sorted(pts.keys()), np.int64)
        return {"ids": ids,
                "xyz": np.stack([pts[i].xyz for i in ids]),
                "error": np.array([pts[i].error for i in ids])}
    n_points = ctypes.c_int64()
    total_track = ctypes.c_int64()
    rc = lib.colmap_points3d_stats(os.fsencode(path), ctypes.byref(n_points),
                                   ctypes.byref(total_track))
    if rc != 0:
        raise IOError(f"colmap_points3d_stats({path}) -> {rc}")
    n, t = n_points.value, total_track.value
    ids = np.empty(n, np.int64)
    xyz = np.empty((n, 3), np.float64)
    rgb = np.empty((n, 3), np.uint8)
    error = np.empty(n, np.float64)
    offsets = np.empty(n + 1, np.int64)
    timg = np.empty(t, np.int32)
    tp2d = np.empty(t, np.int32)
    rc = lib.colmap_read_points3d(
        os.fsencode(path), _ptr(ids, ctypes.c_int64),
        _ptr(xyz, ctypes.c_double), _ptr(rgb, ctypes.c_uint8),
        _ptr(error, ctypes.c_double), _ptr(offsets, ctypes.c_int64),
        _ptr(timg, ctypes.c_int32), _ptr(tp2d, ctypes.c_int32))
    if rc != 0:
        raise IOError(f"colmap_read_points3d({path}) -> {rc}")
    return {"ids": ids, "xyz": xyz, "rgb": rgb, "error": error,
            "track_offsets": offsets, "track_image_ids": timg,
            "track_p2d": tp2d}
