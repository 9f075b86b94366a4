"""Port vs JAX: the native host library's binding (data/native.py).

The port builds native/csrc/gbnerf_native.cpp itself into build/ (keyed by
a hash of the source and the flags) and never writes into native/. Each
entry point is held against the JAX package's binding (its prebuilt
library) and against numpy, parametrised as tests/test_native.py is; the
numpy fallbacks (no library) give the same answers. Exact equality
throughout: the same C code, or numpy's own searchsorted.
"""
import hashlib
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from gbnerf_tpu.data import native as jnative
from gbnerf_tpu_torch.data import colmap as tcolmap
from gbnerf_tpu_torch.data import native
from gbnerf_tpu_torch.data.rays_bank import _full_image_rays_np

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def no_library(monkeypatch):
    """The binding as it is where the library cannot be built."""
    monkeypatch.setattr(native, "_load", lambda: None)


def test_native_builds_into_build_not_native():
    prebuilt = ROOT / "native" / "libgbnerf_native.so"
    before = hashlib.sha256(prebuilt.read_bytes()).hexdigest()
    assert native.available(), native.build_error
    lib = native.build_library()
    assert lib.parent == native.BUILD_ROOT / native.source_hash()
    assert lib.parent.parent.parent == ROOT / "build"
    assert hashlib.sha256(prebuilt.read_bytes()).hexdigest() == before
    assert sorted(os.listdir(ROOT / "native")) == [
        "Makefile", "csrc", "libgbnerf_native.so"]


_BUILD_AND_LOAD = """
import ctypes, sys
from pathlib import Path
from gbnerf_tpu_torch.data import native
native.BUILD_ROOT = Path(sys.argv[1])
lib = native.build_library()
ctypes.CDLL(str(lib)).searchsorted_f32
print(lib)
"""


def test_concurrent_builds_all_load(tmp_path):
    """Four processes start the build of one fresh key together: each gets
    a whole library that loads (the build renames a private file into
    place), and the key's directory ends with the library alone."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_AND_LOAD,
                               str(tmp_path)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env)
             for _ in range(4)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), [e for _, e in outs]
    paths = {o.strip() for o, _ in outs}
    assert len(paths) == 1
    assert os.listdir(Path(paths.pop()).parent) == [native.LIB_NAME]


def test_build_takes_the_flags_and_reports_a_failing_compiler(tmp_path,
                                                            monkeypatch):
    """The compiler gets CXXFLAGS: native/Makefile's less -fopenmp (a
    compiler may have no libgomp); a compiler that fails raises with its
    stderr."""
    import ctypes

    argv = tmp_path / "argv"
    gxx = tmp_path / "g++"
    gxx.write_text(f'#!/bin/sh\necho "$@" > {argv}\nexec g++ "$@"\n')
    gxx.chmod(0o755)
    monkeypatch.setenv("CXX", str(gxx))
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "build")
    lib = native.build_library()
    ctypes.CDLL(str(lib)).searchsorted_f32
    flags = argv.read_text().split()
    assert flags[:len(native.CXXFLAGS)] == list(native.CXXFLAGS)
    assert "-fopenmp" not in flags and "-march=native" in flags
    gxx.write_text("#!/bin/sh\necho 'no compiler here' >&2\nexit 1\n")
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "build2")
    with pytest.raises(RuntimeError, match="no compiler here"):
        native.build_library()


def test_build_is_keyed_by_the_hosts_native_target(tmp_path, monkeypatch):
    """A host whose -march=native means another target gets another key,
    so a build/ tree copied from elsewhere is rebuilt, not loaded."""
    here = native.source_hash()
    assert native.native_target(native._cxx()).strip()
    monkeypatch.setattr(native, "native_target",
                        lambda cxx: "  -march=  another-cpu\n")
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "build")
    assert native.source_hash() != here
    assert native.build_library().parent.name == native.source_hash()


@pytest.mark.parametrize("ba,bv,a_len,v_len", [
    (1, 1, 8, 5), (1, 16, 100, 50), (16, 16, 100, 50), (4, 4, 200, 500),
])
@pytest.mark.parametrize("side", ["left", "right"])
def test_searchsorted_matches_jax_and_numpy(ba, bv, a_len, v_len, side, rng):
    for _ in range(10):
        a = np.sort(rng.random((ba, a_len)).astype(np.float32), -1)
        v = rng.random((bv, v_len)).astype(np.float32) * 1.2 - 0.1
        got = native.searchsorted(a, v, side)
        want = np.stack([np.searchsorted(a[0 if ba == 1 else i], v[i], side)
                         for i in range(bv)])
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, jnative.searchsorted(a, v, side))


@pytest.mark.parametrize("side", ["left", "right"])
def test_searchsorted_ties_and_fallback(side, no_library):
    a = np.asarray([[0.0, 1.0, 1.0, 1.0, 2.0]], np.float32)
    v = np.asarray([[1.0, 0.0, 2.0, 3.0, -1.0]], np.float32)
    want = np.searchsorted(a[0], v[0], side)
    np.testing.assert_array_equal(native.searchsorted(a, v, side)[0], want)
    np.testing.assert_array_equal(jnative.searchsorted(a, v, side)[0], want)
    with pytest.raises(ValueError):
        native.searchsorted(a[0], v, side)


@pytest.mark.parametrize("fallback", [False, True])
def test_build_rays_matches_jax_and_numpy(fallback, rng, monkeypatch):
    if fallback:
        monkeypatch.setattr(native, "_load", lambda: None)
    q, _ = np.linalg.qr(rng.normal(size=(2, 3, 3)))
    poses = np.concatenate([q, rng.normal(size=(2, 3, 1))], 2).astype(
        np.float32)
    H, W, focal = 12, 17, 20.0
    ro, rd = native.build_rays(poses, H, W, focal)
    assert ro.shape == rd.shape == (2, H * W, 3)
    jro, jrd = jnative.build_rays(poses, H, W, focal)
    for k in range(2):
        oro, ord_ = _full_image_rays_np(H, W, focal, poses[k])
        np.testing.assert_allclose(ro[k], oro.reshape(-1, 3), atol=1e-5)
        np.testing.assert_allclose(rd[k], ord_.reshape(-1, 3), atol=1e-5)
    if not fallback:          # the same C code on both sides
        np.testing.assert_array_equal(ro, jro)
        np.testing.assert_array_equal(rd, jrd)


@pytest.mark.parametrize("fallback", [False, True])
def test_points3d_arrays_match_jax_and_the_parser(fallback, tmp_path, rng,
                                                  monkeypatch):
    if fallback:
        monkeypatch.setattr(native, "_load", lambda: None)
    pts = {}
    for i in range(1, 20):
        tl = rng.integers(1, 6)
        pts[i] = tcolmap.Point3D(
            id=i, xyz=rng.normal(size=3),
            rgb=(rng.random(3) * 255).astype(np.uint8),
            error=float(rng.random()),
            image_ids=rng.integers(1, 10, tl).astype(np.int32),
            point2D_idxs=rng.integers(0, 100, tl).astype(np.int32))
    path = str(tmp_path / "points3D.bin")
    tcolmap.write_points3d_binary(pts, path)
    arrs = native.read_points3d_arrays(path)
    ref = jnative.read_points3d_arrays(path)
    assert set(arrs) == ({"ids", "xyz", "error"} if fallback else set(ref))
    order = np.argsort(arrs["ids"])
    for k, i in enumerate(sorted(pts)):
        j = order[k]
        np.testing.assert_array_equal(arrs["xyz"][j], pts[i].xyz)
        assert arrs["error"][j] == pts[i].error
        if not fallback:
            o0, o1 = arrs["track_offsets"][j], arrs["track_offsets"][j + 1]
            np.testing.assert_array_equal(arrs["track_image_ids"][o0:o1],
                                          pts[i].image_ids)
            np.testing.assert_array_equal(arrs["rgb"][j], pts[i].rgb)
    if not fallback:
        for key in ref:
            np.testing.assert_array_equal(arrs[key], ref[key], err_msg=key)
    with pytest.raises(IOError if not fallback else FileNotFoundError):
        native.read_points3d_arrays(str(tmp_path / "missing.bin"))
