"""Build the package's CUDA sources into one shared library, at first use.

The kernels in ``gbnerf_tpu_torch/csrc/*.cu`` export a plain C interface
and are loaded with ``ctypes``: no source includes PyTorch's headers, so
``nvcc`` takes seconds, not the minutes that a ``torch.utils.cpp_extension``
build takes. The library goes into ``build/gbnerf_tpu_torch/<hash>/`` at the
root of the checkout, keyed by a hash of the sources and the flags, so an
edited source rebuilds and an unchanged one loads at once. Nothing is
fetched and nothing prebuilt is committed.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Optional

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_ROOT = PKG_DIR.parent / "build" / "gbnerf_tpu_torch"
LIB_NAME = "libgbnerf_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None   # time of the last nvcc run, if any
ptxas_log: str = ""                     # nvcc's -Xptxas -v report of that run


def find_nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").is_file():
            return str(Path(cand) / "bin" / "nvcc")
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the CUDA kernels of gbnerf_tpu_torch are built from "
            "source and need the CUDA toolkit")
    return nvcc


def sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build_library() -> Path:
    """Compile csrc/*.cu (if the keyed library is missing) → its path.

    One nvcc per source, all started together, into objects in a private
    temporary directory; then one link into the library.
    """
    global build_seconds, ptxas_log
    nvcc = find_nvcc()
    out_dir = BUILD_ROOT / source_hash()
    lib_path = out_dir / LIB_NAME
    if lib_path.is_file():
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    cu = sorted(CSRC_DIR.glob("*.cu"))
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
    t0 = time.perf_counter()
    # build under private names, then rename: a concurrent build never
    # loads a half-written library
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        objs = [Path(tmp) / f"{p.stem}.o" for p in cu]
        procs = [subprocess.Popen([nvcc, *compile_flags, "-c", "-o", str(o),
                                   str(p)], stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for p, o in zip(cu, objs)]
        logs = []
        for p, proc in zip(cu, procs):
            _, err = proc.communicate()
            logs.append(err)
            if proc.returncode != 0:
                for other in procs:
                    other.kill()
                    other.wait()
                raise RuntimeError(f"nvcc failed on {p.name} (exit "
                                   f"{proc.returncode}):\n{err}")
        lib_tmp = Path(tmp) / LIB_NAME
        proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(lib_tmp),
                               *map(str, objs)], capture_output=True,
                              text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed (exit {proc.returncode}):"
                               f"\n{proc.stderr}")
        os.replace(lib_tmp, lib_path)
    build_seconds = time.perf_counter() - t0
    ptxas_log = "".join(logs)
    return lib_path


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built and loaded once per process."""
    global _lib
    if _lib is None:
        _lib = ctypes.CDLL(str(build_library()))
    return _lib


_functions: dict = {}


def kernel_function(name: str, argtypes) -> ctypes._CFuncPtr:
    """A C entry point of the library, returning a cudaError_t as int,
    declared once per process (the wrappers call this at every launch).

    Pointers and the stream must be declared ``ctypes.c_void_p``: an
    undeclared Python int is passed as a 32-bit int and cuts the pointer.
    """
    fn = _functions.get(name)
    if fn is None:
        fn = getattr(load_library(), name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _functions[name] = fn
    return fn
