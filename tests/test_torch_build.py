"""The kernel build (ops/_build.py) and the launch counters, without nvcc.

A fake ``nvcc`` stands in for the compiler, so the CPU tier checks the
build's own logic: the library is keyed by a hash of the sources, built
once, and a failed build raises with the compiler's stderr. The counters
count kernel launches only, so a CPU call (the plain version) leaves them
alone.
"""
import os
import stat

import numpy as np
import pytest
import torch

from gbnerf_tpu_torch.ops import _build
from gbnerf_tpu_torch.ops import field_fused as ff
from gbnerf_tpu_torch.ops import resample as rs

torch.set_num_threads(1)


@pytest.fixture
def fake_toolkit(tmp_path, monkeypatch):
    """A CUDA_HOME whose bin/nvcc logs its calls, then writes the -o file
    (or fails with a message when the source says so)."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text("// kernel v1\n")
    home = tmp_path / "cuda"
    (home / "bin").mkdir(parents=True)
    nvcc = home / "bin" / "nvcc"
    log = tmp_path / "calls.log"
    nvcc.write_text(
        "#!/bin/sh\n"
        f"echo call >> {log}\n"
        'for a; do src="$a"; done\n'
        'if grep -q FAIL "$src"; then\n'
        "  echo 'k.cu(3): error: expected a ;' >&2; exit 2\nfi\n"
        'while [ "$1" != "-o" ]; do shift; done\n'
        'echo lib > "$2"\n')
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("CUDA_HOME", str(home))
    monkeypatch.setattr(_build, "CSRC_DIR", csrc)
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    return csrc, log


def _calls(log):
    return len(log.read_text().splitlines()) if log.exists() else 0


def test_build_is_keyed_by_source_hash_and_runs_once(fake_toolkit):
    csrc, log = fake_toolkit
    # one nvcc per source (here one), then one link
    first = _build.build_library()
    assert first.is_file() and first.name == _build.LIB_NAME
    assert first.parent.name == _build.source_hash()
    assert _build.build_library() == first and _calls(log) == 2
    (csrc / "k.cu").write_text("// kernel v2\n")      # an edit rebuilds
    second = _build.build_library()
    assert second != first and second.is_file() and _calls(log) == 4
    # no half-written temporaries are left beside the libraries
    assert sorted(p.name for p in second.parent.iterdir()) == [
        _build.LIB_NAME]


def test_sources_compile_in_parallel_then_link(fake_toolkit):
    """Each source gets its own nvcc (all started before any is waited
    for), then one link of the objects makes the library."""
    csrc, log = fake_toolkit
    (csrc / "k2.cu").write_text("// kernel b\n")
    (csrc / "k3.cu").write_text("// kernel c\n")
    lib = _build.build_library()
    assert lib.is_file() and _calls(log) == 4
    assert sorted(p.name for p in lib.parent.iterdir()) == [_build.LIB_NAME]


def test_failed_build_raises_with_nvcc_stderr(fake_toolkit):
    csrc, _ = fake_toolkit
    (csrc / "k.cu").write_text("FAIL\n")
    with pytest.raises(RuntimeError, match="expected a ;"):
        _build.build_library()
    out_dir = _build.BUILD_ROOT / _build.source_hash()
    assert not (out_dir / _build.LIB_NAME).exists()
    assert list(out_dir.iterdir()) == []


def test_kernel_function_declares_each_entry_once(monkeypatch):
    """An entry point is looked up and declared (argument types, an int
    cudaError_t) at its first call and reused after: the wrappers ask for
    it at every launch."""
    import ctypes

    class Entry:                      # a stand-in for a ctypes function
        pass

    lookups = []

    class Library:                    # a stand-in for the loaded library
        def __getattr__(self, name):
            lookups.append(name)
            return Entry()

    monkeypatch.setattr(_build, "_lib", Library())
    monkeypatch.setattr(_build, "_functions", {})
    fn = _build.kernel_function("gbnerf_k", [ctypes.c_void_p, ctypes.c_int])
    assert fn.argtypes == [ctypes.c_void_p, ctypes.c_int]
    assert fn.restype is ctypes.c_int
    assert _build.kernel_function("gbnerf_k", []) is fn
    assert fn.argtypes == [ctypes.c_void_p, ctypes.c_int]
    assert lookups == ["gbnerf_k"]


def test_missing_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "none"))
    monkeypatch.setenv("PATH", str(tmp_path))
    if os.path.isfile("/usr/local/cuda/bin/nvcc"):
        pytest.skip("this host has a CUDA toolkit at /usr/local/cuda")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()


def test_nvcc_targets_hopper():
    flags = " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "-shared" in flags and "-fPIC" in flags


def test_cpu_calls_count_no_launches(rng):
    """The counters count kernel launches; the plain version (CPU) is not
    one, so a run on the CPU cannot pass for a run through the kernels."""
    before = {**ff.LAUNCHES, **rs.LAUNCHES}
    x = torch.from_numpy(rng.random((64, 3)).astype(np.float32))
    ul = torch.from_numpy(rng.standard_normal((3, 9, 8)).astype(np.float32))
    Ws = {"ws0": torch.randn(8, 64), "ws1": torch.randn(64, 16),
          "wc0": torch.randn(31, 64), "wc1": torch.randn(64, 64),
          "wc2": torch.randn(64, 3)}
    ff.cp_field_fused(x, torch.randn(64, 16), ul, Ws)
    ff.cp_field_fused(x, None, ul, Ws, sigma_only=True)
    rs.merge128(torch.sort(torch.rand(5, 128), -1).values, 64)
    assert {**ff.LAUNCHES, **rs.LAUNCHES} == before
