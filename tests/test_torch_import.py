"""The port imports no JAX and nothing of the JAX package: every module of
gbnerf_tpu_torch, and chip_smoke.py, imported in a fresh interpreter leave
``jax`` (and flax, optax, orbax), ``gbnerf_tpu``, the root ``tools/``
scripts (the port keeps its own twins), and the file libraries
the machine with the card lacks (msgpack, safetensors, imageio, cv2,
matplotlib) out of ``sys.modules``. The machine with the card has no JAX
installed."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
MODULES = sorted(
    ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(
        ".__init__")
    for p in (ROOT / "gbnerf_tpu_torch").rglob("*.py"))

_PROBE = """
import importlib, json, sys
out = {}
for name in sys.argv[1:]:
    importlib.import_module(name)
    out[name] = sorted(m for m in sys.modules
                       if m.split(".")[0] in ("jax", "jaxlib", "flax",
                                              "optax", "orbax",
                                              "gbnerf_tpu", "tools",
                                              "msgpack",
                                              "safetensors", "imageio",
                                              "cv2", "matplotlib"))
print(json.dumps(out))
"""


def _probe(names):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE, *names],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def loaded():
    return _probe(MODULES + ["chip_smoke"])


def test_every_module_is_listed():
    assert len(MODULES) >= 20
    assert "gbnerf_tpu_torch.ops.field_fused" in MODULES
    assert "gbnerf_tpu_torch.tools.prof_field" in MODULES
    for name in ("utils.msgpack", "guidance.lora", "guidance.pipeline",
                 "train.lora_trainer", "train_lora", "tools.train_tiny_prior",
                 "guidance.perpneg", "guidance.directional",
                 "guidance.orchestrator", "guidance.clip_guidance",
                 "data.blender", "utils.gif", "utils.mesh", "utils.warp",
                 "utils.gallery", "tools.export_mesh", "tools.bench",
                 "tools.make_fake_sd_ckpt", "tools.convert_vgg",
                 "utils.jax_random", "utils.jax_init"):
        assert f"gbnerf_tpu_torch.{name}" in MODULES, name


def test_probe_sees_the_jax_package_and_not_the_port():
    """The probe matches the top-level name exactly: the JAX package's
    config (which imports no JAX) is flagged, the port's prefix is not."""
    got = _probe(["gbnerf_tpu.config"])["gbnerf_tpu.config"]
    assert "gbnerf_tpu" in got and "gbnerf_tpu.config" in got
    assert not any(m.startswith("gbnerf_tpu_torch") for m in got)


@pytest.mark.parametrize("name", MODULES + ["chip_smoke"])
def test_module_imports_no_jax(loaded, name):
    assert loaded[name] == [], f"{name} pulled in {loaded[name]}"
