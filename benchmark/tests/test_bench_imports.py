"""Nothing the benchmark runs imports JAX or the JAX package, compared by
whole top-level names (gbnerf_tpu_torch is not gbnerf_tpu), and the plain
reference imports nothing of the port."""
import ast
import subprocess
import sys

from benchmark.harness import common

SCRIPT = r"""
import sys
sys.path.insert(0, {root!r})
from benchmark import run
from benchmark.harness import common
from benchmark.tests import tiny
for kind in ("lora", "stage1", "views"):
    common.traffic_module(kind)
for p in sorted((common.BENCH_DIR / "metrics").glob("*.py")):
    common.metric_module(p.stem)
tiny.run("cp_views")
print("FOUND", common.forbidden_modules())
"""


def test_no_jax_module_is_loaded_by_a_run():
    out = subprocess.run([sys.executable, "-c",
                          SCRIPT.format(root=str(common.ROOT))],
                         capture_output=True, text=True, timeout=600,
                         cwd=str(common.ROOT))
    assert out.returncode == 0, out.stderr[-2000:]
    assert "FOUND []" in out.stdout


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "gbnerf_tpu_torch_fake", object())
    monkeypatch.setitem(sys.modules, "jaxtyping_fake", object())
    assert "gbnerf_tpu_torch_fake" not in common.forbidden_modules()
    monkeypatch.setitem(sys.modules, "gbnerf_tpu.fake", object())
    assert "gbnerf_tpu" in common.forbidden_modules()


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_reference_imports_nothing_of_the_port():
    files = sorted((common.BENCH_DIR / "reference").glob("*.py"))
    assert files
    for f in files:
        tops = {m.split(".")[0] for m in _imports(f)}
        assert not tops & {"gbnerf_tpu_torch", "gbnerf_tpu", "jax", "flax",
                           "benchmark"}, (f, tops)


def test_benchmark_sources_never_import_jax():
    for f in common.BENCH_DIR.rglob("*.py"):
        tops = {m.split(".")[0] for m in _imports(f)}
        assert not tops & {"gbnerf_tpu", "jax", "jaxlib", "flax"}, (f, tops)
