"""The port's render benchmark (gbnerf_tpu_torch/tools/bench.py) against
bench.py, on the CPU:

- its config is the one bench.py builds (the JAX ``Config`` made with the
  same arguments, compared field by field);
- its render on the JAX package's fields (``create_train_state(cfg,
  PRNGKey(0))``, converted) against the JAX ``make_render_fn`` on the same
  256 rays, at the CP eval tolerances of tests/test_torch_render.py: both
  sides round every field matmul operand to bf16 but sum in another order,
  which can flip one rounding of a hidden activation and, through the
  resampling, move the fine samples: rgb and acc to 5e-3, depth and disp
  to 2e-2 (absolute), over maps of O(1) values;
- ``run`` at 2 renders a loop gives a finite rate; the JSON line has
  bench.py's four keys and values;
- the default ``--device`` exits with a message naming ``--device cpu``
  where there is no card.

The full 16384 × 128 workload runs on the card (chip_smoke.py's "bench
twin" phase, or ``python -m gbnerf_tpu_torch.tools.bench``).
"""
import ast
import dataclasses
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gbnerf_tpu.config import Config, FieldConfig, RenderConfig
from gbnerf_tpu.train import step as jstep
from gbnerf_tpu.train.state import create_train_state
from gbnerf_tpu_torch import convert
from gbnerf_tpu_torch.tools import bench

ROOT = Path(__file__).resolve().parents[1]
MAP_ATOL = {"rgb": 5e-3, "acc": 5e-3, "depth": 2e-2, "disp": 2e-2}


def _jax_bench_config():
    """bench.py:42-56's Config, made with the same arguments."""
    return Config(
        field=FieldConfig(no_tcnn=False, field_type="cp",
                          cp_resolutions_coarse=(17, 33, 65),
                          cp_rank_coarse=8),
        render=RenderConfig(N_samples=64, N_importance=64, lindisp=True,
                            white_bkgd=True))


def test_config_is_bench_pys():
    assert dataclasses.asdict(bench.bench_config()) == dataclasses.asdict(
        _jax_bench_config())
    assert (bench.NEAR, bench.FAR, bench.N_RAYS, bench.REPS) == (
        1.2, 5.3, 16384, 128)
    cfg, _, coarse, fine = bench.build(device="cpu")
    assert coarse.resolutions == (17, 33, 65) and coarse.rank == 8
    assert fine.resolutions == cfg.field.cp_resolutions
    cfg2, *_ = bench.build({"render": {"N_samples": 32}}, "cpu")
    assert cfg2.render.N_samples == 32
    assert dataclasses.replace(cfg2.render, N_samples=64) == cfg.render


def test_render_matches_jax_on_the_same_fields():
    cfg = _jax_bench_config()
    state, jc, jf = create_train_state(cfg, jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map(np.asarray, state.params)
    _, render, coarse, fine = bench.build(device="cpu")
    sds = convert.params_from_jax(params)
    coarse.load_state_dict(sds["coarse"])
    fine.load_state_dict(sds["fine"])
    ro, rd = bench.rays(256, torch.Generator().manual_seed(1), "cpu")
    assert torch.allclose(torch.linalg.norm(rd, dim=-1), torch.ones(256))
    with torch.no_grad():
        got = render(ro, rd, train=False)
    ref = jstep.make_render_fn(cfg, jc, jf, near=bench.NEAR, far=bench.FAR)(
        state.params, jnp.asarray(ro.numpy()), jnp.asarray(rd.numpy()),
        None, train=False)
    for k, atol in MAP_ATOL.items():
        g, r = getattr(got, k).numpy(), np.asarray(getattr(ref, k))
        assert g.shape == r.shape and np.isfinite(g).all(), k
        np.testing.assert_allclose(g, r, rtol=0, atol=atol, err_msg=k)


def test_run_gives_a_finite_rate():
    _, render, _, _ = bench.build(device="cpu")
    ro, rd = bench.rays(64, torch.Generator().manual_seed(1), "cpu")
    assert bench.one_render_launches(render, ro, rd) == {
        k: 0 for k in bench.KERNELS}              # the CPU launches nothing
    res = bench.run(render, ro, rd, reps=2)
    assert len(res["loop_s"]) == bench.LOOPS
    assert res["best_s"] == min(res["loop_s"]) > 0
    assert math.isfinite(res["rays_per_s"]) and res["rays_per_s"] > 0
    assert res["rays_per_s"] == pytest.approx(64 * 2 / res["best_s"])
    assert math.isfinite(res["checksum"]) and res["checksum"] > 0


def _bench_py_line_keys():
    """The keys and constant values of the dict bench.py prints."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict) and any(
                isinstance(k, ast.Constant) and k.value == "metric"
                for k in node.keys):
            return {k.value: (v.value if isinstance(v, ast.Constant)
                              else None)
                    for k, v in zip(node.keys, node.values)}
    raise AssertionError("bench.py prints no metric line")


def test_json_line_has_bench_pys_keys():
    ref = _bench_py_line_keys()
    line = bench.result_line({"rays_per_s": 1234.56})
    assert set(line) == set(ref) == {"metric", "value", "unit",
                                     "vs_baseline"}
    assert (line["metric"], line["unit"]) == (ref["metric"], ref["unit"])
    assert line["value"] == 1234.6 and line["vs_baseline"] is None


def test_default_device_exits_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        bench.main([])
    assert isinstance(e.value.code, str) and "--device cpu" in e.value.code
