"""The port's tool twins, run as the CLIs they are (subprocesses), held
against the JAX package's tools where both compute something:

- check_data: PASS on a generated scene (with --colmap), FAIL on an empty
  mask and on a missing poses_bounds.npy, as tests/test_check_data.py;
- imgs2poses on an existing sparse model: the poses_bounds.npy that the
  JAX package's conversion gives (rtol 1e-12);
- convert_ref_ckpt: a reference-layout NeRF checkpoint → a port
  checkpoint whose fields equal tools/convert_ref_ckpt.py's
  torch_nerf_to_flax → convert.params_from_jax, bit for bit, and which
  restores as ft_path does;
- check_weights --device cpu on the tiny fake SD checkpoint
  (tools/make_fake_sd_ckpt.py --tiny) with a VGG npz: PASS; without vae/:
  CHECK FAILED;
- ablation_lpips against tools/ablation_lpips.py on one run directory
  with the same random VGG npz: each arm's distances to rtol 1e-4 (the
  LPIPS tolerance of tests/test_torch_lpips.py) and atol 1e-5 (the JSON
  keeps five decimals).
"""
import importlib.util
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from gbnerf_tpu.data.pose_utils import colmap_to_poses_bounds as j_c2pb
from gbnerf_tpu_torch import convert
from gbnerf_tpu_torch.config import Config, FieldConfig, save_config
from gbnerf_tpu_torch.train.checkpoint import CheckpointManager
from gbnerf_tpu_torch.train.state import create_train_state
from gbnerf_tpu_torch.utils.png import read_png, write_png

ROOT = Path(__file__).resolve().parents[1]


def _tool(name):
    """A script of tools/ (the JAX package's), imported by path."""
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(tool, *args):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    return subprocess.run(
        [sys.executable, "-m", f"gbnerf_tpu_torch.tools.{tool}",
         *map(str, args)], capture_output=True, text=True, cwd=ROOT,
        env=env, timeout=600)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    from gbnerf_tpu_torch.tools import make_synthetic_scene

    out = tmp_path_factory.mktemp("tools") / "scene"
    make_synthetic_scene.main([str(out), "--task", "inpaint", "--H", "48",
                               "--W", "64", "--n_train", "4", "--n_test",
                               "2", "--colmap_sparse"])
    return out


def _main(module, *args):
    """A tool's main in this process → its exit code (main's return value
    or SystemExit's)."""
    try:
        rc = module.main([str(a) for a in args])
    except SystemExit as e:
        rc = e.code
    return rc or 0


def test_check_data_pass(scene):
    r = _run("check_data", scene, "--test_split_count", "2", "--colmap")
    assert r.returncode == 0, r.stdout + r.stderr
    assert "PASS" in r.stdout and "FAIL" not in r.stdout
    assert "kept keypoints/view" in r.stdout        # the COLMAP part ran


def test_check_data_flags_empty_mask(scene, tmp_path, capsys):
    from gbnerf_tpu_torch.tools import check_data

    broken = tmp_path / "scene"
    shutil.copytree(scene, broken)
    mdir = broken / "images_4" / "label"
    f = sorted(os.listdir(mdir))[0]
    write_png(str(mdir / f), np.zeros_like(read_png(str(mdir / f))))
    assert _main(check_data, broken, "--test_split_count", "2") == 1
    out = capsys.readouterr().out
    assert "[FAIL] every train view has a non-empty inpaint mask" in out


def test_check_data_missing_poses_bounds(tmp_path, capsys):
    from gbnerf_tpu_torch.tools import check_data

    (tmp_path / "scene").mkdir()
    assert _main(check_data, tmp_path / "scene", "--test_split_count",
                 "2") == 1
    assert "[FAIL] poses_bounds.npy present" in capsys.readouterr().out


def test_imgs2poses_on_an_existing_model(scene, tmp_path):
    d = tmp_path / "scene"
    shutil.copytree(scene, d)
    os.unlink(d / "poses_bounds.npy")
    r = _run("imgs2poses", d, "--colmap_bin", tmp_path / "no_colmap")
    assert r.returncode == 0, r.stdout + r.stderr
    assert "wrote poses_bounds.npy with 6 poses" in r.stdout
    np.testing.assert_allclose(np.load(d / "poses_bounds.npy"),
                               j_c2pb(str(d)), rtol=1e-12, atol=0)


def _reference_state_dict(module, gen):
    """The reference NeRF's names for a port NeRFMLP's parameters, with
    fresh values."""
    names = {"trunk_": "pts_linears.", "sigma.": "alpha_linear.",
             "feature.": "feature_linear.", "views_": "views_linears.",
             "rgb.": "rgb_linear."}
    out = {}
    for key, p in module.state_dict().items():
        new = next(key.replace(a, b, 1) for a, b in names.items()
                   if key.startswith(a))
        out[new] = torch.randn(p.shape, generator=gen)
    return out


def test_convert_ref_ckpt_matches_the_jax_tool_map(tmp_path):
    cfg = Config(field=FieldConfig(no_tcnn=True, netdepth=6, netwidth=32,
                                   netdepth_fine=6, netwidth_fine=32,
                                   multires=4, multires_views=2))
    save_config(cfg, str(tmp_path / "cfg.txt"))
    _, coarse, fine = create_train_state(cfg, torch.Generator().manual_seed(
        0))
    gen = torch.Generator().manual_seed(1)
    ref = {"global_step": 1234, "optimizer_state_dict": {},
           "network_fn_state_dict": _reference_state_dict(coarse, gen),
           "network_fine_state_dict": _reference_state_dict(fine, gen)}
    assert "pts_linears.5.weight" in ref["network_fn_state_dict"]
    torch.save(ref, tmp_path / "ref.tar")
    r = _run("convert_ref_ckpt", tmp_path / "ref.tar", tmp_path / "out",
             "--config", tmp_path / "cfg.txt")
    assert r.returncode == 0, r.stdout + r.stderr
    sd = torch.load(tmp_path / "out" / "1234.pt", weights_only=True)
    jtool = _tool("convert_ref_ckpt")
    for name, key in (("coarse", "network_fn_state_dict"),
                      ("fine", "network_fine_state_dict")):
        want = convert.params_from_jax({name: jtool.torch_nerf_to_flax(
            {k: v.numpy() for k, v in ref[key].items()})})[name]
        assert set(sd[name]) == set(want)
        for k, v in want.items():
            assert torch.equal(sd[name][k], v), (name, k)
    # ft_path restores it into the config's state
    state, _, _ = create_train_state(cfg, torch.Generator())
    CheckpointManager(str(tmp_path / "out")).restore(state)
    assert state.step == 1234
    assert torch.equal(state.fine.trunk_5.weight,
                       ref["network_fine_state_dict"]["pts_linears.5.weight"])
    # a grid-field config is refused
    from gbnerf_tpu_torch.tools import convert_ref_ckpt

    save_config(Config(), str(tmp_path / "grid.txt"))
    with pytest.raises(SystemExit, match="no_tcnn"):
        convert_ref_ckpt.main([str(tmp_path / "ref.tar"),
                               str(tmp_path / "out2"), "--config",
                               str(tmp_path / "grid.txt")])
    assert not (tmp_path / "out2").exists()


@pytest.fixture(scope="module")
def vgg_npz(tmp_path_factory):
    """A converted random VGG16 (tools/convert_vgg.py), no lin heads."""
    conv = _tool("convert_vgg")
    rng = np.random.default_rng(0)
    widths = (64, 64, 128, 128, 256, 256, 256, 512, 512, 512, 512, 512, 512)
    sd, cin = {}, 3
    for idx, cout in zip(conv.TORCH_CONV_IDX, widths):
        sd[f"features.{idx}.weight"] = rng.normal(
            0, 0.05, (cout, cin, 3, 3)).astype(np.float32)
        sd[f"features.{idx}.bias"] = np.zeros(cout, np.float32)
        cin = cout
    path = tmp_path_factory.mktemp("vgg") / "vgg.npz"
    np.savez(path, **conv.convert(sd, None))
    return path


def test_check_weights_on_the_tiny_fake_checkpoint(tmp_path, vgg_npz, capsys):
    d = tmp_path / "fake_sd"
    _tool("make_fake_sd_ckpt").save_ckpt(str(d), tiny=True)
    args = (d, "--tiny", "--allow_hash_tokenizer", "--device", "cpu")
    r = _run("check_weights", *args, "--vgg", vgg_npz)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "PASS:" in r.stdout and "[check] LPIPS" in r.stdout
    for tower in ("unet", "vae", "text"):
        assert f"[check] {tower}: " in r.stdout
    from gbnerf_tpu_torch.tools import check_weights

    shutil.rmtree(d / "vae")
    assert _main(check_weights, *args) == 1
    out = capsys.readouterr().out
    assert "CHECK FAILED" in out and "vae/" in out


def test_ablation_lpips_matches_the_jax_tool(scene, tmp_path, vgg_npz,
                                             monkeypatch):
    out = tmp_path / "abl"
    shutil.copytree(scene, out / "scene")
    gtdir = out / "scene" / "images_4" / "test_gt"
    gts = sorted(p for p in gtdir.glob("img_*.png"))
    rng = np.random.default_rng(3)
    for arm, noise in (("s1", 40), ("nog", 10)):
        rgb = out / "logs" / arm / "eval_images_20" / "rgb"
        rgb.mkdir(parents=True)
        for k, p in enumerate(gts):
            img = read_png(str(p)).astype(np.int64)
            img = img + rng.integers(-noise, noise + 1, img.shape)
            write_png(str(rgb / f"{k:03d}.png"),
                      np.clip(img, 0, 255).astype(np.uint8))
    (out / "logs" / "empty").mkdir()               # no eval: not in the table
    r = _run("ablation_lpips", out, "--vgg_npz", vgg_npz, "--device", "cpu")
    assert r.returncode == 0, r.stdout + r.stderr
    if not torch.cuda.is_available():          # the card by default
        from gbnerf_tpu_torch.tools import ablation_lpips

        with pytest.raises(SystemExit, match="no CUDA device"):
            ablation_lpips.main([str(out)])
    got = json.loads((out / "ablation_lpips.json").read_text())
    monkeypatch.setattr(sys, "argv", ["ablation_lpips.py", str(out),
                                      "--vgg_npz", str(vgg_npz)])
    _tool("ablation_lpips").main()
    ref = json.loads((out / "ablation_lpips.json").read_text())
    assert got["metric"] == ref["metric"] == "lpips"
    assert set(got["results"]) == set(ref["results"]) == {"s1", "nog"}
    for arm, r_arm in ref["results"].items():
        for k in ("full", "mask_bbox"):
            np.testing.assert_allclose(got["results"][arm][k], r_arm[k],
                                       rtol=1e-4, atol=1e-5,
                                       err_msg=f"{arm} {k}")
    assert got["results"]["s1"]["full"] > got["results"]["nog"]["full"]
