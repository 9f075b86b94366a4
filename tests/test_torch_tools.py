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
  keeps five decimals);
- comp_caption: the caption files byte-equal to tools/comp_caption.py's;
- make_crops: the crop pixels equal tools/make_crops.py's (PIL); the
  label band is the port's own bitmap font (checked for ink only);
- run_spmd_demo: the two configs equal tools/run_spmd_demo.py's; the
  micro run on two CPU ranks (slow: minutes of full-width CP renders);
- dryrun_multichip on two CPU ranks: every "ok" line of a two-rank run;
- make_fake_sd_ckpt at --tiny (with and without --vae_legacy_attn): the
  same files and bit-equal tensors as tools/make_fake_sd_ckpt.py, the
  full-width shape tables equal, and a strict load into the tiny towers;
- convert_vgg on a seeded fake VGG16 with lpips heads, as .pth and as
  .safetensors: the npz equal to tools/convert_vgg.py's.
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


def _captions(d, texts):
    d.mkdir()
    for i, t in enumerate(texts):
        (d / f"{i:03d}.txt").write_text(t)
    (d / "notes.md").write_text("skip me")


def test_comp_caption_writes_the_jax_tools_bytes(tmp_path, monkeypatch):
    from gbnerf_tpu_torch.tools import comp_caption

    texts = ["a stone bench", "RGB image, already tagged", "  padded \n",
             "ünïcode caption"]
    _captions(tmp_path / "j", texts)
    _captions(tmp_path / "t", texts)
    jtool = _tool("comp_caption")
    monkeypatch.setattr(sys, "argv", ["comp_caption", str(tmp_path / "j"),
                                      "--prefix", "RGB image"])
    jtool.main()
    assert comp_caption.main([str(tmp_path / "t"), "--prefix",
                              "RGB image"]) == 3
    for f in sorted(os.listdir(tmp_path / "j")):
        assert ((tmp_path / "t" / f).read_bytes()
                == (tmp_path / "j" / f).read_bytes()), f


def _ablation_dir(root):
    rng = np.random.default_rng(3)
    gt = root / "scene" / "images_4" / "test_gt"
    gt.mkdir(parents=True)
    H, W = 30, 40
    for v, (y0, x0, h, w) in enumerate(((5, 6, 8, 9), (9, 12, 12, 15))):
        m = np.zeros((H, W), np.uint8)
        m[y0:y0 + h, x0:x0 + w] = 255
        write_png(str(gt / f"mask_{v:03d}.png"), m)
        write_png(str(gt / f"img_{v:03d}.png"),
                  rng.integers(0, 256, (H, W, 3), dtype=np.uint8))
        for arm, it in (("s1", 10), ("nog", 20)):
            d = root / "logs" / arm / f"eval_images_{it}" / "rgb"
            d.mkdir(parents=True, exist_ok=True)
            write_png(str(d / f"{v:03d}.png"),
                      rng.integers(0, 256, (H, W, 3), dtype=np.uint8))
    # an earlier eval the tools must pass over
    d = root / "logs" / "s1" / "eval_images_5" / "rgb"
    d.mkdir(parents=True)
    write_png(str(d / "000.png"), np.zeros((H, W, 3), np.uint8))
    write_png(str(d / "001.png"), np.zeros((H, W, 3), np.uint8))


def test_make_crops_matches_the_jax_tools_crops(tmp_path, monkeypatch):
    from gbnerf_tpu_torch.tools import make_crops

    _ablation_dir(tmp_path)
    jtool = _tool("make_crops")
    jpng, tpng = tmp_path / "j.png", tmp_path / "t.png"
    monkeypatch.setattr(sys, "argv", ["make_crops", str(tmp_path), str(jpng),
                                      "--arms", "s1,nog", "--pad", "3",
                                      "--scale", "3"])
    jtool.main()
    make_crops.main([str(tmp_path), str(tpng), "--arms", "s1,nog", "--pad",
                     "3", "--scale", "3"])
    j, t = read_png(str(jpng)), read_png(str(tpng))
    assert j.shape == t.shape
    label_h = 16
    np.testing.assert_array_equal(t[label_h:], j[label_h:])
    # each tile's label band carries ink in both
    tile = (t.shape[1] + 2) // 3
    for i in range(3):
        for img in (j, t):
            band = img[:label_h, i * tile:(i + 1) * tile - 2]
            assert (band < 128).any(), i


def test_spmd_demo_twin_writes_the_jax_tools_configs(tmp_path):
    from gbnerf_tpu_torch.tools import run_spmd_demo

    jtool = _tool("run_spmd_demo")
    kw = dict(scene="/s", logs="/l", n_rand=128, tp=2)
    got = run_spmd_demo.write_configs(str(tmp_path), "/s", "/l", iters1=8,
                                      iters2=4, n_rand=128, tp=2)
    assert open(got[0]).read() == jtool.CFG_S1.format(iters1=8, **kw)
    assert open(got[1]).read() == jtool.CFG_S2.format(iters2_total=12, **kw)


@pytest.mark.slow
def test_spmd_demo_twin_micro_on_two_cpu_ranks(tmp_path):
    """Slow: the stages render the held-out views at full width on the
    CPU (minutes); the card runs it in chip_smoke.py's parallel phase."""
    r = _run("run_spmd_demo", tmp_path / "demo", "--nproc", "2", "--tp",
             "2", "--iters1", "8", "--iters2", "4", "--n_rand", "128",
             "--device", "cpu")
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    rep = json.load(open(tmp_path / "demo" / "spmd_demo.json"))
    assert rep["devices"] == 2 and rep["tp"] == 2
    assert rep["s1"]["iter"] == 8 and rep["s2"]["iter"] == 12


def test_dryrun_multichip_on_two_cpu_ranks():
    r = _run("dryrun_multichip", "2", "--device", "cpu")
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    for head in ("dryrun_multichip(2): ok", "dryrun_multichip stage2: ok",
                 "dryrun_multichip tp-guidance: ok",
                 "dryrun_multichip lora-dp: ok"):
        assert r.stdout.count(head) == 1, (head, r.stdout)
    assert "grad all-reduce present" in r.stdout


@pytest.mark.parametrize("legacy", [False, True], ids=["to_q", "legacy"])
def test_fake_sd_ckpt_twin_equals_the_jax_tool(tmp_path, legacy):
    """--tiny (with and without --vae_legacy_attn): the same files, key set
    and bit-equal tensors as tools/make_fake_sd_ckpt.py; the full-width
    shape tables equal, key order included (the draws follow it), without
    materialising them."""
    from safetensors.numpy import load_file

    from gbnerf_tpu_torch.tools import make_fake_sd_ckpt

    jtool = _tool("make_fake_sd_ckpt")
    jtool.save_ckpt(str(tmp_path / "jax"), tiny=True, legacy_attn=legacy)
    argv = [str(tmp_path / "port"), "--tiny"]
    make_fake_sd_ckpt.main(argv + (["--vae_legacy_attn"] if legacy else []))
    files = sorted(p.relative_to(tmp_path / "jax")
                   for p in (tmp_path / "jax").rglob("*.safetensors"))
    assert len(files) == 3 and files == sorted(
        p.relative_to(tmp_path / "port")
        for p in (tmp_path / "port").rglob("*.safetensors"))
    for f in files:
        ref, got = load_file(tmp_path / "jax" / f), load_file(
            tmp_path / "port" / f)
        assert set(got) == set(ref), f
        for k, v in ref.items():
            assert got[k].dtype == v.dtype == np.float32, k
            np.testing.assert_array_equal(got[k], v, err_msg=f"{f} {k}")
    vae_keys = load_file(tmp_path / "port" / "vae" /
                         "diffusion_pytorch_model.safetensors")
    assert any(".query." in k for k in vae_keys) == legacy
    for name, kw in (("unet_state_shapes", {}),
                     ("vae_state_shapes", {"legacy_attn": legacy}),
                     ("text_state_shapes", {})):
        got = getattr(make_fake_sd_ckpt, name)(**kw)
        assert list(got.items()) == list(getattr(jtool, name)(**kw).items())
    n_unet = sum(int(np.prod(s))
                 for s in make_fake_sd_ckpt.unet_state_shapes().values())
    assert 0.85e9 < n_unet < 0.87e9             # SD1.5-inpainting's UNet


@pytest.mark.parametrize("legacy", [False, True], ids=["to_q", "legacy"])
def test_fake_sd_ckpt_twin_loads_strictly(tmp_path, legacy):
    """The twin's tiny checkpoint fills the tiny towers through
    load_sd_weights(strict=True): every key matched, every parameter
    overwritten."""
    from gbnerf_tpu_torch.guidance.text import CLIPTextConfig, CLIPTextEncoder
    from gbnerf_tpu_torch.guidance.unet import UNet2DCondition, UNetConfig
    from gbnerf_tpu_torch.guidance.vae import AutoencoderKL, VAEConfig
    from gbnerf_tpu_torch.guidance.weights import load_sd_weights
    from gbnerf_tpu_torch.tools import make_fake_sd_ckpt

    make_fake_sd_ckpt.save_ckpt(str(tmp_path), tiny=True, legacy_attn=legacy)
    torch.manual_seed(0)
    towers = (UNet2DCondition(UNetConfig.tiny()), AutoencoderKL(
        VAEConfig.tiny()), CLIPTextEncoder(CLIPTextConfig(
            vocab_size=49408, width=32, layers=2, heads=2)))
    init = [{k: p.detach().clone() for k, p in m.named_parameters()}
            for m in towers]
    load_sd_weights(str(tmp_path), *towers, strict=True)
    for m, before in zip(towers, init):
        for k, p in m.named_parameters():
            assert not torch.equal(before[k], p.detach()), k


@pytest.mark.parametrize("suffix", [".pth", ".safetensors"])
def test_convert_vgg_twin_equals_the_jax_tool(tmp_path, monkeypatch, suffix):
    """A seeded fake VGG16 and lpips heads (``lin{k}`` keys in the .pth
    case, ``lins.{k}`` in the .safetensors one) saved in either format:
    the twin's npz equals tools/convert_vgg.py's, array for array."""
    from safetensors.numpy import save_file

    from gbnerf_tpu_torch.tools import convert_vgg

    rng = np.random.default_rng(0)
    widths = (64, 64, 128, 128, 256, 256, 256, 512, 512, 512, 512, 512, 512)
    vgg, cin = {}, 3
    for idx, cout in zip(convert_vgg.TORCH_CONV_IDX, widths):
        vgg[f"features.{idx}.weight"] = rng.normal(
            0, 0.05, (cout, cin, 3, 3)).astype(np.float32)
        vgg[f"features.{idx}.bias"] = rng.normal(0, 0.1, cout).astype(
            np.float32)
        cin = cout
    head = "lin{}" if suffix == ".pth" else "lins.{}"
    lp = {f"{head.format(k)}.model.1.weight": rng.random(
        (1, c, 1, 1)).astype(np.float32)
        for k, c in enumerate((64, 128, 256, 512, 512))}
    for name, sd in (("vgg", vgg), ("lpips", lp)):
        path = tmp_path / f"{name}{suffix}"
        if suffix == ".pth":
            torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
        else:
            save_file(sd, str(path))
    src = str(tmp_path / f"vgg{suffix}")
    heads = ["--lpips", str(tmp_path / f"lpips{suffix}")]
    convert_vgg.main([src, str(tmp_path / "port.npz")] + heads)
    monkeypatch.setattr(sys, "argv", ["convert_vgg.py", src,
                                      str(tmp_path / "jax.npz")] + heads)
    _tool("convert_vgg").main()
    got, ref = np.load(tmp_path / "port.npz"), np.load(tmp_path / "jax.npz")
    assert sorted(got.files) == sorted(ref.files)
    assert len(ref.files) == 2 * 13 + 5
    for k in ref.files:
        assert got[k].dtype == ref[k].dtype == np.float32, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_quality_table_reads_the_quality_runs_results(tmp_path):
    """tools/quality_table.py on a RESULTS dir laid out as
    tools/quality_runs.sh writes it: each arm's last eval at four
    decimals and its median ms a step (1e3 / iters_per_sec over the
    i_print records), and the prior's and the LoRA's seconds."""
    from gbnerf_tpu_torch.tools import quality_table

    run = tmp_path / "q" / "r2"
    run.mkdir(parents=True)
    recs = [{"iter": 250 * k, "iters_per_sec": v}
            for k, v in ((1, 10.0), (2, 20.0), (3, 40.0))]
    recs.append({"iter": 750, "eval_psnr": 30.123456,
                 "eval_psnr_masked": 25.000049, "eval_psnr_unmasked": 33.5})
    (run / "nog.metrics.jsonl").write_text(
        "".join(json.dumps(r) + "\n" for r in recs))
    (run / "prior_train.log").write_text(
        "[prior] phase A: 1500 VAE steps in 141.378 s\n"
        "[unet 6000/6000] loss=0.0088 (5 it/s)\n"
        "[prior] phase B: 6000 UNet steps in 1217.121 s\n")
    (run / "lora.log").write_text("[lora] 1000 steps in 301.5 s\n")
    rows = quality_table.main([str(tmp_path / "q")])
    nog = [r for r in rows if r["arm"] == "nog"][0]
    assert nog["ms_median"] == 50.0 and nog["iter"] == 750
    assert (nog["psnr_masked"], nog["psnr_unmasked"], nog["psnr"]) == (
        25.0, 33.5, 30.1235)
    timed = {r["arm"]: (r["steps"], r["seconds"]) for r in rows
             if "seconds" in r}
    assert timed == {"prior A": (1500, 141.378), "prior B": (6000, 1217.121),
                     "lora": (1000, 301.5)}
