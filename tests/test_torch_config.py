"""Port vs JAX: the config schema. gbnerf_tpu_torch/config.py is a copy of
gbnerf_tpu/config.py, so that the port imports nothing of the JAX package;
these tests hold the copy to the original: the same dataclasses, fields and
defaults, the same key mapping, the same dump, exactly (no tolerance: a
config is data)."""
import dataclasses
from pathlib import Path

import pytest

import gbnerf_tpu.config as jcfg
import gbnerf_tpu_torch.config as tcfg

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = sorted((ROOT / "configs").glob("*.txt"))
SECTIONS = ("field", "render", "data", "guidance", "train", "mesh")


def _schema(mod):
    return {s: [(f.name, f.type, f.default if f.default is not
                 dataclasses.MISSING else f.default_factory())
                for f in dataclasses.fields(getattr(mod.Config(), s))]
            for s in SECTIONS}


def test_schema_and_flag_map_are_the_jax_packages():
    assert _schema(tcfg) == _schema(jcfg)
    assert tcfg._FLAG_MAP == jcfg._FLAG_MAP
    assert dataclasses.asdict(tcfg.Config()) == dataclasses.asdict(
        jcfg.Config())


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.name)
def test_every_shipped_config_loads_alike(path):
    assert CONFIGS
    got = tcfg.load_reference_config(str(path))
    assert dataclasses.asdict(got) == dataclasses.asdict(
        jcfg.load_reference_config(str(path)))


def test_reference_style_file_loads_alike(tmp_path):
    """Quoted '#' strings, None resets, a bare int for a tuple knob,
    nargs-style float tuples, the reference's aliases and dead flags."""
    p = tmp_path / "c.txt"
    p.write_text("\n".join([
        "# a comment", "expname = 42", "sd_version = 1.5",
        'prompt = "a #1 fan photo"', "text_normal = a normal map # trailing",
        "cp_resolutions_coarse = 65", "cp_rank_coarse = None",
        "t_range = 0.05 0.9", "radius_range = 2.5,3.0",
        "normal_start = 0", "rgb_guidance_scale = 5.0", "chunk = 4096",
        "guidance = SD,CLIP", "guidance_tp = 2", "white_bkgd = True",
        "guidance_scale = 75", "not_a_flag = 3", "no equals sign here"]))
    got = tcfg.load_reference_config(str(p))
    assert dataclasses.asdict(got) == dataclasses.asdict(
        jcfg.load_reference_config(str(p)))
    assert got.train.expname == "42" and got.guidance.prompt == "a #1 fan photo"
    assert got.field.cp_resolutions_coarse == (65,)
    assert got.guidance.t_range == (0.05, 0.9)


def test_save_config_round_trips_and_matches_the_jax_dump(tmp_path):
    cfg = tcfg.Config(
        guidance=tcfg.GuidanceConfig(tp=2, t_range=(0.05, 0.9),
                                     prompt="a #1 bench"),
        field=tcfg.FieldConfig(cp_resolutions_coarse=(17, 33, 65)),
        train=tcfg.TrainConfig(expname="7", N_rand=256))
    jc = jcfg.Config(
        guidance=jcfg.GuidanceConfig(tp=2, t_range=(0.05, 0.9),
                                     prompt="a #1 bench"),
        field=jcfg.FieldConfig(cp_resolutions_coarse=(17, 33, 65)),
        train=jcfg.TrainConfig(expname="7", N_rand=256))
    tcfg.save_config(cfg, str(tmp_path / "t" / "config.txt"))
    jcfg.save_config(jc, str(tmp_path / "j" / "config.txt"))
    dump = (tmp_path / "t" / "config.txt").read_text()
    assert dump == (tmp_path / "j" / "config.txt").read_text()
    assert tcfg.load_reference_config(str(tmp_path / "t" / "config.txt")) \
        == cfg
    # each package reads the other's dump
    assert dataclasses.asdict(jcfg.load_reference_config(
        str(tmp_path / "t" / "config.txt"))) == dataclasses.asdict(cfg)


@pytest.mark.parametrize("mod", [jcfg, tcfg], ids=["jax", "torch"])
def test_unknown_fields_are_refused_alike(mod):
    """Unknown keys in a file are ignored by both loaders (the reference has
    many dead flags, test above); an unknown field name in code is a
    TypeError in both, and the dataclasses are frozen."""
    with pytest.raises(TypeError):
        mod.FieldConfig(nope=1)
    with pytest.raises(TypeError):
        dataclasses.replace(mod.Config().train, nope=1)
    with pytest.raises(TypeError):
        mod.Config(nope=mod.TrainConfig())
    with pytest.raises(dataclasses.FrozenInstanceError):
        mod.Config().train.N_rand = 3
    hash(mod.Config())
