"""The same seed gives the same traffic, and every seed the same sizes."""
import numpy as np
import torch

from benchmark.harness import weights as wt
from benchmark.inputs import lora_data
from benchmark.inputs import scene as sc


def _same(a, b):
    return all(np.array_equal(a[k], b[k]) for k in a)


def test_scene_from_the_seed():
    a = sc.spinnerf_scene(4, 24, 32, 1, seed=5)
    b = sc.spinnerf_scene(4, 24, 32, 1, seed=5)
    c = sc.spinnerf_scene(4, 24, 32, 1, seed=6)
    for k in ("images", "masks", "inpainted_depths", "poses"):
        assert np.array_equal(a[k], b[k]) and a[k].shape == c[k].shape
    assert all(_same(x, y) for x, y in zip(a["depth_gts"], b["depth_gts"]))
    assert not all(_same(x, y) for x, y in zip(a["depth_gts"],
                                               c["depth_gts"]))
    assert [len(g["depth"]) for g in a["depth_gts"]] == \
        [len(g["depth"]) for g in c["depth_gts"]]


def test_camera_arc_and_lora_draws():
    assert np.array_equal(sc.camera_arc(6, seed=3), sc.camera_arc(6, seed=3))
    assert not np.array_equal(sc.camera_arc(6, seed=3),
                              sc.camera_arc(6, seed=4))
    d = [lora_data.batch_draws(np.random.default_rng(s), 10, 4, 32)
         for s in (1, 1, 2)]
    assert np.array_equal(d[0][0], d[1][0]) and np.array_equal(d[0][1],
                                                               d[1][1])
    assert d[2][1].shape == d[0][1].shape


def test_lora_images_from_the_seed(tmp_path):
    a = lora_data.make(str(tmp_path / "a"), 3, 32, 9)
    b = lora_data.make(str(tmp_path / "b"), 3, 32, 9)
    assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
    assert a[2] == b[2]
    from gbnerf_tpu_torch.utils.png import read_png

    assert np.array_equal(read_png(str(tmp_path / "a" / "images" /
                                       "view_001.png")), a[0][1])


def test_weights_from_the_seed():
    def filled(seed):
        m = torch.nn.Module()
        m.proj, m.norm = torch.nn.Linear(4, 8), torch.nn.LayerNorm(8)
        wt.fill(m, seed)
        return {k: v.detach().clone() for k, v in m.named_parameters()}

    a, b, c = filled(3), filled(3), filled(4)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["proj.weight"], c["proj.weight"])
    assert torch.equal(a["norm.weight"], torch.ones(8))
    assert torch.equal(a["proj.bias"], torch.zeros(8))
    assert 0.2 < float(a["proj.weight"].std()) < 0.8     # N(0, 1/4)
