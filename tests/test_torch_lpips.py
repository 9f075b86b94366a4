"""Port vs JAX: LPIPS (gbnerf_tpu_torch/utils/lpips.py against
gbnerf_tpu/utils/lpips.py) on one set of weights, carried across by
``convert.lpips_params_from_jax``.

Tolerances: both sides run the same f32 convolutions in another order of
summation, so the distance to rtol 1e-4 and the input gradient to atol
1e-3·max|ref|.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gbnerf_tpu.utils import lpips as jlpips
from gbnerf_tpu_torch import convert
from gbnerf_tpu_torch.utils import lpips as tlpips
from tools.convert_vgg import TORCH_CONV_IDX, convert as convert_vgg

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def random_pair():
    j = jlpips.LPIPS(jax.random.PRNGKey(0))
    t = tlpips.LPIPS(weights=jax.tree_util.tree_map(np.asarray, j.params))
    return j, t


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.random(shape).astype(np.float32) for _ in range(2)]


def _check(j, t, a, b):
    ref = np.asarray(j(jnp.asarray(a), jnp.asarray(b)))
    ta = torch.from_numpy(a).requires_grad_(True)
    got = t(ta, torch.from_numpy(b))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=1e-4)
    jg = np.asarray(jax.grad(lambda x: jnp.sum(j(x, jnp.asarray(b))))(
        jnp.asarray(a)))
    (tg,) = torch.autograd.grad(got.sum(), ta)
    np.testing.assert_allclose(tg.numpy(), jg, rtol=0,
                               atol=1e-3 * np.abs(jg).max())
    return got


@pytest.mark.parametrize("shape", [(2, 40, 48, 3), (4, 32, 32, 3)])
def test_lpips_distance_and_input_gradient_match_jax(random_pair, shape):
    j, t = random_pair
    _check(j, t, *_inputs(shape, 1))


def test_lpips_upsamples_patches_below_32(random_pair):
    """20 × 24 patches are resized to 32 × 32 (bilinear, as
    jax.image.resize) before the VGG; one side at 32 stays as it is."""
    j, t = random_pair
    got = _check(j, t, *_inputs((3, 20, 24, 3), 2))
    assert torch.isfinite(got).all()
    _check(j, t, *_inputs((1, 16, 40, 3), 3))


def test_lpips_lin_weights_from_a_converted_npz(tmp_path):
    """A synthetic torchvision-keyed VGG16 with lpips lin heads, written by
    tools/convert_vgg.py, loaded by both packages' load_vgg16_npz."""
    rng = np.random.default_rng(0)
    cfg = (64, 64, 128, 128, 256, 256, 256, 512, 512, 512, 512, 512, 512)
    vgg_sd, cin = {}, 3
    for idx, cout in zip(TORCH_CONV_IDX, cfg):
        vgg_sd[f"features.{idx}.weight"] = \
            rng.normal(0, 0.05, (cout, cin, 3, 3)).astype(np.float32)
        vgg_sd[f"features.{idx}.bias"] = \
            rng.normal(0, 0.01, cout).astype(np.float32)
        cin = cout
    lpips_sd = {f"lin{k}.model.1.weight":
                rng.uniform(0, 1, (1, c, 1, 1)).astype(np.float32)
                for k, c in enumerate((64, 128, 256, 512, 512))}
    path = str(tmp_path / "vgg.npz")
    np.savez(path, **convert_vgg(vgg_sd, lpips_sd))

    tw = tlpips.load_vgg16_npz(path)
    jw = jlpips.load_vgg16_npz(path)
    assert tw.keys() == jw.keys()
    t = tlpips.LPIPS(weights=tw)
    j = jlpips.LPIPS(jax.random.PRNGKey(1), weights=jw)
    assert t.lins is not None and j.lins is not None
    np.testing.assert_array_equal(t.net.conv_0.weight.numpy(),
                                  vgg_sd["features.0.weight"])
    a, b = _inputs((2, 36, 44, 3), 4)
    d_lin = _check(j, t, a, b)
    # the lin heads change the distance against the channel-mean fallback
    nolin = tlpips.LPIPS(weights={k: v for k, v in tw.items()
                                  if not k.startswith("lin_")})
    assert nolin.lins is None
    d_mean = nolin(torch.from_numpy(a), torch.from_numpy(b))
    assert not torch.allclose(d_lin.detach(), d_mean, rtol=1e-2)


def test_lpips_random_weights_are_seeded():
    a, b = (torch.from_numpy(x) for x in _inputs((1, 32, 32, 3), 5))
    d = [tlpips.LPIPS(torch.Generator().manual_seed(s))(a, b) for s in
         (7, 7, 8)]
    assert torch.equal(d[0], d[1]) and not torch.equal(d[0], d[2])
    sd, lins = convert.lpips_params_from_jax(
        {"conv_0": {"kernel": np.zeros((3, 3, 3, 64)),
                    "bias": np.zeros(64)}})
    assert sd["conv_0.weight"].shape == (64, 3, 3, 3) and lins is None
