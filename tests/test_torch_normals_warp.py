"""Port vs JAX: the normal estimators (``pointcloud_normals``,
``field_normals``, ``estimate_normals_grad``), the reprojection helpers
(utils/warp.py) and the gallery helpers (utils/gallery.py).

``field_normals``: the JAX package maps grad over points of a [3] → σ
function; the port takes one autograd gradient of Σσ over a batch. With
``NeRFMLP`` in float64 on both sides they agree to 1e-6; on a converted
CP field (σ-only, the port's plain K2/K5 pair on the CPU, bf16 operands
summed in another order) every normal to cosine 0.999 and the median
to 0.99999.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gbnerf_tpu.config import Config, FieldConfig
from gbnerf_tpu.core import normals as jnormals
from gbnerf_tpu.core.fields import NeRFMLP as JNeRFMLP
from gbnerf_tpu.core.fields import make_field_fn as j_make_field_fn
from gbnerf_tpu.train.state import create_train_state
from gbnerf_tpu.utils import gallery as jgallery
from gbnerf_tpu.utils import warp as jwarp
from gbnerf_tpu_torch import convert
from gbnerf_tpu_torch.core import normals as tnormals
from gbnerf_tpu_torch.core.fields import NeRFMLP as TNeRFMLP
from gbnerf_tpu_torch.core.fields import make_field_fn as t_make_field_fn
from gbnerf_tpu_torch.train.state import create_params
from gbnerf_tpu_torch.utils import gallery as tgallery
from gbnerf_tpu_torch.utils import warp as twarp

torch.set_num_threads(1)


@pytest.mark.parametrize("cloud", ["plane", "sphere"])
def test_pointcloud_normals_match_jax(rng, cloud):
    if cloud == "plane":
        pts = np.concatenate([rng.random((300, 2)), 0.01 * rng.random(
            (300, 1))], 1)
    else:
        pts = rng.standard_normal((400, 3))
        pts /= np.linalg.norm(pts, axis=1, keepdims=True)
    got = tnormals.pointcloud_normals(pts, knn=12)
    np.testing.assert_array_equal(got, jnormals.pointcloud_normals(pts,
                                                                   knn=12))
    if cloud == "plane":
        assert np.abs(got[:, 2]).min() > 0.95
    else:
        assert np.abs(np.sum(got * pts, 1)).min() > 0.95


def test_field_normals_f64_matches_jax(rng):
    kw = dict(depth=3, width=32, skips=(1,), multires=4, multires_views=2)
    pts = rng.standard_normal((40, 3))
    jax.config.update("jax_enable_x64", True)
    try:
        jm = JNeRFMLP(compute_dtype=jnp.float64, **kw)
        params = jm.init(jax.random.PRNGKey(0), jnp.zeros((2, 3)),
                         jnp.zeros((2, 3)))["params"]
        params = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float64),
                                        params)
        jfn = j_make_field_fn(jm, params)
        vd = jnp.asarray([[0.0, 0.6, 0.8]])     # NeRFMLP reads a direction
        ref = np.asarray(jnormals.field_normals(
            lambda p: jfn(p[None, None], vd, sigma_only=True)[0, 0, 3],
            jnp.asarray(pts)))
    finally:
        jax.config.update("jax_enable_x64", False)
    tm = TNeRFMLP(compute_dtype=torch.float64, **kw).double()
    convert.load_jax_params(tm, params)
    tfn = t_make_field_fn(tm)
    vd = torch.tensor([[0.0, 0.6, 0.8]], dtype=torch.float64)
    got = tnormals.field_normals(
        lambda p: tfn(p[:, None, :], vd.expand(len(p), 3),
                      sigma_only=True)[:, 0, 3], torch.from_numpy(pts))
    assert got.shape == (40, 3) and got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)
    # a linear density: the exact normal, any leading shape
    lin = tnormals.field_normals(lambda p: p[:, 2] * 3.0,
                                 torch.zeros(2, 5, 3))
    np.testing.assert_allclose(lin.numpy(), np.broadcast_to([0, 0, -1.0],
                                                            (2, 5, 3)))


def test_field_normals_cp_matches_jax(rng):
    """σ-only CP field with converted params: the port's plain K2 forward
    and K5 backward (with the point gradient) against jax.grad."""
    cfg = Config(field=FieldConfig(cp_resolutions=(5, 9, 17), cp_rank=4,
                                   cp_bound=1.5))
    state, _, jf = create_train_state(cfg, jax.random.PRNGKey(1))
    params = jax.tree_util.tree_map(np.asarray, state.params)
    _, tf = create_params(cfg, torch.Generator().manual_seed(0))
    convert.load_jax_params(tf, params["fine"])
    pts = (rng.random((300, 3)) * 2.0 - 1.0).astype(np.float32)
    jfn = j_make_field_fn(jf, state.params["fine"])
    ref = np.asarray(jnormals.field_normals(
        lambda p: jfn(p[None, None], None, sigma_only=True)[0, 0, 3],
        jnp.asarray(pts)))
    tfn = t_make_field_fn(tf)
    got = tnormals.field_normals(
        lambda p: tfn(p[:, None, :], None, sigma_only=True)[:, 0, 3],
        torch.from_numpy(pts)).numpy()
    cos = np.sum(got * ref, -1)
    assert np.abs(np.linalg.norm(got, axis=-1) - 1).max() < 1e-5
    assert cos.min() > 0.999 and np.median(cos) > 0.99999, (cos.min(),
                                                            np.median(cos))


def test_estimate_normals_grad_matches_jax(rng):
    """Central differences inside, first-order one-sided at the edges."""
    depth = rng.random((7, 9)).astype(np.float32) * 3
    ref = np.asarray(jnormals.estimate_normals_grad(jnp.asarray(depth)))
    got = tnormals.estimate_normals_grad(torch.from_numpy(depth)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    edge = 0.5 * (-(depth[:, 1] - depth[:, 0]) + 1.0)
    np.testing.assert_allclose(got[:, 0, 0], edge, rtol=1e-6, atol=1e-6)


def _cameras(rng):
    f, H, W = 20.0, 12, 16
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)
    a = np.eye(3, 4, dtype=np.float32)
    th = 0.1
    b = np.array([[np.cos(th), 0, np.sin(th), 0.3],
                  [0, 1, 0, -0.1],
                  [-np.sin(th), 0, np.cos(th), 0.2]], np.float32)
    depth = (2.0 + rng.random((H, W))).astype(np.float32)
    return depth, K, a, b


def test_reproject_matches_jax(rng):
    depth, K, a, b = _cameras(rng)
    ref = jwarp.reproject(*(jnp.asarray(x) for x in (depth, K, a, b)))
    got = twarp.reproject(*(torch.from_numpy(x) for x in (depth, K, a, b)))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
    assert 0 < int(got[2].sum()) < depth.size
    # the same camera maps every pixel to itself
    coords, d, valid = twarp.reproject(*(torch.from_numpy(x) for x in
                                         (depth, K, a, a)))
    jj, ii = np.mgrid[0:12, 0:16]
    np.testing.assert_allclose(coords[..., 0].numpy(), ii, atol=1e-4)
    np.testing.assert_allclose(coords[..., 1].numpy(), jj, atol=1e-4)
    assert bool(valid[1:-1, 1:-1].all())
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jwarp.reproject(
        *(jnp.asarray(x) for x in (depth, K, a, a)))[2]))


def test_bilinear_sample_matches_jax(rng):
    img = rng.random((6, 7, 3)).astype(np.float32)
    coords = rng.uniform(-1.5, 8.0, (5, 9, 2)).astype(np.float32)
    coords[0, 0] = [2.0, 3.0]
    ref = np.asarray(jwarp.bilinear_sample(jnp.asarray(img),
                                           jnp.asarray(coords)))
    got = twarp.bilinear_sample(torch.from_numpy(img),
                                torch.from_numpy(coords)).numpy()
    assert got.shape == (5, 9, 3)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got[0, 0], img[3, 2])


def test_gallery_and_keypoints_match_jax(tmp_path, rng):
    png = tmp_path / "a" / "x.png"
    sections = {"renders <1>": [str(png), "rel/y.png"], "empty": []}
    t = tgallery.generate_html_gallery(str(tmp_path / "t"), sections,
                                       title="r & d", width=200)
    j = jgallery.generate_html_gallery(str(tmp_path / "j"), sections,
                                       title="r & d", width=200)
    assert t.endswith("index.html")
    text = open(t).read()
    assert text == open(j).read().replace(str(tmp_path / "j"),
                                          str(tmp_path / "t"))
    assert "../a/x.png" in text and "renders &lt;1&gt;" in text
    for image in ((rng.random((10, 12, 3)) * 255).astype(np.uint8),
                  rng.random((10, 12, 3)).astype(np.float32)):
        kp = [(0, 0), (5.4, 3.6), (11, 9), (20, 20)]
        got = tgallery.draw_keypoints(image, kp, radius=1, color=(0, 255, 0))
        ref = jgallery.draw_keypoints(image, kp, radius=1, color=(0, 255, 0))
        np.testing.assert_array_equal(got, ref)
        assert got.dtype == np.uint8
