"""The port's twin of ``jax.random`` (utils/jax_random.py) and of Flax's
initial parameters (utils/jax_init.py) against the installed jax and flax.

Bounds, with their reasons:
- keys (``PRNGKey``, ``split``, ``fold_in``), the raw bits, ``uniform``
  and ``randint``: bit for bit, in both ``jax_threefry_partitionable``
  modes (integer arithmetic, and one f32 rounding that the twin makes as
  XLA makes it); so are the render's sorted uniforms (their cumsum added
  in the order of jax's CPU cumsum);
- ``normal``, ``truncated_normal`` and ``exponential``: within ``ULP`` = 4
  units in the last place of f32, and equal on more than 99.9 % of the
  draws. The twin evaluates XLA's own f32 ``log1p`` and ``erf_inv``
  formulas with XLA's fused multiply-adds, but not every contraction the
  CPU compiler picks (seen: ≤ 2 ulp on 1 normal in 20,000);
- the initial parameters: every leaf within the same ``ULP`` (the lecun
  kernels are truncated normals times a scale, one more rounding). The
  random LPIPS VGG's init is held through the stage-2 whole run of
  tests/test_torch_run_parity.py, which builds it in both packages.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from gbnerf_tpu_torch import convert
from gbnerf_tpu_torch.utils import jax_init as ji
from gbnerf_tpu_torch.utils import jax_random as jr

ULP = 4
SETTINGS = settings(max_examples=25, deadline=None,
                    suppress_health_check=[HealthCheck.too_slow])


class threefry_mode:
    """jax_threefry_partitionable (and optionally x64) for a with-block,
    restored after it."""

    def __init__(self, partitionable: bool, x64: bool = False):
        self.want = (partitionable, x64)

    def __enter__(self):
        self.old = (jax.config.jax_threefry_partitionable,
                    jax.config.jax_enable_x64)
        jax.config.update("jax_threefry_partitionable", self.want[0])
        jax.config.update("jax_enable_x64", self.want[1])

    def __exit__(self, *exc):
        jax.config.update("jax_threefry_partitionable", self.old[0])
        jax.config.update("jax_enable_x64", self.old[1])


def words(key) -> tuple:
    return tuple(int(x) for x in np.asarray(key))


def ulp(a, b) -> np.ndarray:
    """|a − b| in f32 units in the last place (ordered-integer distance)."""
    def ordered(x):
        i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return np.abs(ordered(a) - ordered(b))


seeds = st.integers(-2 ** 31, 2 ** 31 - 1)
# a few shapes (odd and even counts, 0-d to 3-d), so that jax compiles
# each draw once and the examples vary the keys
shapes = st.sampled_from([(), (1,), (7,), (4, 6), (3, 5, 2)])


@pytest.mark.parametrize("partitionable", [True, False])
@SETTINGS
@given(seed=seeds, num=st.integers(1, 7),
       data=st.integers(0, 2 ** 32 - 1), depth=st.integers(0, 3))
def test_keys_split_and_fold_in_bit_exact(partitionable, seed, num, data,
                                          depth):
    with threefry_mode(partitionable):
        k, t = jax.random.PRNGKey(seed), jr.PRNGKey(
            seed, partitionable=partitionable)
        assert words(k) == t.words()
        for _ in range(depth):       # a key tree: split, keep the last
            k = jax.random.split(k, num)[-1]
            t = jr.key_split(t, num)[-1]
            k, t = jax.random.fold_in(k, data), jr.key_fold_in(t, data)
        assert words(k) == t.words()
        ref = [words(x) for x in jax.random.split(k, num)]
        assert ref == [x.words() for x in jr.key_split(t, num)]


@pytest.mark.parametrize("partitionable", [True, False])
@SETTINGS
@given(seed=seeds, shape=shapes)
def test_bits_uniform_randint_bit_exact(partitionable, seed, shape):
    with threefry_mode(partitionable):
        k, t = jax.random.PRNGKey(seed), jr.PRNGKey(
            seed, partitionable=partitionable)
        bits = np.asarray(jax.random.bits(k, shape)).astype(np.int64)
        assert np.array_equal(bits, jr.random_bits(t, shape).numpy())
        assert np.array_equal(np.asarray(jax.random.uniform(k, shape)),
                              jr.uniform(t, shape).numpy())
        lo, hi = -3.5, 7.25      # a span that is not a power of two
        assert np.array_equal(
            np.asarray(jax.random.uniform(k, shape, jnp.float32, lo, hi)),
            jr.uniform(t, shape, torch.float32, None, lo, hi).numpy())
        for a, b in ((0, 7), (-5, 100003), (3, 2 ** 31 - 1), (4, 4)):
            ref = np.asarray(jax.random.randint(k, shape, a, b))
            assert np.array_equal(ref, jr.randint(t, shape, a, b).numpy()), \
                (a, b)


@pytest.mark.parametrize("partitionable", [True, False])
def test_randint_with_a_span_the_data_sets(partitionable):
    """randint's maxval as a 0-d tensor (the LPIPS patch draw's count)."""
    with threefry_mode(partitionable):
        for seed, count in ((0, 1), (1, 77), (2, 70000), (3, 0)):
            k = jax.random.PRNGKey(seed)
            ref = jax.jit(lambda k, c: jax.random.randint(
                k, (9,), 0, jnp.maximum(c, 1)))(k, jnp.int32(count))
            got = jr.randint(jr.PRNGKey(seed, partitionable=partitionable),
                             (9,), 0, torch.tensor(count).clamp_min(1))
            assert np.array_equal(np.asarray(ref), got.numpy())


@pytest.mark.parametrize("partitionable", [True, False])
@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 - 1])
def test_normal_truncated_normal_exponential_within_ulp(partitionable, seed):
    shape = (257, 131)
    with threefry_mode(partitionable):
        k = jax.random.PRNGKey(seed)
        t = jr.PRNGKey(seed, partitionable=partitionable)
        pairs = {
            "normal": (jax.random.normal(k, shape), jr.normal(t, shape)),
            "truncated_normal": (
                jax.random.truncated_normal(k, -2.0, 2.0, shape),
                jr.truncated_normal(t, -2.0, 2.0, shape)),
            "exponential": (jax.random.exponential(k, shape),
                            jr.exponential(t, shape)),
        }
        for name, (ref, got) in pairs.items():
            d = ulp(np.asarray(ref), got.numpy())
            assert d.max() <= ULP, (name, int(d.max()))
            assert np.mean(d == 0) > 0.999, name


@pytest.mark.parametrize("partitionable", [True, False])
def test_sorted_uniforms_bit_exact(partitionable):
    """The render's fine-sample uniforms (exponential gaps, cumsum in jax's
    CPU order, normalised): bit for bit, at the render's 64 and a length
    that takes two levels of blocks."""
    from gbnerf_tpu.ops.resample import sorted_uniform as j_sorted
    from gbnerf_tpu_torch.ops.resample import sorted_uniform as t_sorted

    with threefry_mode(partitionable):
        for shape in ((512, 64), (9, 300)):
            ref = np.asarray(j_sorted(jax.random.PRNGKey(3), shape))
            got = t_sorted(shape, generator=jr.PRNGKey(
                3, partitionable=partitionable))
            assert np.array_equal(ref, got.numpy()), shape


def test_x64_keys_uniform_exponential_randint():
    """Under jax_enable_x64 (the f64 parity runs): f64 uniforms bit for
    bit, int64 randint bit for bit, f64 exponentials at 1e-13."""
    for partitionable in (True, False):
        with threefry_mode(partitionable, x64=True):
            k = jax.random.PRNGKey(5)
            t = jr.PRNGKey(5, partitionable=partitionable, x64=True)
            assert words(k) == t.words()
            u = np.asarray(jax.random.uniform(k, (99, 7), jnp.float64))
            assert np.array_equal(u, jr.uniform(t, (99, 7),
                                                torch.float64).numpy())
            r = np.asarray(jax.random.randint(k, (99,), 0, 12345))
            assert r.dtype == np.int64
            assert np.array_equal(r, jr.randint(t, (99,), 0, 12345).numpy())
            e = np.asarray(jax.random.exponential(k, (99, 7), jnp.float64))
            np.testing.assert_allclose(
                jr.exponential(t, (99, 7), torch.float64).numpy(), e,
                rtol=1e-13)


def test_draw_helpers_keep_the_torch_stream():
    """With a torch.Generator the helpers are torch's own draws, in the
    same order: split and fold_in hand the generator back."""
    g1, g2 = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    a, b = jr.split(g1, 4)[:2]
    assert a is g1 and b is g1 and jr.fold_in(g1, 9) is g1
    got = [jr.draw("rand", (5,), g1), jr.draw("randn", (5,), g1),
           jr.draw("exponential", (5,), g1), jr.randint_(g1, 0, 9, (5,))]
    ref = [torch.rand((5,), generator=g2), torch.randn((5,), generator=g2),
           torch.empty(5).exponential_(generator=g2),
           torch.randint(0, 9, (5,), generator=g2)]
    for x, y in zip(got, ref):
        assert torch.equal(x, y)


@SETTINGS
@given(seed=st.integers(0, 2 ** 31 - 1),
       path=st.lists(st.sampled_from(["Dense_0", "conv_in", "layers_1",
                                      "down_0_resnets_1", "ws0", "é"]),
                     max_size=4),
       counter=st.integers(1, 300))
def test_param_key_is_flax_fold_in_static(seed, path, counter):
    from flax.core.scope import _fold_in_static

    ref = _fold_in_static(jax.random.PRNGKey(seed), tuple(path) + (counter,))
    assert words(ref) == ji.param_key(jr.PRNGKey(seed), path,
                                      counter).words()


def assert_tree_within_ulp(ref, got, prefix=""):
    assert set(ref) == set(got), prefix
    for name, v in ref.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            assert_tree_within_ulp(v, got[name], prefix + name + "/")
            continue
        a, b = np.asarray(v, np.float32), np.asarray(got[name], np.float32)
        assert a.shape == b.shape, prefix + name
        d = ulp(a, b)
        assert d.max() <= ULP, (prefix + name, int(d.max()))


PTS, DIRS = jnp.zeros((8, 3)), jnp.ones((8, 3)) / jnp.sqrt(3.0)


@pytest.mark.parametrize("res,rank,seed", [((5, 9, 17), 4, 0),
                                           ((17, 33, 65, 129, 257), 16, 3)])
def test_cp_field_init_matches_flax(res, rank, seed):
    from gbnerf_tpu.core.cp_field import CPGridField as JCP
    from gbnerf_tpu_torch.core.cp_field import CPGridField

    ref = jax.jit(JCP(bound=2.0, resolutions=res, rank=rank).init)(
        jax.random.PRNGKey(seed), PTS, DIRS)["params"]
    tm = CPGridField(bound=2.0, resolutions=res, rank=rank)
    ji.init_field(tm, jr.PRNGKey(seed))
    assert_tree_within_ulp(ref, convert.params_to_jax(
        {"f": tm.state_dict()})["f"])


def test_nerf_mlp_and_hash_field_init_match_flax():
    from gbnerf_tpu.core.fields import HashGridField as JHash
    from gbnerf_tpu.core.fields import NeRFMLP as JMLP
    from gbnerf_tpu_torch.core.fields import HashGridField, NeRFMLP

    kw = dict(depth=4, width=32, skips=(2,), multires=4, multires_views=2)
    ref = jax.jit(JMLP(**kw).init)(jax.random.PRNGKey(1), PTS,
                                   DIRS)["params"]
    tm = ji.init_field(NeRFMLP(**kw), jr.PRNGKey(1))
    assert_tree_within_ulp(ref, convert.params_to_jax(
        {"f": tm.state_dict()})["f"])
    hk = dict(bound=1.5, n_levels=4, n_features=2, log2_hashmap_size=8)
    ref = jax.jit(JHash(**hk).init)(jax.random.PRNGKey(2), PTS,
                                    DIRS)["params"]
    tm = ji.init_field(HashGridField(**hk), jr.PRNGKey(2))
    assert_tree_within_ulp(ref, convert.params_to_jax(
        {"f": tm.state_dict()})["f"])


TEXT_CFG = dict(vocab_size=49408, width=32, layers=2, heads=2)


@pytest.fixture(scope="module")
def twin_sd():
    """The port's tiny SD towers with the twin's init from PRNGKey(11), as
    build_sd_modules gives them (split in three: UNet, VAE, text)."""
    from gbnerf_tpu_torch.guidance.text import (CLIPTextConfig,
                                                CLIPTextEncoder)
    from gbnerf_tpu_torch.guidance.unet import UNet2DCondition, UNetConfig
    from gbnerf_tpu_torch.guidance.vae import AutoencoderKL, VAEConfig

    u, v = UNet2DCondition(UNetConfig.tiny()), AutoencoderKL(VAEConfig.tiny())
    t = CLIPTextEncoder(CLIPTextConfig(**TEXT_CFG))
    ji.init_sd(u, v, t, jr.PRNGKey(11))
    return dict(zip(("unet", "vae", "text"),
                    convert.sd_params_to_jax(u, v, t)))


@pytest.mark.parametrize("tower", ["text", "vae", "unet"])
def test_tiny_sd_init_matches_flax(twin_sd, tower):
    """Each tower against its flax ``init`` under the key build_sd_modules
    gives it (the UNet's by ``lazy_init``, the same keys and values
    without the forward's compute: a quicker compile)."""
    from gbnerf_tpu.guidance.text import CLIPTextConfig, CLIPTextEncoder
    from gbnerf_tpu.guidance.unet import UNet2DCondition, UNetConfig
    from gbnerf_tpu.guidance.vae import AutoencoderKL, VAEConfig

    S = jax.ShapeDtypeStruct
    keys = dict(zip(("unet", "vae", "text"),
                    jax.random.split(jax.random.PRNGKey(11), 3)))
    tc = CLIPTextConfig(**TEXT_CFG)
    if tower == "text":
        ref = jax.jit(CLIPTextEncoder(tc, dtype=jnp.float32).init)(
            keys["text"], jnp.zeros((1, tc.max_length), jnp.int32))
    elif tower == "vae":
        ref = jax.jit(AutoencoderKL(VAEConfig.tiny(),
                                    dtype=jnp.float32).init)(
            keys["vae"], jnp.zeros((1, 8, 8, 3)))   # init: any size
    else:
        uc = UNetConfig.tiny()
        ref = UNet2DCondition(uc, dtype=jnp.float32).lazy_init(
            keys["unet"], S((1, 8, 8, uc.in_channels), jnp.float32),
            S((), jnp.float32),
            S((1, tc.max_length, uc.cross_attention_dim), jnp.float32))
    assert_tree_within_ulp(jax.tree_util.tree_map(np.asarray,
                                                  ref["params"]),
                           twin_sd[tower])
