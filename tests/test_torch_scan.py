"""The transmittance of the port's compositing against the JAX package's
TPU branch.

On the TPU, gbnerf_tpu/ops/scan.py:22-27 turns the exclusive cumprod of
raw2outputs into exp∘cumsum∘log, the cumsum one triangular matmul at
HIGHEST precision (``_cumsum_mm``), and only at ≥ 2¹⁹ elements. Stage 1
renders each ray stream alone at N_rand = 1024 rays
(gbnerf_tpu/train/step.py:256,277,285; gbnerf_tpu/config.py:223), so its
[1024, 64] and [1024, 128] compositings never take that form: the
reference's stage-1 training never ran it. It runs in the eval renderer's
32768-ray blocks and in stage 2's fine pass over the masked pixels,
padded to K_max (gbnerf_tpu/data/rays_bank.py:153-154): 7,168 of them on
the ablation's round-5 scene, [7168, 128]. The tests check the size rule
and the formula: there, with exactly opaque samples, the port's
torch.cumprod (gbnerf_tpu_torch/ops/scan.py) gives the same colour and σ
gradient as exp∘cumsum∘log. On the CPU the HIGHEST-precision einsum is
plain f32, so the MXU's own rounding (7e-4 relative, scan.py:10-12) is
not measured here.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
import torch

from gbnerf_tpu.core import render as jrender
from gbnerf_tpu.ops import scan as jscan
from gbnerf_tpu_torch.core import render as trender

K_MAX, S = 7168, 128          # stage 2's fine pass on the round-5 scene
OPAQUE = 0.059                # the share of exactly opaque samples


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    step = 4.0 / S
    z = (np.linspace(2.0, 6.0, S)[None] + rng.uniform(
        0, 0.5 * step, (K_MAX, S))).astype(np.float32)
    rays_d = rng.normal(size=(K_MAX, 3)).astype(np.float32)
    raw = rng.normal(size=(K_MAX, S, 4)).astype(np.float32)
    raw[..., 3] *= 5.0
    hit = rng.random((K_MAX, S)) < OPAQUE
    raw[..., 3][hit] = 1e5        # σ·δ ≫ 104: exp underflows, α = 1
    weight = rng.normal(size=(K_MAX, 3)).astype(np.float32)
    return raw, z, rays_d, weight


def test_stage1_shapes_never_take_the_tpu_matmul():
    """The size rule of scan.py:22-27: stage 1's streams lie below it,
    stage 2's fine pass at K_max and the eval blocks above it."""
    for n_samples in (64, 128):
        assert 1024 * n_samples < jscan._MM_MIN_SIZE
    assert K_MAX * S >= jscan._MM_MIN_SIZE
    assert 32768 * 64 >= jscan._MM_MIN_SIZE


def test_cumprod_transmittance_matches_the_tpu_formula(monkeypatch):
    """At [7168, 128] with exactly opaque samples: the port's raw2outputs
    colour within 1e-6 of the JAX package's raw2outputs on its TPU branch
    (exp of _cumsum_mm of log max(1 − α, 1e-10)), and d(colour·w)/dσ at
    cosine ≥ 0.99999."""
    raw, z, rays_d, weight = _inputs()
    calls = []
    mm = jscan._cumsum_mm

    def counted(x, **kw):
        calls.append(x.shape)
        return mm(x, **kw)

    # the TPU's size rule, on this backend
    monkeypatch.setattr(jscan, "_use_mm",
                        lambda x: x.size >= jscan._MM_MIN_SIZE)
    monkeypatch.setattr(jscan, "_cumsum_mm", counted)

    def j_loss(sigma):
        r = jnp.concatenate([jnp.asarray(raw[..., :3]), sigma[..., None]],
                            axis=-1)
        out = jrender.raw2outputs(r, jnp.asarray(z), jnp.asarray(rays_d))
        return jnp.sum(out[0] * jnp.asarray(weight)), out

    (_, j_out), j_grad = jax.value_and_grad(j_loss, has_aux=True)(
        jnp.asarray(raw[..., 3]))
    assert calls == [(K_MAX, S)]
    alpha = np.asarray(j_out[5])
    assert (alpha == 1.0).mean() > 0.05

    sigma = torch.tensor(raw[..., 3], requires_grad=True)
    r = torch.cat([torch.from_numpy(raw[..., :3]), sigma[..., None]], -1)
    t_out = trender.raw2outputs(r, torch.from_numpy(z),
                                torch.from_numpy(rays_d))
    (t_out[0] * torch.from_numpy(weight)).sum().backward()

    t_alpha = t_out[5].detach().numpy()
    np.testing.assert_array_equal(t_alpha == 1.0, alpha == 1.0)
    np.testing.assert_allclose(t_alpha, alpha, rtol=0, atol=1e-7)
    np.testing.assert_allclose(t_out[0].detach().numpy(),
                               np.asarray(j_out[0]), rtol=0, atol=1e-6)
    a = sigma.grad.double().numpy().ravel()
    b = np.asarray(j_grad, np.float64).ravel()
    cos = a @ b / (np.linalg.norm(a) * np.linalg.norm(b))
    assert cos >= 0.99999, cos
