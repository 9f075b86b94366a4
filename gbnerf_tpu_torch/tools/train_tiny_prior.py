"""Train a tiny diffusion-inpainting prior from scratch on procedurally
rendered sphere worlds (the weights-free stand-in for the reference's LoRA
scene prior).

    python -m gbnerf_tpu_torch.tools.train_tiny_prior OUT.msgpack
        [--res 128] [--n_domain 384] [--steps_vae 1500] [--steps_unet 4000]
        [--batch auto] [--lr 2e-3] [--chunk 50] [--seed 0]
        [--family spheres|hard] [--prompt ...] [--device cuda]
        [--draws torch|jax]

The port's twin of tools/train_tiny_prior.py, with its flags, defaults and
auto batch. It trains the tiny UNet/VAE stack (guidance/unet.py and vae.py
tiny configs, f32) that stage 2 builds for ``sd_tiny``, and writes
``{unet, vae, embeds_rgb, embeds_normal}`` as flax msgpack
(guidance/weights.py::save_prior_ckpt), which ``guidance.sd_prior_ckpt``
loads in either package.

Domain: random clean renders of the scene family (random albedo, radius,
light, sky and camera; ``hard``: random textured worlds with the torus
occluder) through the port's make_synthetic_scene twin, stretched from 3:4
to res², and their normal maps through the stage-2 functions
(core/normals.py: depth → depth2xyz → depth2normal_geo → (n + 1)/2). The
pool is RGB and normal maps together, cached beside OUT as .npz.

Phases (Adam each, as optax.adam):
  A. the VAE as an autoencoder: reconstruction MSE + 0.1·(E[z²] − 1)² +
     1e-3·E[mean_hw(z)²], so the scaled latents have about unit variance;
  B. the UNet's ε on the 9-channel inpainting input (noisy latents, mask,
     masked-image latents), t ~ U[0, 1000), the conditioning drawn from the
     three embeddings of the image's own modality (six in all).

The JAX tool runs ``--chunk`` steps per jitted fori_loop; here the steps
are a plain loop on the device and ``--chunk`` is the logging interval
(the loss of the chunk's last step). Every draw of ``vae_loss`` and
``unet_loss`` is an argument. ``--draws jax`` replays the JAX tool's
draws (utils/jax_random.py): the stack's init from PRNGKey(seed), the
steps' key chain from PRNGKey(seed + 10), split as its loops split it,
and its step counts (whole chunks: ceil(steps / chunk) · chunk); its log
lines then report what the JAX tool's do, the loss of a fresh batch drawn
from the chain's key after the chunk (which leaves the chain as it is).
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Dict

import numpy as np
import torch

from ..core.normals import depth2normal_geo, depth2xyz
from ..guidance.stable import _resize
from ..train.lora_trainer import random_mask
from ..utils import jax_random as jr
from .make_synthetic_scene import (look_at, random_hard_params,
                                   render_scene, render_scene_hard)


def make_domain_images(n: int, res: int, seed: int, family: str = "spheres"):
    """n random clean renders of the family (never the ablation scene's
    own world) at the ablation's 3:4 aspect, stretched to res² as the
    guidance path resizes every render to a square → (imgs, normal_maps),
    both [n, res, res, 3] in [0, 1]."""
    rng = np.random.default_rng(seed)
    H, W = res * 3 // 4, res
    focal = 1.2 * W
    K = torch.tensor([[focal, 0, W / 2], [0, focal, H / 2], [0, 0, 1]],
                     dtype=torch.float32)
    imgs = np.empty((n, res, res, 3), np.float32)
    nrms = np.empty((n, res, res, 3), np.float32)
    yy = (np.arange(res) * H / res).astype(int).clip(0, H - 1)
    for k in range(n):
        th = rng.uniform(-0.6, 0.6)
        el = rng.uniform(-0.25, 0.35)
        pos = np.array([2.5 * np.sin(th), el, 2.5 * np.cos(th)])
        if family == "hard":
            img, depth, _ = render_scene_hard(H, W, focal, look_at(pos),
                                              hp=random_hard_params(rng))
        else:
            albedo = rng.uniform(0.1, 0.9, 3)
            radius = rng.uniform(0.35, 0.65)
            light = rng.uniform(0.2, 0.9, 3)
            sky = rng.uniform(0.4, 1.0, 3)
            img, depth, _ = render_scene(
                H, W, focal, look_at(pos),
                ((np.zeros(3), radius, albedo),), light=tuple(light),
                sky_tint=tuple(sky))
        imgs[k] = img[yy]                 # vertical stretch H → res
        d = np.nan_to_num(np.asarray(depth, np.float32),
                          posinf=6.0).clip(0.1, 6.0)
        nm = ((depth2normal_geo(depth2xyz(torch.from_numpy(d), K)) + 1.0)
              / 2.0).numpy()
        nrms[k] = nm[yy]
    return imgs, nrms


def make_domain_masks(n: int, res: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed + 1)
    return np.stack([random_mask(rng, res, res, ratio=(0.15, 0.6))
                     for _ in range(n)])


def vae_loss(vae, batch: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
    """Phase A's loss on a batch [B, S, S, 3] in [-1, 1]; eps: the
    posterior draw [B, S/8, S/8, 4]."""
    z = vae.encode(batch, eps)
    recon = vae.decode(z)
    var = torch.mean(z ** 2)
    return (torch.mean((recon - batch) ** 2) + 0.1 * (var - 1.0) ** 2
            + 1e-3 * torch.mean(torch.mean(z, dim=(1, 2)) ** 2))


def unet_draws(rng, batch: int, lr_res: int, device
               ) -> Dict[str, torch.Tensor]:
    """The LoRA step's draws (t, ε, the image's and the masked image's
    posterior ε) and the conditioning slot of each image in its modality's
    triple, in that order; a JaxKey splits in five as the JAX tool's
    ``unet_loss``."""
    k_t, k_n, k_e1, k_e2, k_c = jr.split(rng, 5)
    shape = (batch, lr_res, lr_res, 4)
    return {"t": jr.randint_(k_t, 0, 1000, (batch,), device),
            "noise": jr.draw("randn", shape, k_n, device=device),
            "enc_eps": jr.draw("randn", shape, k_e1, device=device),
            "enc_masked_eps": jr.draw("randn", shape, k_e2, device=device),
            "cond": jr.randint_(k_c, 0, 3, (batch,), device)}


def unet_loss(unet, vae, sched, embeds6: torch.Tensor, batch_img, batch_mask,
              batch_idx, n_domain: int, draws) -> torch.Tensor:
    """Phase B's loss: images [B, S, S, 3] in [-1, 1], masks [B, S, S],
    their pool indices (≥ n_domain: a normal map, conditioned on the
    normal triple), draws as ``unet_draws``."""
    B, lr_res = batch_img.shape[0], batch_img.shape[1] // 8
    with torch.no_grad():
        latents = vae.encode(batch_img, draws["enc_eps"])
        mlat = vae.encode(batch_img * (batch_mask[..., None] < 0.5),
                          draws["enc_masked_eps"])
    mask_l = _resize(batch_mask[..., None], lr_res, method="nearest")
    t, noise = draws["t"], draws["noise"]
    noisy = sched.add_noise(latents, noise, t)
    ei = 3 * (batch_idx >= n_domain).long() + draws["cond"]
    pred = unet(torch.cat([noisy, mask_l, mlat], dim=-1), t, embeds6[ei])
    return torch.mean((pred - noise) ** 2)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out", help="output ckpt path (.msgpack)")
    ap.add_argument("--res", type=int, default=128)
    ap.add_argument("--n_domain", type=int, default=384)
    ap.add_argument("--steps_vae", type=int, default=1500)
    ap.add_argument("--steps_unet", type=int, default=4000)
    ap.add_argument("--batch", type=int, default=None,
                    help="default scales with --res to a constant pixel "
                         "footprint: 16 up to 256², 4 at 512²")
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--chunk", type=int, default=50,
                    help="logging interval (steps)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--family", choices=("spheres", "hard"),
                    default="spheres",
                    help="procedural domain family (must match the ablation "
                         "scene's --family)")
    ap.add_argument("--prompt", default="a photo of a sphere")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--draws", default="torch", choices=("torch", "jax"),
                    help="torch (default) or the JAX tool's draws for "
                         "--seed")
    args = ap.parse_args(argv)
    if args.batch is None:
        # constant pixel footprint: 16·256² pixels a batch
        args.batch = (max(4, int(16 * (256 / max(args.res, 1)) ** 2))
                      if args.res > 256 else 16)
        print(f"[prior] batch={args.batch} (auto for res {args.res})")
    return args


def main(argv=None):
    args = parse_args(argv)

    from ..config import GuidanceConfig
    from ..guidance.stable import build_sd_modules
    from ..guidance.text import CLIPTextConfig
    from ..guidance.unet import UNetConfig
    from ..guidance.vae import VAEConfig
    from ..guidance.weights import save_prior_ckpt
    from ..train.loop import device_from_flag

    device = device_from_flag(args.device)
    jax_draws = args.draws == "jax"
    gcfg = GuidanceConfig(prompt=args.prompt, prompt_normal=args.prompt)
    mods = build_sd_modules(
        gcfg, jr.PRNGKey(args.seed) if jax_draws else
        torch.Generator(device=device).manual_seed(args.seed),
        unet_config=UNetConfig.tiny(), vae_config=VAEConfig.tiny(),
        text_config=CLIPTextConfig(vocab_size=49408, width=32, layers=2,
                                   heads=2),
        latent_size=args.res, dtype=torch.float32, device=device)
    sched, unet, vae = mods.schedule, mods.unet, mods.vae
    lr_res = args.res // 8

    fam_tag = "" if args.family == "spheres" else f"_{args.family}"
    cache = (args.out + f".domain_r{args.res}_n{args.n_domain}"
             f"_s{args.seed}{fam_tag}.npz")
    if os.path.exists(cache):
        z = np.load(cache)
        rgb_np, nrm_np = z["rgb"], z["nrm"]
        if len(rgb_np) != args.n_domain or rgb_np.shape[1] != args.res:
            raise SystemExit(f"stale domain cache {cache}: {rgb_np.shape}")
        print(f"[prior] loaded {len(rgb_np)} cached domain images ({cache})",
              flush=True)
    else:
        print(f"[prior] generating {args.n_domain} domain images at "
              f"{args.res}² ...", flush=True)
        t0 = time.perf_counter()
        rgb_np, nrm_np = make_domain_images(args.n_domain, args.res,
                                            args.seed, family=args.family)
        np.savez(cache, rgb=rgb_np, nrm=nrm_np)
        print(f"[prior] domain images in {time.perf_counter() - t0:.3f} s",
              flush=True)
    # the pool [2n]: the first n RGB, the last n normal maps
    imgs = torch.as_tensor(np.concatenate([rgb_np, nrm_np]) * 2.0 - 1.0,
                           device=device)
    n_pool = 2 * args.n_domain
    masks = torch.as_tensor(make_domain_masks(args.n_domain, args.res,
                                              args.seed), device=device)
    embeds6 = torch.cat([mods.embeds_rgb, mods.embeds_normal])   # [6,L,D]
    if jax_draws:
        rng = jr.PRNGKey(args.seed + 10)
        whole = lambda n: -(-n // args.chunk) * args.chunk      # noqa: E731
        steps_vae, steps_unet = whole(args.steps_vae), whole(args.steps_unet)
    else:
        rng = torch.Generator(device=device).manual_seed(args.seed + 10)
        steps_vae, steps_unet = args.steps_vae, args.steps_unet

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def vae_batch_loss(k_b, k_l):
        return vae_loss(
            vae, imgs[jr.randint_(k_b, 0, n_pool, (args.batch,), device)],
            jr.draw("randn", (args.batch, lr_res, lr_res, 4), k_l,
                    device=device))

    def unet_batch_loss(k_b, k_m, k_l):
        idx = jr.randint_(k_b, 0, n_pool, (args.batch,), device)
        midx = jr.randint_(k_m, 0, args.n_domain, (args.batch,), device)
        return unet_loss(unet, vae, sched, embeds6, imgs[idx], masks[midx],
                         idx, args.n_domain,
                         unet_draws(k_l, args.batch, lr_res, device))

    # ---- phase A: the VAE as an autoencoder ----
    vae.requires_grad_(True)
    opt = torch.optim.Adam(vae.parameters(), lr=args.lr, eps=1e-8)
    t0 = t_phase = time.perf_counter()
    for i in range(1, steps_vae + 1):
        rng, k_b, k_l = jr.split(rng, 3)
        opt.zero_grad(set_to_none=True)
        loss = vae_batch_loss(k_b, k_l)
        loss.backward()
        opt.step()
        if jax_draws and i % args.chunk == 0:
            # the JAX tool logs a fresh batch from the chain's key
            with torch.no_grad():
                loss = vae_batch_loss(*jr.split(rng))
        if i % args.chunk == 0 or i == steps_vae:
            print(f"[vae {i}/{steps_vae}] loss={loss.item():.4f} "
                  f"({args.chunk / (time.perf_counter() - t0):.0f} it/s)",
                  flush=True)
            t0 = time.perf_counter()
    sync()
    print(f"[prior] phase A: {steps_vae} VAE steps in "
          f"{time.perf_counter() - t_phase:.3f} s", flush=True)
    vae.requires_grad_(False)

    # ---- phase B: the UNet as an inpainting denoiser ----
    unet.requires_grad_(True)
    opt = torch.optim.Adam(unet.parameters(), lr=args.lr * 0.5, eps=1e-8)
    t0 = t_phase = time.perf_counter()
    for i in range(1, steps_unet + 1):
        rng, k_b, k_m, k_l = jr.split(rng, 4)
        opt.zero_grad(set_to_none=True)
        loss = unet_batch_loss(k_b, k_m, k_l)
        loss.backward()
        opt.step()
        if jax_draws and i % args.chunk == 0:
            with torch.no_grad():
                loss = unet_batch_loss(*jr.split(rng, 3))
        if i % args.chunk == 0 or i == steps_unet:
            print(f"[unet {i}/{steps_unet}] loss={loss.item():.4f} "
                  f"({args.chunk / (time.perf_counter() - t0):.0f} it/s)",
                  flush=True)
            t0 = time.perf_counter()
    sync()
    print(f"[prior] phase B: {steps_unet} UNet steps in "
          f"{time.perf_counter() - t_phase:.3f} s", flush=True)
    unet.requires_grad_(False)

    save_prior_ckpt(args.out, mods)
    print(f"[prior] saved {args.out}")


if __name__ == "__main__":
    main()
