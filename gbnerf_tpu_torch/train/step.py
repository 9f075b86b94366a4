"""Render functions and the stage-1 and stage-2 train steps.

Port of gbnerf_tpu/train/step.py: ``make_render_fn`` (with its NDC and
non-NDC branches and the frozen-σ field, ``alpha=``),
``make_image_renderer``, ``_full_view_rays``, ``_sigma_depth_loss``,
``make_train_step_stage1``, and stage 2: ``Stage2Batch``,
``select_stage2_view``, ``_masked_rays`` and ``make_train_step_stage2``
with the LPIPS patch loss (``lpips_fn``), ``gradient_clip`` (pwclip) and
the collaborative neighbour views; both steps over a data mesh (``mesh=``,
parallel/mesh.py): every rank draws the whole batch, renders its rows and
gathers the per-ray maps, so that the losses are computed whole on every
rank, and the gradients are averaged before Adam.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional

import torch

from ..config import Config
from ..core.normals import depth2normal_geo, depth2xyz
from ..core.fields import make_field_fn, make_frozen_sigma_field_fn
from ..core.rays import ndc_rays
from ..core.render import RenderOutputs, render_rays, render_rays_blocked
from ..data.rays_bank import sample_batch
from ..guidance.stable import _resize
from ..parallel.mesh import (DeviceMesh, average_grads, data_sharding,
                             gather, global_rows)
from ..utils import jax_random as jr
from ..utils.metrics import img2mse, mse2psnr, weighted_mse
from .losses import (cp_tv_loss, draw_patch_idx, extract_patches, pwclip,
                     sigma_loss)
from .state import TrainState, adam_step, lr_schedule


def make_render_fn(cfg: Config, coarse_model, fine_model, near: float,
                   far: float, hwf=None, alpha=None):
    """Build render(rays_o, rays_d, generator=None, *, train) → RenderOutputs.

    near/far are scene constants. With no_ndc=False the rays are mapped
    through ndc_rays (near plane 1) and marched over [0, 1], with viewdirs
    from the world-space directions; that needs hwf = (H, W, focal).
    At eval (train=False) the coarse pass is σ-only, with no jitter or noise.
    alpha: a frozen pretrained field (``train.loop.load_alpha_model``) that
    supplies σ to both passes; the coarse and fine fields then give only
    the colour (``make_frozen_sigma_field_fn``).
    """
    r = cfg.render
    use_ndc = not r.no_ndc
    if use_ndc:
        if hwf is None:
            raise ValueError("no_ndc=False needs hwf=(H, W, focal) — the "
                             "NDC frustum is shaped by the intrinsics")
        ndc_H, ndc_W, ndc_focal = int(hwf[0]), int(hwf[1]), float(hwf[2])
        near, far = 0.0, 1.0
    coarse_fn = make_field_fn(coarse_model)
    fine_fn = make_field_fn(fine_model) if fine_model is not None else None
    if alpha is not None:
        alpha_fn = make_field_fn(alpha)
        coarse_fn = make_frozen_sigma_field_fn(coarse_fn, alpha_fn)
        if fine_fn is not None:
            fine_fn = make_frozen_sigma_field_fn(fine_fn, alpha_fn)

    def render(rays_o: torch.Tensor, rays_d: torch.Tensor,
               generator: Optional[torch.Generator] = None, *,
               train: bool) -> RenderOutputs:
        viewdirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
        if use_ndc:
            rays_o, rays_d = ndc_rays(ndc_H, ndc_W, ndc_focal, 1.0,
                                      rays_o, rays_d)
        shape = rays_o.shape[:-1] + (1,)
        n = torch.full(shape, near, dtype=rays_o.dtype, device=rays_o.device)
        f = torch.full(shape, far, dtype=rays_o.dtype, device=rays_o.device)
        return render_rays(
            coarse_fn, fine_fn, rays_o, rays_d, viewdirs, n, f,
            N_samples=r.N_samples, N_importance=r.N_importance,
            lindisp=r.lindisp, perturb=train and r.perturb > 0.0,
            raw_noise_std=r.raw_noise_std if train else 0.0,
            white_bkgd=r.white_bkgd, generator=generator,
            coarse_sigma_only=not train)

    return render


# the per-ray maps a sharded render gathers back (the losses, the normal
# map and the colla views read no per-sample output)
_GATHERED = ("rgb", "disp", "acc", "depth", "rgb0", "disp0", "acc0",
             "depth0")


def _check_mesh(mesh) -> None:
    if mesh is not None and not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be a torch DeviceMesh "
                        f"(parallel/mesh.py::make_mesh), got {type(mesh)}")


def shard_render(render, mesh: Optional[DeviceMesh], axis="data"):
    """``render`` over this rank's rows of each ray batch, with the draws
    of the whole batch (``global_rows``), and the per-ray maps of
    ``_GATHERED`` gathered back: every rank gets the maps one process
    computes (the per-sample weights, z_vals and alpha are None). The
    render itself without a mesh."""
    if mesh is None:
        return render

    def sharded(rays_o: torch.Tensor, rays_d: torch.Tensor,
                generator: Optional[torch.Generator] = None, *,
                train: bool) -> RenderOutputs:
        shard = data_sharding(mesh, rays_o.shape[0], axis)
        with global_rows(shard):
            out = render(shard.take(rays_o), shard.take(rays_d), generator,
                         train=train)
        keys = [k for k in _GATHERED if getattr(out, k) is not None]
        cols = [getattr(out, k).reshape(shard.rows, -1) for k in keys]
        full = gather(torch.cat(cols, dim=1), mesh, axis, n=shard.n)
        parts = torch.split(full, [c.shape[1] for c in cols], dim=1)
        maps = {k: (p if c.shape[1] > 1 else p[:, 0]).to(c.dtype)
                for k, p, c in zip(keys, parts, cols)}
        return RenderOutputs(weights=None, z_vals=None, alpha=None, **maps)

    return sharded


def make_image_renderer(render_fn, *, block: int = 8192):
    """Full-image renderer: (rays_o [H,W,3], rays_d) → {rgb, disp, depth,
    acc} maps [H, W, ...], rendered block by block without gradients."""

    @torch.no_grad()
    def render(rays_o: torch.Tensor, rays_d: torch.Tensor):
        H, W = rays_o.shape[:2]

        def block_fn(rays):
            out = render_fn(rays["o"], rays["d"], None, train=False)
            return {"rgb": out.rgb, "disp": out.disp, "depth": out.depth,
                    "acc": out.acc}

        flat = {"o": rays_o.reshape(-1, 3), "d": rays_d.reshape(-1, 3)}
        out = render_rays_blocked(block_fn, flat, block_size=block)
        return {k: v.reshape((H, W) + v.shape[1:]) for k, v in out.items()}

    return render


def _full_view_rays(H: int, W: int, focal: float, pose: torch.Tensor):
    """All H×W rays of one camera pose [3, 4]+ → rays_o, rays_d [H, W, 3]."""
    dev = pose.device
    j = torch.arange(H, dtype=torch.float32, device=dev)[:, None]
    i = torch.arange(W, dtype=torch.float32, device=dev)[None, :]
    x = (i - W * 0.5) / focal
    y = -(j - H * 0.5) / focal
    dirs = torch.stack([x.expand(H, W), y.expand(H, W),
                        -torch.ones((H, W), device=dev)], dim=-1)
    rays_d = torch.sum(dirs[..., None, :] * pose[:3, :3], dim=-1)
    rays_o = pose[:3, -1].expand(rays_d.shape)
    return rays_o, rays_d


def _sigma_depth_loss(cfg: Config, coarse_model, fine_model, dep, near,
                      generator: Optional[torch.Generator] = None,
                      alpha=None, mesh: Optional[DeviceMesh] = None,
                      axis="data") -> torch.Tensor:
    """DS-NeRF σ-likelihood on COLMAP-depth rays, on the fine field (the
    reference's SigmaLoss, built at run.py:2122-2124 on the fine network).

    Divergence kept from the JAX package: the reference computes this term
    but its shipped loop never adds it to the loss; here it is added with
    weight sigma_loss_weight. The loss reads only σ, so the field is called
    σ-only (K2 forward and K5 backward on the card): σ and its gradients
    are those of the full call, bit for bit, without the colour head. With
    a frozen alpha field, σ is the alpha field's and the term carries no
    gradient, as in the JAX package. With a mesh each rank scores its rows
    (the draws of the whole batch) and the per-ray terms are gathered.
    """
    r = cfg.render
    fn = make_field_fn(fine_model if fine_model is not None else coarse_model)
    if alpha is not None:
        fn = make_frozen_sigma_field_fn(fn, make_field_fn(alpha))
    shard = data_sharding(mesh, dep["o"].shape[0], axis)
    o, d = shard.take(dep["o"]), shard.take(dep["d"])
    viewdirs = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    with global_rows(shard):
        per_ray = sigma_loss(lambda pts, vd: fn(pts, vd, sigma_only=True),
                             o, d, viewdirs, near,
                             shard.take(dep["target"][:, 0]),
                             N_samples=r.N_samples, perturb=r.perturb > 0.0,
                             raw_noise_std=r.raw_noise_std,
                             generator=generator)
    return torch.mean(gather(per_ray, mesh, axis, n=shard.n))


def make_train_step_stage1(cfg: Config, coarse_model, fine_model,
                           near: float, far: float, alpha=None, mesh=None,
                           mesh_axis="data", hwf=None):
    """DS-NeRF batched training step (the reference's first_stage path).

    step(state, banks, generator=None, idx=None) → (state, metrics):
    samples N_rand rays from each stream (``idx`` may inject the draws, a
    dict keyed like ``batches``), computes the loss, backpropagates (K4 on
    the card), takes one Adam step at lr_schedule(state.step) and updates
    ``state`` in place. ``step.loss_fn(batches, generator=None)`` →
    (loss, metrics) is exposed for the loss tests, as in the JAX package.
    hwf: training intrinsics, required only for the NDC path. alpha: a
    frozen field that supplies σ (``make_render_fn``).
    mesh: a DeviceMesh (parallel/mesh.py): the ray batches are split over
    ``mesh_axis`` (``shard_render``), the parameters stay replicated and
    the gradients are averaged over the ranks before Adam; the same step
    runs in one process or N.
    """
    _check_mesh(mesh)
    render = shard_render(make_render_fn(cfg, coarse_model, fine_model, near,
                                         far, hwf=hwf, alpha=alpha),
                          mesh, mesh_axis)
    schedule = lr_schedule(cfg)
    t, d = cfg.train, cfg.data
    fields = [m for m in (coarse_model, fine_model) if m is not None]
    params = [p for f in fields for p in f.parameters()]

    def loss_fn(batches: Dict[str, Optional[Dict[str, torch.Tensor]]],
                generator: Optional[torch.Generator] = None):
        k1, k2, k3 = jr.split(generator, 3)
        clf = batches["clf"]
        out = render(clf["o"], clf["d"], k1, train=True)
        img_loss = img2mse(out.rgb, clf["target"])
        loss = img_loss
        if out.rgb0 is not None:
            loss = loss + img2mse(out.rgb0, clf["target"])

        # Divergences kept from the JAX package (train/step.py there): the
        # inpainted-depth stream is rendered and scored against its own
        # targets, the coarse rgb0 term is added, and the COLMAP weighted
        # depth and σ terms are wired into the loss.
        zero = torch.zeros((), device=clf["o"].device)
        inp = batches.get("inp")
        depth_loss = zero
        if inp is not None:
            out_i = render(inp["o"], inp["d"], k2, train=True)
            depth_loss = img2mse(out_i.disp, inp["target"][:, 0])
            loss = loss + d.depth_lambda * depth_loss

        dep = batches.get("depth")
        sig_loss = col_loss = zero
        if dep is not None:
            out_d = render(dep["o"], dep["d"], k3, train=True)
            col_loss = weighted_mse(out_d.depth, dep["target"][:, 0],
                                    dep["target"][:, 1])
            loss = loss + d.sdepth_lambda * col_loss
            if t.sigma_loss_weight > 0:
                sig_loss = _sigma_depth_loss(cfg, coarse_model, fine_model,
                                             dep, near, jr.fold_in(k3, 1),
                                             alpha, mesh, mesh_axis)
                loss = loss + t.sigma_loss_weight * sig_loss

        if t.tv_loss_weight > 0:
            loss = loss + t.tv_loss_weight * cp_tv_loss(fields)

        return loss, {"img_loss": img_loss, "depth_loss": depth_loss,
                      "col_loss": col_loss, "sigma_loss": sig_loss,
                      "psnr": mse2psnr(img_loss)}

    def step(state: TrainState, banks, generator=None, idx=None):
        idx = idx or {}
        k_batch, k_loss = jr.split(generator)
        ks = jr.split(k_batch, 3)
        batches = {
            "clf": sample_batch(banks["rgb_clf"], t.N_rand, ks[0],
                                idx.get("clf")),
            "inp": sample_batch(banks["inp"], t.N_rand, ks[1],
                                idx.get("inp")),
            "depth": (sample_batch(banks["depth"], t.N_rand, ks[2],
                                   idx.get("depth"))
                      if banks.get("depth") is not None else None),
        }
        state.optimizer.zero_grad(set_to_none=True)
        loss, metrics = loss_fn(batches, k_loss)
        loss.backward()
        average_grads(params, mesh)
        adam_step(state, schedule)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["loss"] = loss.detach()
        return state, metrics

    step.loss_fn = loss_fn
    return step


class Stage2Batch(NamedTuple):
    """The device inputs of one stage-2 iteration (static shapes)."""

    image: torch.Tensor       # [H, W, 3] GT (inpainted) image of the view
    mask: torch.Tensor        # [H, W]
    coords: torch.Tensor      # [K_max, 2] (x, y) masked pixels, padded
    valid: torch.Tensor       # [K_max] bool
    pose: torch.Tensor        # [3, 4] c2w of the view
    clf: Dict[str, torch.Tensor]    # unmasked rays {o, d, target[3]}
    inp: Dict[str, torch.Tensor]    # inpainted-disparity rays {o, d, target[1]}
    depth: Optional[Dict[str, torch.Tensor]]  # COLMAP {o, d, target[depth, w]}
    # cached [1, LR, LR, 4] VAE encoding of the view's masked conditioning
    # image (guidance/stable.py::precompute_masked_latents)
    masked_latents: Optional[torch.Tensor] = None
    colla_poses: Optional[torch.Tensor] = None  # [K, 3, 4] neighbour views
    colla_masks: Optional[torch.Tensor] = None  # [K, H, W]


def select_stage2_view(scene_dev: Dict[str, torch.Tensor], banks_dev,
                       n_rand: int,
                       generator: Optional[torch.Generator] = None, *,
                       img_i=None, idx=None, n_colla: int = 0) -> Stage2Batch:
    """A random view and N_rand rays of each stream, on the device; with
    n_colla, that many random views' poses and masks for the collaborative
    guidance. The view index (``img_i``), the stream draws (``idx``:
    {"clf", "inp", "depth"} → [n_rand] indices) and the collaborative
    views (``idx["colla"]`` → [n_colla] indices) may be injected;
    otherwise they come from ``generator`` (a JaxKey splits in five as the
    JAX package's: view, clf, inp, depth, colla views)."""
    idx = idx or {}
    images = scene_dev["images"]
    k_img, k_clf, k_inp, k_dep, k_col = jr.split(generator, 5)
    if img_i is None:
        img_i = jr.randint_(k_img, 0, images.shape[0], (1,), images.device)
    else:
        img_i = torch.as_tensor(img_i, device=images.device).reshape(1)

    def take(name):
        return scene_dev[name].index_select(0, img_i)[0]

    ml = scene_dev.get("masked_latents")
    depth = banks_dev.get("depth")
    batch = Stage2Batch(
        image=take("images"), mask=take("masks"), coords=take("mask_coords"),
        valid=take("mask_valid"), pose=take("poses")[:3, :4],
        clf=sample_batch(banks_dev["rgb_clf"], n_rand, k_clf,
                         idx.get("clf")),
        inp=sample_batch(banks_dev["inp"], n_rand, k_inp, idx.get("inp")),
        depth=(sample_batch(depth, n_rand, k_dep, idx.get("depth"))
               if depth is not None else None),
        masked_latents=ml.index_select(0, img_i) if ml is not None else None)
    if not n_colla:
        return batch
    ci = idx.get("colla")
    if ci is None:
        ci = jr.randint_(k_col, 0, images.shape[0], (n_colla,),
                         images.device)
    ci = torch.as_tensor(ci, device=images.device)
    return batch._replace(
        colla_poses=scene_dev["poses"].index_select(0, ci)[:, :3, :4],
        colla_masks=scene_dev["masks"].index_select(0, ci))


def _masked_rays(H: int, W: int, focal: float, pose: torch.Tensor,
                 coords: torch.Tensor):
    """Rays through the (padded) masked pixel coords [K, 2] of one view."""
    x = (coords[:, 0].float() - W * 0.5) / focal
    y = -(coords[:, 1].float() - H * 0.5) / focal
    dirs = torch.stack([x, y, -torch.ones_like(x)], dim=-1)
    rays_d = torch.sum(dirs[..., None, :] * pose[:3, :3], dim=-1)
    rays_o = pose[:3, -1].expand(rays_d.shape)
    return rays_o, rays_d


def _composite(image: torch.Tensor, coords: torch.Tensor,
               valid: torch.Tensor, rgb: torch.Tensor) -> torch.Tensor:
    """The GT view with the valid masked pixels replaced by the render, by
    a scatter (differentiable in rgb). The padded entries are sent to one
    extra slot past the image, so that they never collide with a real
    pixel (the JAX package writes them back onto pixel (0, 0))."""
    H, W, C = image.shape
    flat = coords[:, 1].long() * W + coords[:, 0].long()
    flat = torch.where(valid, flat, torch.full_like(flat, H * W))
    vals = torch.where(valid[:, None], rgb, torch.zeros_like(rgb))
    out = torch.cat([image.reshape(H * W, C), image.new_zeros((1, C))])
    return out.index_put((flat,), vals)[:H * W].reshape(H, W, C)


# guidance_fn(step, combin_rgb [H,W,3], normal_map [h,w,3] | None,
#             mask [H,W], generator, *, masked_latents, draws[, rgbs4,
#             masks4]) → scalar
GuidanceFn = Callable[..., torch.Tensor]


def _colla_views(render, batch: Stage2Batch, H_r: int, W_r: int,
                 focal_r: float) -> Dict[str, torch.Tensor]:
    """The collaborative guidance's neighbour views (the reference's
    render_path_4view): each of batch.colla_poses rendered at H_r × W_r as
    at eval (train=False: the σ-only coarse pass, no jitter or noise) but
    with gradient, all K views' rays in one render call; their masks
    resized nearest (jax.image.resize's, nearest-exact). The σ-only coarse
    pass only places the fine samples (its weights are detached), so the
    gradient reaches the fields through the fine pass alone (K1 forward,
    K4 backward on the card). → {"rgbs4": [K, H_r, W_r, 3], "masks4":
    [K, H_r, W_r]}."""
    K = batch.colla_poses.shape[0]
    rays = [_full_view_rays(H_r, W_r, focal_r, p) for p in batch.colla_poses]
    ro = torch.stack([o for o, _ in rays]).reshape(-1, 3)
    rd = torch.stack([d for _, d in rays]).reshape(-1, 3)
    rgbs4 = render(ro, rd, None, train=False).rgb.reshape(K, H_r, W_r, 3)
    masks4 = _resize(batch.colla_masks[..., None], (H_r, W_r),
                     method="nearest")[..., 0]
    return {"rgbs4": rgbs4, "masks4": masks4}


def make_train_step_stage2(cfg: Config, coarse_model, fine_model,
                           near: float, far: float, hwf, *,
                           guidance_fn: Optional[GuidanceFn] = None,
                           lpips_fn=None, alpha=None, mesh=None,
                           mesh_axis="data"):
    """Masked-inpainting training step (the reference's second stage).

    step(state, scene_dev, banks, generator=None, idx=None, draws=None) →
    (state, metrics): a random view (``idx["img"]`` may inject it, and
    ``idx["clf"|"inp"|"depth"]`` the stream draws), the unmasked RGB,
    inpainted-disparity and COLMAP-depth terms; with ``guidance_fn``, or
    with ``lpips_fn`` and train.lpips, the masked rays rendered (through
    pwclip with gradient_clip) and composited into the GT view; with
    ``guidance_fn`` the normal map of a 1/normalmap_render_factor full
    view from the rendered depth and the score-distillation term at
    weight sds_loss_weight; with ``lpips_fn`` (a [B,h,w,3]×2 → [B]
    distance, utils/lpips.py) the perceptual distance of n_patches
    patches cut at the same masked positions from the composite and the
    GT view, at weight lpips_weight; with ``guidance_fn`` and
    is_colla_guidance, four random views (``idx["colla"]`` may inject them)
    rendered at 1/normalmap_render_factor as at eval (σ-only coarse pass,
    no jitter), with gradient, for the collaborative term; one backward and
    one Adam step at lr_schedule(state.step).
    ``step.loss_fn(batch, step_i, generator=None, draws=None)`` → (loss,
    metrics) is exposed for the loss tests; ``draws`` goes to guidance_fn,
    and ``draws["patches"]`` [n_patches] may inject the patch positions
    (``extract_patches``'s idx).
    hwf: (H, W, focal) of the training views. alpha: a frozen field that
    supplies σ (``make_render_fn``).
    mesh: a DeviceMesh (parallel/mesh.py). Every render's rays (the
    streams, the masked pixels' coords and valid flags, the normal map's
    and the colla views' rays) are split over ``mesh_axis`` and their maps
    gathered (``shard_render``): the composite, the normal map, the
    guidance and LPIPS terms are computed whole on every rank with the
    same draws, as the JAX package keeps the guidance images replicated;
    the gradients are averaged over the ranks before Adam. A (data, model)
    mesh also carries the SD towers' tensor parallelism
    (parallel/tp.py), which ``guidance_fn``'s modules hold.

    Divergence kept from the JAX package: the reference's shipped stage-2
    loop never calls backward; here the full loss is differentiated.
    """
    _check_mesh(mesh)
    t, d, g = cfg.train, cfg.data, cfg.guidance
    n_colla = 4 if (g.is_colla_guidance and guidance_fn is not None) else 0
    render = shard_render(make_render_fn(cfg, coarse_model, fine_model, near,
                                         far, hwf=hwf, alpha=alpha),
                          mesh, mesh_axis)
    schedule = lr_schedule(cfg)
    fields = [m for m in (coarse_model, fine_model) if m is not None]
    params = [p for f in fields for p in f.parameters()]
    H, W, focal = int(hwf[0]), int(hwf[1]), float(hwf[2])
    nrf = g.normalmap_render_factor
    H_r, W_r, focal_r = H // nrf, W // nrf, focal / nrf
    K_r = [[focal_r, 0.0, W_r / 2], [0.0, focal_r, H_r / 2], [0.0, 0.0, 1.0]]

    def loss_fn(batch: Stage2Batch, step_i: int,
                generator: Optional[torch.Generator] = None, draws=None):
        dev = batch.image.device
        zero = torch.zeros((), device=dev)
        k_m, k_c, k_i, k_d, k_n, k_g = jr.split(generator, 6)
        out2 = render(batch.clf["o"], batch.clf["d"], k_c, train=True)
        img_loss = img2mse(out2.rgb, batch.clf["target"])
        loss = img_loss
        if out2.rgb0 is not None:
            loss = loss + img2mse(out2.rgb0, batch.clf["target"])

        out_i = render(batch.inp["o"], batch.inp["d"], k_i, train=True)
        depth_loss = img2mse(out_i.disp, batch.inp["target"][:, 0])
        loss = loss + d.depth_lambda * depth_loss

        # Divergence kept from the JAX package: the reference's stage 2
        # samples only the clf and inp streams; the COLMAP depth term stays
        # live here (colmap_depth=False for the reference's behaviour).
        sig_loss = zero
        if batch.depth is not None and d.colmap_depth:
            dep = batch.depth
            out_d = render(dep["o"], dep["d"], k_d, train=True)
            loss = loss + d.sdepth_lambda * weighted_mse(
                out_d.depth, dep["target"][:, 0], dep["target"][:, 1])
            if t.sigma_loss_weight > 0:
                sig_loss = _sigma_depth_loss(cfg, coarse_model, fine_model,
                                             dep, near, jr.fold_in(k_d, 1),
                                             alpha, mesh, mesh_axis)
                loss = loss + t.sigma_loss_weight * sig_loss

        sds_loss = lpips_loss = zero
        use_lpips = lpips_fn is not None and t.lpips
        if guidance_fn is not None or use_lpips:
            # render the masked pixels and composite them into the GT view
            ro, rd = _masked_rays(H, W, focal, batch.pose, batch.coords)
            out_m = render(ro, rd, k_m, train=True)
            rgb_m = pwclip(out_m.rgb) if t.gradient_clip else out_m.rgb
            combin = _composite(batch.image, batch.coords, batch.valid, rgb_m)
            normal_map = None
            if g.is_normal_guidance and guidance_fn is not None:
                ro_n, rd_n = _full_view_rays(H_r, W_r, focal_r, batch.pose)
                out_n = render(ro_n.reshape(-1, 3), rd_n.reshape(-1, 3),
                               k_n, train=True)
                depth_n = out_n.depth.reshape(H_r, W_r)
                pts = depth2xyz(depth_n, torch.tensor(K_r, device=dev))
                normal_map = (depth2normal_geo(pts) + 1.0) / 2.0
                if t.gradient_clip:
                    normal_map = pwclip(normal_map)
            if use_lpips:
                # masked-region perceptual patches: the composite against
                # the GT view, cut at the same positions
                pidx = (draws or {}).get("patches")
                if pidx is None:
                    pidx = draw_patch_idx(batch.mask, t.n_patches,
                                          jr.fold_in(k_g, 7))
                pr = extract_patches(combin, batch.mask, t.patch_len,
                                     t.n_patches, idx=pidx)
                pg = extract_patches(batch.image, batch.mask, t.patch_len,
                                     t.n_patches, idx=pidx)
                lpips_loss = torch.mean(lpips_fn(pr, pg))
                loss = loss + t.lpips_weight * lpips_loss
            if guidance_fn is not None:
                kw = {}
                if n_colla and batch.colla_poses is not None:
                    kw = _colla_views(render, batch, H_r, W_r, focal_r)
                sds_loss = guidance_fn(step_i, combin, normal_map,
                                       batch.mask, k_g,
                                       masked_latents=batch.masked_latents,
                                       draws=draws, **kw)
                loss = loss + g.sds_loss_weight * sds_loss

        if t.tv_loss_weight > 0:
            loss = loss + t.tv_loss_weight * cp_tv_loss(fields)

        return loss, {"img_loss": img_loss, "depth_loss": depth_loss,
                      "sds_loss": sds_loss, "sigma_loss": sig_loss,
                      "lpips_loss": lpips_loss, "psnr": mse2psnr(img_loss)}

    def step(state: TrainState, scene_dev, banks, generator=None, idx=None,
             draws=None):
        idx = idx or {}
        k_sel, k_loss = jr.split(generator)
        batch = select_stage2_view(scene_dev, banks, t.N_rand, k_sel,
                                   img_i=idx.get("img"), idx=idx,
                                   n_colla=n_colla)
        state.optimizer.zero_grad(set_to_none=True)
        loss, metrics = loss_fn(batch, state.step, k_loss, draws)
        loss.backward()
        average_grads(params, mesh)
        adam_step(state, schedule)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["loss"] = loss.detach()
        return state, metrics

    step.loss_fn = loss_fn
    return step
