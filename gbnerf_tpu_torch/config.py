"""Typed configuration for training and rendering: the port's own copy.

A copy of gbnerf_tpu/config.py (which imports only ``dataclasses``, ``os``
and ``typing``), kept here so that the port imports nothing of the JAX
package. It has the same dataclasses, field names and defaults, the same
``load_reference_config`` key mapping and the same ``save_config`` format,
so a config file loads identically in both packages
(tests/test_torch_config.py holds the two against each other). A knob
that only the JAX package reads (``steps_per_dispatch``) is kept for that
parity; ``mesh`` and ``guidance.tp`` shape the port's torchrun mesh
(train/loop.py::build_mesh); ``field.compute_dtype`` is
read by the MLP and hash fields (the CP field's kernels fix their own).

It replaces the reference's ConfigArgParse flat namespace of ~140 flags
(the reference's run.py:253-568). Every knob that affects the live code
path (SURVEY.md §2.1) exists here under the same name, so a reference
config file like DS_NeRF/config/aconfig_1.txt loads directly via
``load_reference_config``. Structure: nested frozen dataclasses, grouped by
subsystem instead of one flat namespace.
"""
from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, field as dc_field
from typing import Optional, Tuple


@dataclass(frozen=True)
class FieldConfig:
    """Radiance-field architecture (reference: netdepth/netwidth/multires...)."""
    no_tcnn: bool = False          # True → classic PE MLP (reference --no_tcnn)
    # grid field flavor when no_tcnn=False: "cp" = TPU-native CP-factorized
    # grid (two-hot-matmul interp, fast on TPU); "hash" = strict tcnn
    # HashGrid topology (slow on TPU: gather-bound; parity option).
    field_type: str = "cp"
    cp_resolutions: Tuple[int, ...] = (17, 33, 65, 129, 257)
    cp_rank: int = 16
    # Proposal-style coarse field (mip-NeRF-360 proposal-MLP idea, TPU-cast):
    # the coarse pass only shapes importance sampling (+ an auxiliary rgb0
    # loss), so a smaller CP grid suffices — its triangle masks scale with
    # R_max, making the coarse σ pass ~4x cheaper at (17,33,65). None →
    # same resolutions/rank as the fine field (reference parity).
    cp_resolutions_coarse: Optional[Tuple[int, ...]] = None
    cp_rank_coarse: Optional[int] = None
    # CP grids have FIXED per-axis node budgets (unlike the hash grid, whose
    # fine levels keep resolving inside a huge bound) — so the CP bound must
    # hug the scene. LLFF-rescaled scenes fit comfortably in ±8.
    cp_bound: float = 8.0
    netdepth: int = 8
    netwidth: int = 256
    netdepth_fine: int = 8
    netwidth_fine: int = 256
    multires: int = 10
    multires_views: int = 4
    use_viewdirs: bool = True
    bound: float = 100.0           # hash-grid scene bound (tcnn `bound`)
    n_levels: int = 16
    n_features: int = 2
    log2_hashmap_size: int = 19
    base_res: int = 16
    compute_dtype: str = "float32"  # "bfloat16" for MXU-friendly training
    # NeRF_RGB parity (reference --alpha_model_path, run.py:376,2015-2044):
    # checkpoint dir of a pretrained run whose fine field supplies FROZEN σ;
    # only the color output of the trainable field optimizes.
    alpha_model_path: Optional[str] = None


@dataclass(frozen=True)
class RenderConfig:
    """Sampling / compositing (reference: N_samples, N_importance, ...)."""
    N_samples: int = 64
    N_importance: int = 64
    perturb: float = 1.0
    raw_noise_std: float = 0.0
    white_bkgd: bool = False
    lindisp: bool = False
    no_ndc: bool = True
    render_block: int = 32768      # rays per lax.map block (ref --chunk)


@dataclass(frozen=True)
class DataConfig:
    """Dataset (reference: datadir, factor, masks, depth supervision...)."""
    datadir: str = ""
    dataset_type: str = "llff"     # llff | blender | dtu
    factor: int = 4
    spherify: bool = False
    # Hold out every Nth view as test when every pose has an image
    # (reference run.py:804-806). 0 = off. Divergence, documented: the
    # reference default (1000000) silently holds out view 0; we default
    # to no holdout — the SPIn-NeRF split is inferred from asset counts.
    llffhold: int = 0
    origin: bool = True            # use RGB_inpainted/ + label/ + Depth_inpainted/
    colmap_depth: bool = True
    depth_lambda: float = 0.1
    sdepth_lambda: float = 0.1
    test_split_count: int = 40     # first N poses are the test split (load_llff.py:449)
    half_res: bool = False         # blender
    testskip: int = 8


@dataclass(frozen=True)
class GuidanceConfig:
    """Diffusion-prior guidance (reference: nerf/utils.py + sd_utils.py)."""
    guidance: Tuple[str, ...] = ("SD",)
    sd_version: str = "1.5"
    model_path: Optional[str] = None      # LoRA checkpoint dir
    guidance_scale: float = 7.5           # RGB CFG scale (the reference's
    # LIVE rgb_guidance_scale, run.py:468; its separate --guidance_scale
    # flag, default 75, feeds only the dead-shipped is_crop branch,
    # nerf/utils.py:283, and is on the documented-ignore allowlist)
    # Reference parser default 7.5 (run.py:464); aconfig_1.txt:20 ships an
    # EXPLICIT 1.5 override, so loading the shipped config still runs 1.5.
    normal_guidance_scale: float = 7.5
    colla_guidance_scale: float = 7.5     # run.py:489; live in the colla
    # step's 2-way branch only (sd_utils.py:691-693; CSD uses w1/w2)
    is_rgb_guidance: bool = True
    is_normal_guidance: bool = True
    is_colla_guidance: bool = False
    normal_start_iter: int = 500
    sds_loss_weight: float = 1e-4
    # Balanced/classifier score distillation (3-way CFG). Reference parity:
    # --use_csd is store_true default False (run.py:502) and absent from
    # aconfig_1.txt — the SHIPPED combine is 2-way SDS at the per-modality
    # guidance scales (7.5 rgb / 1.5 normal). True switches both modalities
    # to the 3-way combine w1·ε_text + w3·ε_null − w2·ε_uncond
    # (sd_utils.py:493-496) with the per-modality triples below.
    use_csd: bool = False
    # Shared triple (reference --w1/--w2/--w3 defaults, run.py:511-513).
    # Live reference consumers: the collaborative combine (w1/w2,
    # sd_utils.py:690) and the is_crop RGB path (nerf/utils.py:287) —
    # the plain RGB/normal dispatches use the per-modality triples instead.
    w1: float = 8.5
    w2: float = 7.5
    w3: float = 0.5
    # Per-modality CSD triples (reference --rgb_w1..3/--normal_w1..3
    # defaults, run.py:503-508), threaded to the RGB and normal-map
    # dispatches respectively (nerf/utils.py:294,310).
    rgb_w1: float = 8.5
    rgb_w2: float = 7.5
    rgb_w3: float = 0.5
    normal_w1: float = 2.5
    normal_w2: float = 1.5
    normal_w3: float = 0.5
    # Delayed negative-prompt gate (reference --use_negative, run.py:515):
    # until GLOBAL iteration i > use_negative the uncond embedding is the
    # null ("") prompt, not the negative prompt (sd_utils.py:354-357).
    # Default 0 = negative prompt active from iteration 1 on.
    use_negative: int = 0
    # SDS grad scale (reference --lambda_guidance, run.py:458). Divergence,
    # documented: the reference passes it as grad_scale into every
    # train-step (nerf/utils.py:284,291,301,307) but the step bodies never
    # read the parameter (the only `grad_scale` use, sd_utils.py:44, is
    # autograd's incoming cotangent) — the flag is dead there. We implement
    # the evident intent (stable-dreamfusion heritage: grad *= grad_scale);
    # at the shipped default 1.0 the two behaviors are identical.
    lambda_guidance: float = 1.0
    t_range: Tuple[float, float] = (0.02, 0.98)
    anneal_iters: int = 20000             # t = tmax − (tmax−tmin)·√(i/20000)
    normalmap_render_factor: int = 7
    lora_rank: int = 32
    # Local diffusers-layout checkpoint dir for SD-inpainting weights
    # (no network in this environment; random init when absent).
    sd_weights_dir: Optional[str] = None
    sd_tiny: bool = False          # tiny random SD stack (tests/smoke)
    sd_allow_random: bool = False  # full-size SD with random init (benchmarks)
    # Cache the RGB modality's masked-conditioning VAE encode per view
    # (it is a per-view constant; saves one full-size VAE encode per
    # step). See guidance/stable.py::
    # precompute_masked_latents for the documented divergence. Default False
    # (repo convention: perf knobs that change numerics vs the reference ship
    # reference-parity); the production config configs/spinnerf_scene.txt
    # turns it on.
    cache_masked_latents: bool = False
    # Self-trained prior checkpoint (flax msgpack of {unet, vae, embeds_rgb,
    # embeds_normal} from tools/train_tiny_prior.py) — the weights-free
    # analog of the reference's LoRA scene prior; loaded over the sd_tiny
    # stack for the guidance ablation.
    sd_prior_ckpt: Optional[str] = None
    # Flax LoRA adapters from THIS repo's trainer (train_lora.py
    # lora_*.safetensors), merged into the guidance UNet (and text encoder
    # when text adapters are present) at setup — the native-format
    # counterpart of `model_path` (which merges torch-PEFT dirs into real
    # SD weights). Closes the reference's end-to-end workflow: DreamBooth-
    # LoRA the prior on the scene, then guide stage-2 with it
    # (train_dreambooth...py → run.py --model_path).
    sd_lora_ckpt: Optional[str] = None
    # Tensor-parallel guidance: size of the mesh's `model` axis. When >1
    # (and devices % tp == 0) stage-2 builds a (data, model) mesh, shards
    # the UNet/VAE kernels out-channel over `model` (parallel/tp.py), each
    # sharded layer gathering its channels — the multi-chip answer to the
    # B=1 guidance wall-clock floor that data parallelism cannot shard.
    # 0/1 = off (pure data parallelism).
    tp: int = 0
    # Guidance render/latent resolution override (default: 512 full SD,
    # 64 tiny). The tiny prior trains at 128 → 16² latents so the SDS
    # gradient has usable spatial resolution on small scenes.
    sd_latent_size: Optional[int] = None
    prompt: str = ""
    prompt_normal: str = ""
    negative_prompt: str = ""
    # --- view-conditioned prompting (Pretrain_Model orchestration,
    # nerf/utils.py:222-319). Per iteration a random orbit azimuth is
    # sampled (rand_poses) and, under perpneg, blends direction-suffixed
    # prompt embeddings aggregated Perp-Neg style. The reference imports
    # the aggregator (sd_utils.py:24) but ships no live caller — and its
    # progressive branch reads opt.default_polar/front_decay_factor that
    # its own parser never defines (would AttributeError); we normalize
    # with stable-dreamfusion's defaults.
    perpneg: bool = False
    default_azimuth: float = 0.0
    default_polar: float = 90.0
    default_radius: float = 3.25
    radius_range: Tuple[float, float] = (3.0, 3.5)    # run.py:519
    theta_range: Tuple[float, float] = (45.0, 105.0)  # run.py:520
    phi_range: Tuple[float, float] = (-180.0, 180.0)  # run.py:521
    angle_overhead: float = 30.0                      # run.py:524
    angle_front: float = 60.0                         # run.py:525
    progressive_view: bool = False                    # run.py:531
    progressive_view_init_ratio: float = 0.2          # run.py:532
    exp_start_iter: int = 0                           # run.py:1192
    exp_end_iter: int = 0                             # 0 → N_iters (run.py:1193)
    negative_w: float = -2.0
    front_decay_factor: float = 2.0
    side_decay_factor: float = 10.0


@dataclass(frozen=True)
class TrainConfig:
    """Optimization loop (reference: lrate, N_iters, logging cadence...)."""
    N_iters: int = 10001
    N_rand: int = 1024
    lrate: float = 3e-3
    lrate_decay: int = 10          # ×0.1 per decay·1000 steps (run.py:1542)
    seed: int = 0
    # loss weights
    sigma_loss_weight: float = 0.0
    # (the reference's inpainted-depth term run.py:1502 is weighted by the
    # SAME --depth_lambda as stage 1 → data.depth_lambda covers it; a
    # separate knob here was a dead duplicate and was removed)
    lpips: bool = False
    lpips_weight: float = 0.01
    # Path to converted VGG16 weights (npz, utils/lpips.load_vgg16_npz).
    # Without it LPIPS runs on RANDOM features — fine as a training-loss
    # regularizer shape-check, meaningless as a reported quality metric
    # (a loud warning is printed). When set, held-out eval reports LPIPS
    # even if the lpips patch loss itself is off.
    lpips_weights: Optional[str] = None
    patch_len: int = 64
    n_patches: int = 4
    gradient_clip: bool = False    # pwclip on rendered tensors (run.py:56-78)
    ema_decay: float = 0.0         # >0 → track an EMA of params
    # TV+L1 regularization of CP-grid factor lines (TensoRF-style);
    # fights sparse-view floaters. 0 disables.
    tv_loss_weight: float = 1e-3
    # Failure recovery (beyond reference — its only recovery is manual
    # restart + ckpt reload, SURVEY.md §5): when the loss goes non-finite,
    # restore the latest checkpoint and re-fork the rng instead of
    # corrupting the params. 0 disables; N = max restores before aborting.
    nan_restarts: int = 3
    # Steps per device dispatch: in the JAX package >1 runs K train steps
    # as ONE jitted lax.scan program, to amortise the TPU's per-dispatch
    # cost. The port runs eagerly and ignores it.
    steps_per_dispatch: int = 1
    # cadence
    i_print: int = 100
    i_weights: int = 2000
    i_video: int = 10000
    i_evaluate: int = 10000
    i_testset: int = 10000
    # io
    basedir: str = "./logs"
    expname: str = "exp"
    no_reload: bool = False
    ft_path: Optional[str] = None
    render_only: bool = False
    render_test: bool = False
    # render_only variants: render the TRAIN poses as the path
    # (reference run.py:928,989) / dump the σ-profile of a test ray
    # (run.py:997-1010 → eval.render_test_ray + visualize_sigma).
    render_train: bool = False
    render_test_ray: bool = False
    render_factor: int = 0
    first_stage: bool = False      # stage-1 batched DS-NeRF path


@dataclass(frozen=True)
class MeshConfig:
    """The device mesh over torchrun's ranks (the reference's DataParallel
    analog, SURVEY §2.3; train/loop.py::build_mesh)."""
    data_axis: str = "data"
    num_devices: int = 0           # 0 → the world size (all ranks)


@dataclass(frozen=True)
class Config:
    field: FieldConfig = dc_field(default_factory=FieldConfig)
    render: RenderConfig = dc_field(default_factory=RenderConfig)
    data: DataConfig = dc_field(default_factory=DataConfig)
    guidance: GuidanceConfig = dc_field(default_factory=GuidanceConfig)
    train: TrainConfig = dc_field(default_factory=TrainConfig)
    mesh: MeshConfig = dc_field(default_factory=MeshConfig)

    def replace(self, **sections) -> "Config":
        return dataclasses.replace(self, **sections)


# Mapping of reference flat flag names → (section, field) for config-file
# parity. Flags that are dead in the live path are accepted and ignored.
_FLAG_MAP = {
    # field
    "no_tcnn": ("field", "no_tcnn"), "netdepth": ("field", "netdepth"),
    "netwidth": ("field", "netwidth"), "netdepth_fine": ("field", "netdepth_fine"),
    "netwidth_fine": ("field", "netwidth_fine"), "multires": ("field", "multires"),
    "multires_views": ("field", "multires_views"),
    "use_viewdirs": ("field", "use_viewdirs"), "bound": ("field", "bound"),
    "alpha_model_path": ("field", "alpha_model_path"),
    "n_levels": ("field", "n_levels"), "n_features": ("field", "n_features"),
    "log2_hashmap_size": ("field", "log2_hashmap_size"),
    "base_res": ("field", "base_res"),
    "compute_dtype": ("field", "compute_dtype"),
    "field_type": ("field", "field_type"), "cp_rank": ("field", "cp_rank"),
    "cp_rank_coarse": ("field", "cp_rank_coarse"),
    "cp_resolutions_coarse": ("field", "cp_resolutions_coarse"),
    "cp_bound": ("field", "cp_bound"),
    "cp_resolutions": ("field", "cp_resolutions"),
    # render
    "N_samples": ("render", "N_samples"), "N_importance": ("render", "N_importance"),
    "perturb": ("render", "perturb"), "raw_noise_std": ("render", "raw_noise_std"),
    "white_bkgd": ("render", "white_bkgd"), "lindisp": ("render", "lindisp"),
    "no_ndc": ("render", "no_ndc"), "chunk": ("render", "render_block"),
    # data
    "datadir": ("data", "datadir"), "dataset_type": ("data", "dataset_type"),
    "factor": ("data", "factor"), "spherify": ("data", "spherify"),
    "llffhold": ("data", "llffhold"), "origin": ("data", "origin"),
    "colmap_depth": ("data", "colmap_depth"),
    "depth_lambda": ("data", "depth_lambda"),
    "sdepth_lambda": ("data", "sdepth_lambda"),
    "half_res": ("data", "half_res"), "testskip": ("data", "testskip"),
    "test_split_count": ("data", "test_split_count"),
    # guidance
    "guidance": ("guidance", "guidance"), "sd_version": ("guidance", "sd_version"),
    "model_path": ("guidance", "model_path"),
    # NOTE: the reference's --guidance_scale (default 75, run.py:459) is
    # NOT mapped — its only consumer is the dead-shipped is_crop branch
    # (nerf/utils.py:283); mapping it onto the live RGB scale would let a
    # config meant for that branch silently 10x the SDS scale. The live
    # RGB knob is rgb_guidance_scale below (allowlisted in test_config.py).
    "normal_guidance_scale": ("guidance", "normal_guidance_scale"),
    "colla_guidance_scale": ("guidance", "colla_guidance_scale"),
    "is_rgb_guidance": ("guidance", "is_rgb_guidance"),
    "is_normal_guidance": ("guidance", "is_normal_guidance"),
    "is_colla_guidance": ("guidance", "is_colla_guidance"),
    "normal_start_iter": ("guidance", "normal_start_iter"),
    "sds_loss_weight": ("guidance", "sds_loss_weight"),
    "use_csd": ("guidance", "use_csd"),
    "w1": ("guidance", "w1"), "w2": ("guidance", "w2"), "w3": ("guidance", "w3"),
    "rgb_w1": ("guidance", "rgb_w1"), "rgb_w2": ("guidance", "rgb_w2"),
    "rgb_w3": ("guidance", "rgb_w3"),
    "normal_w1": ("guidance", "normal_w1"),
    "normal_w2": ("guidance", "normal_w2"),
    "normal_w3": ("guidance", "normal_w3"),
    "use_negative": ("guidance", "use_negative"),
    "lambda_guidance": ("guidance", "lambda_guidance"),
    "t_range": ("guidance", "t_range"),
    "anneal_iters": ("guidance", "anneal_iters"),
    "lora_rank": ("guidance", "lora_rank"),
    "normalmap_render_factor": ("guidance", "normalmap_render_factor"),
    "prompt": ("guidance", "prompt"),
    "negative_prompt": ("guidance", "negative_prompt"),
    "sd_weights_dir": ("guidance", "sd_weights_dir"),
    "sd_tiny": ("guidance", "sd_tiny"),
    "sd_allow_random": ("guidance", "sd_allow_random"),
    "cache_masked_latents": ("guidance", "cache_masked_latents"),
    "guidance_tp": ("guidance", "tp"),
    "sd_prior_ckpt": ("guidance", "sd_prior_ckpt"),
    "sd_lora_ckpt": ("guidance", "sd_lora_ckpt"),
    "sd_latent_size": ("guidance", "sd_latent_size"),
    "perpneg": ("guidance", "perpneg"),
    "default_azimuth": ("guidance", "default_azimuth"),
    "default_polar": ("guidance", "default_polar"),
    "default_radius": ("guidance", "default_radius"),
    "radius_range": ("guidance", "radius_range"),
    "theta_range": ("guidance", "theta_range"),
    "phi_range": ("guidance", "phi_range"),
    "angle_overhead": ("guidance", "angle_overhead"),
    "angle_front": ("guidance", "angle_front"),
    "progressive_view": ("guidance", "progressive_view"),
    "progressive_view_init_ratio":
        ("guidance", "progressive_view_init_ratio"),
    "exp_start_iter": ("guidance", "exp_start_iter"),
    "exp_end_iter": ("guidance", "exp_end_iter"),
    "negative_w": ("guidance", "negative_w"),
    "front_decay_factor": ("guidance", "front_decay_factor"),
    "side_decay_factor": ("guidance", "side_decay_factor"),
    # reference aconfig_1.txt aliases
    "normal_start": ("guidance", "normal_start_iter"),
    "rgb_guidance_scale": ("guidance", "guidance_scale"),
    "text": ("guidance", "prompt"),
    "text_normal": ("guidance", "prompt_normal"),
    # train
    "N_iters": ("train", "N_iters"), "N_rand": ("train", "N_rand"),
    "tv_loss_weight": ("train", "tv_loss_weight"),
    "nan_restarts": ("train", "nan_restarts"),
    "lrate": ("train", "lrate"), "lrate_decay": ("train", "lrate_decay"),
    "sigma_loss_weight": ("train", "sigma_loss_weight"),
    "lpips": ("train", "lpips"), "patch_len": ("train", "patch_len"),
    "n_patches": ("train", "n_patches"),
    "lpips_weight": ("train", "lpips_weight"),
    "lpips_weights": ("train", "lpips_weights"),
    "seed": ("train", "seed"), "ema_decay": ("train", "ema_decay"),
    "steps_per_dispatch": ("train", "steps_per_dispatch"),
    "gradient_clip": ("train", "gradient_clip"),
    "i_print": ("train", "i_print"), "i_weights": ("train", "i_weights"),
    "i_video": ("train", "i_video"), "i_evaluate": ("train", "i_evaluate"),
    "i_testset": ("train", "i_testset"), "basedir": ("train", "basedir"),
    "expname": ("train", "expname"), "no_reload": ("train", "no_reload"),
    "ft_path": ("train", "ft_path"), "render_only": ("train", "render_only"),
    "render_test": ("train", "render_test"),
    "render_train": ("train", "render_train"),
    "render_test_ray": ("train", "render_test_ray"),
    "render_factor": ("train", "render_factor"),
    "first_stage": ("train", "first_stage"),
}


def _coerce(value: str, target_type):
    v = value.strip()
    if target_type is bool or v in ("True", "False"):
        return v == "True"
    if target_type is str and v not in ("None", "none"):
        # respect string-typed knobs whose values look numeric
        # (sd_version = 1.5, expname = 42)
        return v
    try:
        if target_type is int:
            return int(v)
        if target_type is float:
            return float(v)
        return int(v) if v.lstrip("-").isdigit() else float(v)
    except ValueError:
        return v


def load_reference_config(path: str, base: Optional[Config] = None) -> Config:
    """Parse a reference-style ``key = value`` config txt into a Config.

    Accepts the exact format of DS_NeRF/config/aconfig_1.txt. Unknown keys are
    collected and ignored (the reference has many dead flags).
    """
    cfg = base or Config()
    sections = {s: dict() for s in
                ("field", "render", "data", "guidance", "train", "mesh")}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#") or "=" not in line:
                continue
            key, _, value = line.partition("=")
            key = key.strip()
            value = value.strip()
            if value.startswith('"'):
                # quoted value — save_config quotes strings containing '#'
                # (e.g. prompt = "a #1 fan photo") so comment-stripping
                # cannot truncate them on reload
                close = value.rfind('"')
                value = value[1:close] if close > 0 else value[1:]
            else:
                value = value.split("#", 1)[0].strip()
            if key not in _FLAG_MAP:
                continue
            section, fname = _FLAG_MAP[key]
            ftype = type(getattr(getattr(cfg, section), fname))
            val = _coerce(value, ftype)
            if isinstance(val, str) and val in ("None", "none"):
                val = None  # explicit reset to the dataclass default/None
            elif fname == "guidance" and isinstance(val, str):
                val = tuple(val.split(","))
            elif fname in ("cp_resolutions", "cp_resolutions_coarse"):
                if isinstance(val, str):
                    val = tuple(int(x) for x in val.split(","))
                elif isinstance(val, (int, float)):
                    val = (int(val),)  # single-resolution coarse grid
            elif (isinstance(getattr(getattr(cfg, section), fname), tuple)
                  and isinstance(val, str)):
                # float-tuple knobs (t_range, radius/theta/phi_range):
                # accept both "a,b" and the reference's nargs-style "a b"
                val = tuple(float(x)
                            for x in val.replace(",", " ").split())
            sections[section][fname] = val
    return Config(**{
        s: dataclasses.replace(getattr(cfg, s), **kv) if kv else getattr(cfg, s)
        for s, kv in sections.items()
    })


def save_config(cfg: Config, path: str) -> None:
    """Dump the resolved config (reference dumps args.txt/config.txt,
    run.py:938-947) as a RELOADABLE config txt: keys are the reference
    flag names, tuples comma-joined, so ``load_reference_config`` on the
    dump reproduces the config."""
    rev = {}
    for flag, tgt in _FLAG_MAP.items():
        rev.setdefault(tgt, flag)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        for section in dataclasses.fields(cfg):
            sub = getattr(cfg, section.name)
            f.write(f"# [{section.name}]\n")
            for fld in dataclasses.fields(sub):
                flag = rev.get((section.name, fld.name), fld.name)
                v = getattr(sub, fld.name)
                if isinstance(v, tuple):
                    v = ",".join(str(x) for x in v)
                if isinstance(v, str) and "#" in v:
                    v = f'"{v}"'   # keep '#' out of the comment stripper
                f.write(f"{flag} = {v}\n")
            f.write("\n")
