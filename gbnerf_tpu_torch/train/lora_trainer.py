"""DreamBooth-inpaint LoRA fine-tuning of the SD-inpainting prior.

Port of gbnerf_tpu/train/lora_trainer.py: instance images with per-image
caption files, random rectangle or ellipse masks per sample, the 9-channel
UNet input, the ε-MSE (weighted by the instance masks when given, plus
the class term under prior preservation), optional rank-4 text-encoder
adapters, AdamW as ``optax.adamw(lr, b1=0.9, b2=0.999, weight_decay=1e-2)``
(torch's AdamW: the same update, decoupled decay), checkpoints every N
steps and an exact resume.

The UNet, VAE and text tower stay frozen; the step calls the UNet (and the
text tower) through ``torch.func.functional_call`` with the effective
weights of guidance/lora.py::apply_lora, so gradients reach only the
adapters. Images are read with the port's PNG codec (other formats through
imageio where it imports) and resized in numpy (data/llff.py: INTER_AREA's
overlap weights, which are also its weights when it enlarges, and
INTER_NEAREST for instance masks), once each when the dataset is built:
the dataset holds them by index, read again only where a file changes on
disk, so a step's batch is its random draws and the stacking of held
arrays.

Randomness: the host streams (batch indices, ``random_mask``, the prompt
draw of train_lora's prior flow) are numpy, as in the JAX package, so one
seed gives the same batches in both. The device draws (t, ε, the VAE
posterior ε of the image and of the masked image) come from a
``torch.Generator``, or from a ``JaxKey`` split as the JAX trainer splits
its key (utils/jax_random.py: ``draws="jax"`` gives the JAX package's
run for a seed), or are injected (``draws``); the A init likewise.
Checkpoints hold the adapters and AdamW's moments in the JAX package's
``{"lora", "opt"}`` msgpack layout (utils/msgpack.py) and, in meta.json,
the torch generator's state (or the JAX key, as ``jax_rng``) and the numpy
host rng: train(2N) equals train(N) followed by resume(N), bit for bit.
"""
from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.func import functional_call

from ..data.llff import _imread, resize_area, resize_nearest
from ..guidance.lora import (TEXT_TARGETS, apply_lora, init_lora,
                             lora_param_count, save_lora)
from ..guidance.stable import Prompts, SDModules, _resize
from ..parallel.mesh import (average_grads, data_sharding, gather,
                             make_mesh, replicate, shard_batch, world_size)
from ..parallel.mesh import rank as process_rank
from ..utils import jax_random as jr
from ..utils import msgpack
from ..utils.profiling import SPAN_DATA_BATCH, SPAN_DATA_DECODE, annotate
from ..utils.png import write_png


def random_mask(rng: np.random.Generator, h: int, w: int,
                ratio: Tuple[float, float] = (0.25, 1.0)) -> np.ndarray:
    """Random rectangle or ellipse mask (the reference's random_mask)."""
    mask = np.zeros((h, w), np.float32)
    size = rng.uniform(*ratio)
    mw = int(w * size * rng.uniform(0.5, 1.0))
    mh = int(h * size * rng.uniform(0.5, 1.0))
    mw, mh = max(mw, 4), max(mh, 4)
    x0 = rng.integers(0, max(w - mw, 1))
    y0 = rng.integers(0, max(h - mh, 1))
    if rng.random() < 0.5:
        mask[y0:y0 + mh, x0:x0 + mw] = 1.0
    else:
        yy, xx = np.mgrid[0:h, 0:w]
        cy, cx = y0 + mh / 2, x0 + mw / 2
        mask[((xx - cx) / (mw / 2)) ** 2
             + ((yy - cy) / (mh / 2)) ** 2 <= 1] = 1.0
    return mask


class _Held(NamedTuple):
    """One instance as batch() serves it, and the files it was read from."""
    key: tuple                   # _file_key of each of _sources' paths
    image: np.ndarray            # [res, res, 3] uint8, read-only
    mask: Optional[np.ndarray]   # [res, res] uint8 in {0, 1}, read-only
    caption: str


def _file_key(path: str):
    """(st_mtime_ns, st_size) of the file at path; None where there is
    none."""
    try:
        st = os.stat(path)
    except OSError:
        return None
    return st.st_mtime_ns, st.st_size


@dataclass
class DreamBoothInpaintDataset:
    """Instance images with same-stem .txt captions (beside them or in
    caption_dir) and optional instance masks (mask_dir) for the masked
    loss; default_caption for an image without a caption file (the class
    images of prior preservation).

    Every instance is decoded once, when the dataset is built: its image
    area-resized to [res, res, 3] uint8, its mask to {0, 1}, its caption
    read, all held by index, read-only. Each later use stats the item's
    files (image, caption, mask candidates) and decodes the item again
    where one of them changed, appeared or went, so a file replaced on
    disk is never served stale. ``decodes`` counts the decodes, each in
    a ``gbnerf.data.decode`` span."""

    instance_dir: str
    caption_dir: Optional[str] = None
    mask_dir: Optional[str] = None
    resolution: int = 512
    default_caption: str = ""

    def __post_init__(self):
        exts = (".png", ".jpg", ".jpeg", ".JPG", ".PNG")
        self.files = [os.path.join(self.instance_dir, f)
                      for f in sorted(os.listdir(self.instance_dir))
                      if f.endswith(exts)]
        if not self.files:
            raise FileNotFoundError(f"no images in {self.instance_dir}")
        self.decodes = 0
        self._held = [self._decode(i) for i in range(len(self.files))]

    def __len__(self):
        return len(self.files)

    def _stem(self, idx: int) -> str:
        return os.path.splitext(os.path.basename(self.files[idx]))[0]

    def _sources(self, idx: int) -> Tuple[str, ...]:
        """The item's image, its caption file and its mask candidates in
        the order they are looked for."""
        stem = self._stem(idx)
        masks = (tuple(os.path.join(self.mask_dir, stem + ext)
                       for ext in (".png", ".jpg"))
                 if self.mask_dir else ())
        return (self.files[idx],
                os.path.join(self.caption_dir or self.instance_dir,
                             stem + ".txt")) + masks

    def _decode(self, idx: int) -> _Held:
        # the key is taken before the reads: a file replaced during them
        # leaves a key that the next use finds stale
        paths = self._sources(idx)
        key = tuple(_file_key(p) for p in paths)
        with annotate(SPAN_DATA_DECODE):
            self.decodes += 1
            img = np.asarray(_imread(paths[0]))[..., :3]
            # >8-bit input would wrap modulo 256 under a bare astype(uint8)
            if img.dtype == np.uint16:
                img = (img // 257).astype(np.uint8)
            elif img.dtype != np.uint8:
                img = np.clip(np.round(
                    img.astype(np.float32)
                    * (255.0 if img.max() <= 1.0 else 1.0)), 0, 255
                ).astype(np.uint8)
            img = resize_area(img, self.resolution, self.resolution)
            # held in the layout resize_area made: [W, H, 3] in memory, and
            # so is the stacked batch. Its permute to NCHW is then no
            # channels-last tensor and the VAE encodes in NCHW; a C-ordered
            # image would send the encoder channels-last, which costs an
            # H100 ≈ 12 ms of strided elementwise kernels a LoRA step
            # (batch 4 at 512²)
            img.flags.writeable = False
            caption = self.default_caption
            if key[1] is not None:
                with open(paths[1]) as fh:
                    caption = fh.read().strip()
            mask = next((self._read_mask(p)
                         for p, k in zip(paths[2:], key[2:])
                         if k is not None), None)
        return _Held(key, img, mask, caption)

    def _read_mask(self, path: str) -> np.ndarray:
        m = np.asarray(_imread(path)).astype(np.float32)
        if m.ndim > 2:
            m = m[..., 0]
        m = resize_nearest(m, self.resolution, self.resolution)
        m = (m > 127).astype(np.uint8)
        m.flags.writeable = False
        return m

    def _item(self, idx: int) -> _Held:
        """The held item, decoded again where a file of it changed."""
        held = self._held[idx]
        if held.key != tuple(_file_key(p) for p in self._sources(idx)):
            held = self._held[idx] = self._decode(idx)
        return held

    def caption(self, idx: int) -> str:
        return self._item(idx).caption

    def image(self, idx: int) -> np.ndarray:
        """[res, res, 3] uint8 (normalised to [-1, 1] on the device)."""
        return np.copy(self._item(idx).image)

    def instance_mask(self, idx: int) -> Optional[np.ndarray]:
        """[res, res] float32 in {0, 1}, or None without a mask file."""
        m = self._item(idx).mask
        return None if m is None else m.astype(np.float32)

    def batch(self, rng: np.random.Generator, batch_size: int):
        """A host batch: images u8, random masks u8, captions, instance
        masks u8 (ones for an image without one) or None. Draws from rng
        the indices, then one random mask a sample; the images, captions
        and instance masks come from the held items."""
        with annotate(SPAN_DATA_BATCH):
            idx = rng.integers(0, len(self.files), batch_size)
            masks = np.stack([random_mask(rng, self.resolution,
                                          self.resolution)
                              for _ in range(batch_size)]).astype(np.uint8)
            held = [self._item(i) for i in idx]
            imgs = np.stack([h.image for h in held])
            captions = [h.caption for h in held]
            if any(h.mask is not None for h in held):
                ones = np.ones((self.resolution,) * 2, np.uint8)
                imasks = np.stack([ones if h.mask is None else h.mask
                                   for h in held])
            else:
                imasks = None
        return imgs, masks, captions, imasks


def draw_step(generator, batch: int, lr_res: int, device,
              num_train_timesteps: int = 1000, enc_dtype=torch.float32
              ) -> Dict[str, torch.Tensor]:
    """The draws of one step: t [B] uniform in [0, T), the noise ε and the
    VAE posterior ε of the image and of the masked image, [B, lr, lr, 4]
    each. A JaxKey splits in four as the JAX trainer's loss does (noise,
    t, the image's and the masked image's posterior ε, the last two in
    the VAE's dtype ``enc_dtype``)."""
    shape = (batch, lr_res, lr_res, 4)
    if jr.is_jax(generator):
        k_noise, k_t, k_enc1, k_enc2 = jr.key_split(generator, 4)
        return {"t": jr.randint(k_t, (batch,), 0, num_train_timesteps,
                                device),
                "noise": jr.normal(k_noise, shape, torch.float32, device),
                "enc_eps": jr.normal(k_enc1, shape, enc_dtype, device),
                "enc_masked_eps": jr.normal(k_enc2, shape, enc_dtype,
                                            device)}
    return {
        "t": torch.randint(0, num_train_timesteps, (batch,),
                           generator=generator, device=device),
        "noise": torch.randn(shape, generator=generator, device=device),
        "enc_eps": torch.randn(shape, generator=generator, device=device),
        "enc_masked_eps": torch.randn(shape, generator=generator,
                                      device=device)}


def make_lora_train_step(mods: SDModules, *, rank: int = 32,
                         lr: float = 1e-4, masked_loss: bool = False,
                         prior_preservation: bool = False,
                         prior_loss_weight: float = 1.0,
                         text_tower=None, text_rank: int = 4, mesh=None,
                         mesh_axis="data"):
    """Build (init_fn, step) for LoRA training.

    init_fn(generator=None, a_init=None) → (adapters, optimizer): the
    adapters (flat, guidance/lora.py's keys; with text_tower prefixed
    "unet." / "text.", as the JAX package's {"unet", "text"} tree) as
    leaf tensors that require grad, and AdamW over them. A JaxKey splits
    in two, the UNet's adapters from the first, the text tower's from
    the second, as the JAX package's init_fn.

    step(adapters, optimizer, batch, generator=None, draws=None) →
    {"loss"}: one update in place. batch = {image [B,S,S,3] u8 or [-1,1]
    f32, mask [B,S,S], embeds [B,L,D] (or input_ids with text_tower),
    instance_mask [B,S,S] | None; on the SDXL stack the pooled embedding
    pooled [B,P], conditioned with the stack's size ids mods.time_ids};
    draws: draw_step's dict, else drawn from generator. ``step.loss_fn(adapters, batch, draws)`` is the loss
    alone.

    prior_preservation: the batch is [instance ‖ class] halves and the
    loss the instance term (instance-masked when masked_loss) plus
    prior_loss_weight · the class term. text_tower: the CLIP text module;
    rank-4 (α 4) adapters on its q/k/v/out_proj, run inside the loss on
    batch["input_ids"] (one tower: refused on the SDXL stack, which has
    two).

    mesh: a DeviceMesh (parallel/mesh.py), the reference's HF-Accelerate
    DDP: the step takes the global batch (and draws it whole), each rank
    computes the loss of its rows over ``mesh_axis``, the per-sample
    errors are gathered so that the loss is the one-process loss on every
    rank, and the adapter gradients are averaged before AdamW.
    """
    sched = mods.schedule
    unet, vae = mods.unet, mods.vae
    if text_tower is not None and mods.text_model_2 is not None:
        raise ValueError("text-encoder adapters train one tower; the SDXL "
                         "stack has two: train the UNet's adapters alone")

    def init_fn(generator=None,
                a_init: Optional[Dict[str, torch.Tensor]] = None):
        k_u, k_t = jr.split(generator)
        if text_tower is None:
            ad = init_lora(unet, rank=rank, generator=k_u, a_init=a_init)
        else:
            sub = (lambda p: None if a_init is None else
                   {k[len(p):]: v for k, v in a_init.items()
                    if k.startswith(p)})
            ad = {"unet." + k: v for k, v in init_lora(
                unet, rank=rank, generator=k_u,
                a_init=sub("unet.")).items()}
            ad.update({"text." + k: v for k, v in init_lora(
                text_tower, rank=text_rank, targets=TEXT_TARGETS,
                generator=k_t, a_init=sub("text.")).items()})
        replicate(mesh, ad)
        for v in ad.values():
            v.requires_grad_(True)
        opt = torch.optim.AdamW(list(ad.values()), lr=lr, betas=(0.9, 0.999),
                                eps=1e-8, weight_decay=1e-2)
        return ad, opt

    def _split(adapters):
        if text_tower is None:
            return adapters, None
        return ({k[5:]: v for k, v in adapters.items()
                 if k.startswith("unet.")},
                {k[5:]: v for k, v in adapters.items()
                 if k.startswith("text.")})

    def loss_fn(adapters, batch, draws):
        B_all = batch["image"].shape[0]
        batch = shard_batch(mesh, batch, mesh_axis)
        draws = shard_batch(mesh, draws, mesh_axis)
        unet_ad, text_ad = _split(adapters)
        eff = apply_lora(unet, unet_ad, rank=rank)
        if text_ad is not None:
            embeds = functional_call(
                text_tower, apply_lora(text_tower, text_ad, rank=text_rank),
                (batch["input_ids"],))
        else:
            embeds = batch["embeds"]
        image, mask = batch["image"], batch["mask"]
        if image.dtype == torch.uint8:
            image = image.float() / 127.5 - 1.0
        mask = mask.float()
        B, lr_res = image.shape[0], image.shape[1] // 8
        with torch.no_grad():
            latents = vae.encode(image, draws["enc_eps"])
            masked_latents = vae.encode(image * (mask[..., None] < 0.5),
                                        draws["enc_masked_eps"])
        mask_lat = _resize(mask[..., None], lr_res, method="nearest")
        t, noise = draws["t"], draws["noise"]
        noisy = sched.add_noise(latents, noise, t)
        unet_in = torch.cat([noisy, mask_lat,
                             masked_latents.to(noisy.dtype)], dim=-1)
        pred = functional_call(unet, eff, (
            unet_in, t, embeds, mods.added_cond(batch.get("pooled"))))
        err = (pred - noise) ** 2

        def instance_weight(imask):
            return 1.0 - _resize(imask.float()[..., None], lr_res,
                                 method="nearest")

        imask = batch.get("instance_mask")
        if masked_loss and imask is not None:
            # under prior preservation only the instance half is weighted
            w = instance_weight(imask)
            if prior_preservation:
                rows = torch.arange(B, device=w.device) + data_sharding(
                    mesh, B_all, mesh_axis).start
                w = torch.where((rows < B_all // 2)[:, None, None, None], w,
                                torch.ones_like(w))
            err = err * w
        # per-sample means, gathered: the loss of the whole batch on
        # every rank (each sample holds as many elements)
        per = gather(err.mean(dim=(1, 2, 3)), mesh, mesh_axis, n=B_all)
        if prior_preservation:
            half = B_all // 2
            return per[:half].mean() + prior_loss_weight * per[half:].mean()
        return per.mean()

    def step(adapters, optimizer, batch, generator=None, draws=None):
        if draws is None:
            img = batch["image"]
            draws = draw_step(generator, img.shape[0], img.shape[1] // 8,
                              img.device, sched.num_train_timesteps,
                              vae.quant_conv.weight.dtype)
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(adapters, batch, draws)
        loss.backward()
        average_grads(adapters.values(), mesh)
        optimizer.step()
        return {"loss": loss.detach()}

    step.loss_fn = loss_fn
    return init_fn, step


# ---------------- checkpoints ----------------

def _nest(flat: Dict[str, np.ndarray]) -> Dict:
    tree: Dict = {}
    for key, v in flat.items():
        parts = key.split(".")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def _flat(tree: Dict, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def save_lora_checkpoint(output_dir: str, step: int, adapters, optimizer,
                         generator, host_rng: np.random.Generator) -> str:
    """A resumable ``checkpoint-{step}/``: state.msgpack (the adapters and
    AdamW's count and moments, as the JAX package's {"lora": tree, "opt":
    (ScaleByAdamState, EmptyState, EmptyState)}) and meta.json (the step,
    the torch generator's state or the JAX key's two words as the JAX
    package writes them, ``jax_rng``, the numpy host rng's state)."""
    d = os.path.join(output_dir, f"checkpoint-{step}")
    os.makedirs(d, exist_ok=True)

    def host(x):
        return x.detach().float().cpu().numpy()

    mu, nu, count = {}, {}, 0
    for k, p in adapters.items():
        st = optimizer.state.get(p, {})
        mu[k] = host(st["exp_avg"]) if st else np.zeros(p.shape, np.float32)
        nu[k] = (host(st["exp_avg_sq"]) if st
                 else np.zeros(p.shape, np.float32))
        count = int(st["step"]) if st else 0
    state = {"lora": _nest({k: host(v) for k, v in adapters.items()}),
             "opt": {"0": {"count": np.asarray(count, np.int32),
                           "mu": _nest(mu), "nu": _nest(nu)},
                     "1": {}, "2": {}}}
    msgpack.save(os.path.join(d, "state.msgpack"), state)
    meta = {"step": step, "host_rng": host_rng.bit_generator.state}
    if jr.is_jax(generator):
        meta["jax_rng"] = list(generator.words())
    else:
        meta["torch_rng"] = generator.get_state().tolist()
    with open(os.path.join(d, "meta.json"), "w") as fh:
        json.dump(meta, fh)
    return d


def latest_lora_checkpoint(output_dir: str) -> Optional[str]:
    """The most recent ``checkpoint-*`` dir, or None."""
    if not os.path.isdir(output_dir):
        return None
    dirs = [d for d in os.listdir(output_dir) if d.startswith("checkpoint-")
            and d.split("-")[-1].isdigit()]
    if not dirs:
        return None
    return os.path.join(output_dir,
                        max(dirs, key=lambda d: int(d.split("-")[-1])))


def restore_lora_checkpoint(path: str, adapters, optimizer, generator
                            ) -> Tuple[np.random.Generator, int, object]:
    """Load a checkpoint dir into the adapters, the optimizer and (a torch
    generator) the generator in place → (host rng, step, the draws' state:
    the generator, or the JaxKey the checkpoint holds). A checkpoint
    resumes the kind of draws that wrote it."""
    state = msgpack.load(os.path.join(path, "state.msgpack"))
    lora, adam = _flat(state["lora"]), state["opt"]["0"]
    mu, nu = _flat(adam["mu"]), _flat(adam["nu"])
    if set(lora) != set(adapters):
        raise ValueError(f"{path}: the adapters do not fit the model "
                         f"({len(set(lora) ^ set(adapters))} keys differ)")
    count = int(adam["count"])
    with torch.no_grad():
        for k, p in adapters.items():
            p.copy_(torch.from_numpy(lora[k]))
            if count:
                optimizer.state[p] = {
                    "step": torch.tensor(float(count), dtype=torch.float32),
                    "exp_avg": torch.from_numpy(mu[k]).to(p.device),
                    "exp_avg_sq": torch.from_numpy(nu[k]).to(p.device)}
    with open(os.path.join(path, "meta.json")) as fh:
        meta = json.load(fh)
    kind = "jax" if "jax_rng" in meta else "torch"
    if kind != ("jax" if jr.is_jax(generator) else "torch"):
        raise ValueError(f"{path} was written with {kind} draws: resume it "
                         f"with draws={kind!r}")
    if kind == "jax":
        generator = jr.JaxKey(*(int(w) for w in meta["jax_rng"]))
    else:
        generator.set_state(torch.tensor(meta["torch_rng"],
                                         dtype=torch.uint8))
    host_rng = np.random.default_rng()
    host_rng.bit_generator.state = meta["host_rng"]
    return host_rng, int(meta["step"]), generator


def generate_class_images(mods: SDModules, embeds3,
                          class_data_dir: str, num_class_images: int,
                          generator=None, *,
                          num_inference_steps: int = 50,
                          resolution: Optional[int] = None) -> int:
    """Top up ``class_data_dir`` to num_class_images prior-preservation
    class images: each a full inpaint (guidance/pipeline.py) of a uniform
    random image under a full mask, written as PNG (embeds3: the rows
    (null, uncond, text) as inpaint takes them). Returns how many were
    written. A JaxKey splits in three an image, as the JAX package's:
    the key carried on, the image's uniforms, the inpaint's key."""
    from ..guidance.pipeline import inpaint

    os.makedirs(class_data_dir, exist_ok=True)
    existing = [f for f in os.listdir(class_data_dir)
                if f.endswith((".png", ".jpg", ".jpeg"))]
    n_new = num_class_images - len(existing)
    if n_new <= 0:
        return 0
    S = mods.latent_size
    dev = embeds3.device
    print(f"[lora] generating {n_new} class images → {class_data_dir}")
    for i in range(n_new):
        generator, k_img, k_gen = jr.split(generator, 3)
        img = jr.draw("rand", (S, S, 3), k_img, device=dev)
        out = inpaint(mods, embeds3, img, torch.ones((S, S), device=dev),
                      k_gen, num_inference_steps=num_inference_steps)
        out8 = (np.clip(out.cpu().numpy(), 0, 1) * 255).astype(np.uint8)
        if resolution and resolution != S:
            out8 = resize_area(out8, resolution, resolution)
        write_png(os.path.join(class_data_dir,
                               f"class_{len(existing) + i:05d}.png"), out8)
    return n_new


def train_lora(mods: SDModules, dataset: DreamBoothInpaintDataset,
               encode_prompt: Callable, *, steps: int = 2000,
               batch_size: int = 4, rank: int = 32, lr: float = 1e-4,
               seed: int = 0, output_dir: str = "./lora_out",
               checkpointing_steps: int = 500, masked_loss: bool = False,
               log_every: int = 50,
               class_dataset: Optional[DreamBoothInpaintDataset] = None,
               prior_loss_weight: float = 1.0, text_tower=None,
               tokenize: Optional[Callable] = None, text_rank: int = 4,
               resume_from: Optional[str] = None, device=None, mesh=None,
               draws: str = "torch"):
    """The LoRA fine-tune loop on ``device`` (default: the UNet's): writes
    ``lora_{step:06d}.safetensors`` and a resumable checkpoint every
    checkpointing_steps and at the end. encode_prompt(captions[, rng]) →
    their Prompts, or a context [B, L, D] (it gets the checkpointed host
    rng when it takes ``rng``).
    class_dataset: prior preservation. text_tower / tokenize: the text
    module and captions → ids, for rank-4 text adapters. resume_from:
    'latest' or a checkpoint dir. mesh: a DeviceMesh; under torchrun
    with more than one rank, one over every rank is made: the batch is
    split over the ranks (each draws the global batch from the same host
    rng and keeps its rows), and rank 0 alone logs and writes. draws:
    "torch" (generators seeded with seed and seed + 1) or "jax" (the JAX
    package's keys: init_fn(PRNGKey(seed)), then PRNGKey(seed + 1) split
    once a step). Returns the adapters."""
    import inspect

    os.makedirs(output_dir, exist_ok=True)
    lead = process_rank() == 0
    if mesh is None and world_size() > 1:
        mesh = make_mesh()
        if lead:
            print(f"[lora] data-parallel over {world_size()} devices")
    if text_tower is not None and tokenize is None:
        raise ValueError("text_tower requires a tokenize fn "
                         "(captions → input_ids)")
    device = torch.device(device) if device is not None else \
        next(mods.unet.parameters()).device
    accepts_rng = "rng" in inspect.signature(encode_prompt).parameters
    init_fn, step = make_lora_train_step(
        mods, rank=rank, lr=lr, masked_loss=masked_loss,
        prior_preservation=class_dataset is not None,
        prior_loss_weight=prior_loss_weight, text_tower=text_tower,
        text_rank=text_rank, mesh=mesh)
    if draws not in ("torch", "jax"):
        raise ValueError(f"draws must be 'torch' or 'jax', not {draws!r}")
    if draws == "jax":
        adapters, opt = init_fn(jr.PRNGKey(seed))
        gen = jr.PRNGKey(seed + 1)
    else:
        adapters, opt = init_fn(
            torch.Generator(device=device).manual_seed(seed))
        gen = torch.Generator(device=device).manual_seed(seed + 1)
    if lead:
        print(f"[lora] training {lora_param_count(adapters):,} adapter "
              "params")

    host_rng = np.random.default_rng(seed)
    start = 0
    if resume_from:
        path = (latest_lora_checkpoint(output_dir)
                if resume_from == "latest" else resume_from)
        if path and os.path.isdir(path):
            host_rng, start, gen = restore_lora_checkpoint(
                path, adapters, opt, gen)
            if lead:
                print(f"[lora] resumed from {path} at step {start}")
        elif lead:
            print(f"[lora] resume checkpoint '{resume_from}' not found; "
                  "starting fresh")

    def dev(a):
        return torch.as_tensor(a, device=device)

    t0 = t_start = time.perf_counter()
    for i in range(start + 1, steps + 1):
        imgs, masks, captions, imasks = dataset.batch(host_rng, batch_size)
        if class_dataset is not None:
            cimgs, cmasks, ccaps, _ = class_dataset.batch(host_rng,
                                                          batch_size)
            imgs = np.concatenate([imgs, cimgs])
            masks = np.concatenate([masks, cmasks])
            captions = captions + ccaps
            if imasks is not None:
                imasks = np.concatenate([imasks, np.zeros_like(imasks)])
        batch = {"image": dev(imgs), "mask": dev(masks),
                 "instance_mask": dev(imasks) if imasks is not None else None}
        if text_tower is not None:
            batch["input_ids"] = dev(tokenize(captions))
        else:
            rows = Prompts.of(encode_prompt(captions, rng=host_rng)
                              if accepts_rng else encode_prompt(captions))
            batch["embeds"] = dev(rows.context)
            if rows.pooled is not None:
                batch["pooled"] = dev(rows.pooled)
        gen, key = jr.split(gen)
        m = step(adapters, opt, batch, key)
        if i % log_every == 0 and lead:
            loss = float(m["loss"])
            print(f"[lora {i}/{steps}] loss={loss:.4f} "
                  f"({log_every / (time.perf_counter() - t0):.1f} it/s)",
                  flush=True)
            t0 = time.perf_counter()
        if (i % checkpointing_steps == 0 or i == steps) and lead:
            p = os.path.join(output_dir, f"lora_{i:06d}.safetensors")
            save_lora(adapters, p)
            save_lora_checkpoint(output_dir, i, adapters, opt, gen, host_rng)
            print(f"[lora] saved {p} (+ checkpoint-{i})")
    if lead:
        print(f"[lora] {steps - start} steps in "
              f"{time.perf_counter() - t_start:.3f} s")
    return adapters
