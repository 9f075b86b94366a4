"""CLI: DreamBooth-inpaint LoRA fine-tuning of the SD-inpainting prior.

    python -m gbnerf_tpu_torch.train_lora --instance_data_dir data/imgs \\
        --caption_dir data/captions --output_dir ckpt_lora \\
        --max_train_steps 19000 --rank 32 --train_batch_size 4 \\
        [--sd_weights_dir /path/to/sd-inpainting] [--tiny] [--device cpu]

The port's twin of the root train_lora.py, with its flags; ``--device``
(default cuda) picks the device, and without a card the CLI exits 1 naming
the flag. ``--tiny`` trains the tiny random stack in f32 (tests, smoke
runs); ``--sd_prior_ckpt`` fine-tunes on a prior of
``gbnerf_tpu_torch.tools.train_tiny_prior`` (conditioned on the prior's
own embedding triple unless ``--caption_dir``); the adapters go to
stage 2 through ``guidance.sd_lora_ckpt``. Without ``--sd_weights_dir``
the full-size stack has random weights.

Under ``torchrun`` the batch is split over the ranks (data parallel, one
rank a device; ``--dist_backend`` as for gbnerf_tpu_torch.run):

    python -m torch.distributed.run --nproc_per_node 2 \
        -m gbnerf_tpu_torch.train_lora --instance_data_dir D ...
"""
from __future__ import annotations

import argparse


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--instance_data_dir", required=True)
    ap.add_argument("--caption_dir", default=None)
    ap.add_argument("--instance_mask_dir", default=None)
    ap.add_argument("--output_dir", default="./lora_out")
    ap.add_argument("--resolution", type=int, default=512)
    ap.add_argument("--train_batch_size", type=int, default=4)
    ap.add_argument("--max_train_steps", type=int, default=2000)
    ap.add_argument("--learning_rate", type=float, default=1e-4)
    ap.add_argument("--rank", type=int, default=32)
    ap.add_argument("--checkpointing_steps", type=int, default=500)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sd_weights_dir", default=None)
    ap.add_argument("--tiny", action="store_true",
                    help="tiny random SD stack (smoke testing)")
    ap.add_argument("--resume_from_checkpoint", default=None,
                    help="'latest' or a checkpoint-N dir")
    ap.add_argument("--with_prior_preservation", action="store_true")
    ap.add_argument("--class_data_dir", default=None)
    ap.add_argument("--class_prompt", default=None)
    ap.add_argument("--num_class_images", type=int, default=100)
    ap.add_argument("--prior_loss_weight", type=float, default=1.0)
    ap.add_argument("--sample_steps", type=int, default=50,
                    help="denoise steps for class-image generation")
    ap.add_argument("--train_text_encoder", action="store_true",
                    help="rank-4 text-encoder adapters")
    ap.add_argument("--sd_prior_ckpt", default=None,
                    help="tiny-prior msgpack to fine-tune on; consume the "
                         "adapters in stage 2 via guidance.sd_lora_ckpt")
    ap.add_argument("--latent_size", type=int, default=None,
                    help="guidance/render resolution (default 64 tiny, "
                         "512 full; set to the prior's training res)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--dist_backend", default=None,
                    help="under torchrun: nccl (default on the card) or "
                         "gloo (the default on the CPU; on the card it "
                         "lets ranks share a card)")
    args = ap.parse_args(argv)
    if args.with_prior_preservation and not (args.class_data_dir
                                             and args.class_prompt):
        ap.error("--with_prior_preservation needs --class_data_dir "
                 "and --class_prompt")
    if args.train_text_encoder and args.sd_prior_ckpt:
        # the prior checkpoint bakes the prompt embeddings: stage 2 has no
        # text tower to merge text adapters into (train/loop.py refuses it)
        ap.error("--train_text_encoder is incompatible with "
                 "--sd_prior_ckpt (the prior checkpoint bakes the prompt "
                 "embeds; there is no text tower at guidance time)")
    return args


def main(argv=None):
    args = parse_args(argv)

    import numpy as np
    import torch

    from .config import GuidanceConfig
    from .guidance.stable import build_sd_modules
    from .guidance.text import CLIPTextConfig
    from .guidance.unet import UNetConfig
    from .guidance.vae import VAEConfig
    from .train.loop import device_from_flag
    from .train.lora_trainer import (DreamBoothInpaintDataset,
                                     generate_class_images, train_lora)

    from .parallel.mesh import init_distributed, world_size
    from .parallel.mesh import rank as process_rank

    device = init_distributed(device_from_flag(args.device),
                              args.dist_backend)
    gcfg = GuidanceConfig(sd_weights_dir=args.sd_weights_dir)
    kw = {}
    if args.tiny:
        kw = dict(unet_config=UNetConfig.tiny(), vae_config=VAEConfig.tiny(),
                  text_config=CLIPTextConfig(vocab_size=49408, width=32,
                                             layers=2, heads=2),
                  latent_size=args.latent_size or 64, dtype=torch.float32)
    elif args.latent_size:
        kw = dict(latent_size=args.latent_size)
    mods = build_sd_modules(
        gcfg, torch.Generator(device=device).manual_seed(args.seed),
        weights_dir=args.sd_weights_dir, device=device, **kw)
    if args.sd_prior_ckpt:
        from .guidance.weights import load_prior_ckpt

        load_prior_ckpt(args.sd_prior_ckpt, mods)
        print(f"[lora] fine-tuning on prior {args.sd_prior_ckpt}")

    # captions → embeddings through the stack's own text tower (with
    # sd_weights_dir, the real CLIP weights): text adapters train against
    # the base that guidance's merge applies them to
    text, tok = mods.text_model, mods.tokenizer

    def tokenize(captions):
        return torch.as_tensor(tok(captions), device=device)

    if args.sd_prior_ckpt and not args.caption_dir:
        # condition on the prior's baked triple, as stage 2 does; the draw
        # comes from the trainer's checkpointed host rng, so a resume
        # replays it
        emb3 = mods.embeds_rgb
        fallback = np.random.default_rng(args.seed + 3)

        def encode_prompt(captions, rng=None):
            idx = (rng or fallback).integers(0, emb3.shape[0], len(captions))
            return emb3[torch.as_tensor(idx, device=emb3.device)]
    else:
        def encode_prompt(captions, rng=None):
            with torch.no_grad():
                return text(tokenize(captions))

    resolution = (args.resolution if not args.tiny
                  else (args.latent_size or 64))
    dataset = DreamBoothInpaintDataset(
        args.instance_data_dir, caption_dir=args.caption_dir,
        mask_dir=args.instance_mask_dir, resolution=resolution)

    class_dataset = None
    if args.with_prior_preservation:
        # under --sd_prior_ckpt the baked triple is (null, uncond, text) in
        # order; encode_prompt's index draw would scramble the CFG slots
        if args.sd_prior_ckpt and not args.caption_dir:
            embeds3 = mods.embeds_rgb
        else:
            embeds3 = encode_prompt(["", "", args.class_prompt])
        if process_rank() == 0:
            generate_class_images(
                mods, embeds3, args.class_data_dir, args.num_class_images,
                torch.Generator(device=device).manual_seed(args.seed + 99),
                num_inference_steps=args.sample_steps,
                resolution=resolution)
        if world_size() > 1:
            torch.distributed.barrier()
        class_dataset = DreamBoothInpaintDataset(
            args.class_data_dir, resolution=resolution,
            default_caption=args.class_prompt)

    adapters = train_lora(
        mods, dataset, encode_prompt, steps=args.max_train_steps,
        batch_size=args.train_batch_size, rank=args.rank,
        lr=args.learning_rate, seed=args.seed, output_dir=args.output_dir,
        checkpointing_steps=args.checkpointing_steps,
        masked_loss=args.instance_mask_dir is not None,
        class_dataset=class_dataset,
        prior_loss_weight=args.prior_loss_weight,
        text_tower=text if args.train_text_encoder else None,
        tokenize=tokenize if args.train_text_encoder else None,
        resume_from=args.resume_from_checkpoint, device=device)
    if world_size() > 1:
        torch.distributed.destroy_process_group()
    return adapters


if __name__ == "__main__":
    main()
