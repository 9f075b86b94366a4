"""The diffusion-prior guidance stack (port of gbnerf_tpu/guidance/):
SD1.5-inpainting UNet, VAE and CLIP text tower, the noise schedule, score
distillation and the train-step hook, LoRA adapters (lora.py), the
weights loaders with the PEFT merge and prior checkpoints (weights.py) and
the DDIM inpaint pipeline (pipeline.py). Not ported yet: Perp-Neg, the
orchestrator and directional prompts, and CLIP guidance."""
from .schedule import DiffusionSchedule
from .sds import (cfg_combine_sds, cfg_combine_bsd, cfg_combine_colla,
                  inject_gradient, score_distillation_grad)
from .unet import UNet2DCondition, UNetConfig
from .vae import AutoencoderKL, VAEConfig, SD_VAE_SCALING
from .text import CLIPTextEncoder, CLIPTextConfig, Tokenizer
from .stable import SDModules, build_sd_modules, make_guidance_fn, sd_train_step

__all__ = [
    "DiffusionSchedule",
    "cfg_combine_sds", "cfg_combine_bsd", "cfg_combine_colla",
    "inject_gradient", "score_distillation_grad",
    "UNet2DCondition", "UNetConfig",
    "AutoencoderKL", "VAEConfig", "SD_VAE_SCALING",
    "CLIPTextEncoder", "CLIPTextConfig", "Tokenizer",
    "SDModules", "build_sd_modules", "make_guidance_fn", "sd_train_step",
]
