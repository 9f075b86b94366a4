"""The diffusion-prior guidance stack (port of gbnerf_tpu/guidance/):
SD1.5-inpainting UNet, VAE and CLIP text tower, the noise schedule, score
distillation and the train-step hook, LoRA adapters (lora.py), the
weights loaders with the PEFT merge and prior checkpoints (weights.py) and
the DDIM inpaint pipeline (pipeline.py), Perp-Neg (perpneg.py) with the
directional prompts (directional.py) and the orbit views
(orchestrator.py), collaborative guidance, and CLIP guidance
(clip_guidance.py)."""
from .schedule import DiffusionSchedule
from .sds import (cfg_combine_sds, cfg_combine_bsd, cfg_combine_colla,
                  inject_gradient, score_distillation_grad)
from .unet import UNet2DCondition, UNetConfig
from .vae import AutoencoderKL, VAEConfig, SD_VAE_SCALING
from .text import CLIPTextEncoder, CLIPTextConfig, Tokenizer
from .stable import (SDModules, build_sd_modules, guidance_params,
                     make_guidance_fn, sd_train_step, sd_train_step_colla,
                     sd_train_step_perpneg)
from .perpneg import (get_perpendicular_component,
                      weighted_perpendicular_aggregator)
from .directional import adjust_text_embeddings, get_pos_neg_text_embeddings
from .orchestrator import ProgressiveViews, progressive_ranges, rand_poses
from .clip_guidance import CLIPGuidance, CLIPVisionConfig, CLIPVisionEncoder

__all__ = [
    "DiffusionSchedule",
    "cfg_combine_sds", "cfg_combine_bsd", "cfg_combine_colla",
    "inject_gradient", "score_distillation_grad",
    "UNet2DCondition", "UNetConfig",
    "AutoencoderKL", "VAEConfig", "SD_VAE_SCALING",
    "CLIPTextEncoder", "CLIPTextConfig", "Tokenizer",
    "SDModules", "build_sd_modules", "guidance_params", "make_guidance_fn",
    "sd_train_step", "sd_train_step_colla", "sd_train_step_perpneg",
    "get_perpendicular_component", "weighted_perpendicular_aggregator",
    "adjust_text_embeddings", "get_pos_neg_text_embeddings",
    "ProgressiveViews", "progressive_ranges", "rand_poses",
    "CLIPGuidance", "CLIPVisionConfig", "CLIPVisionEncoder",
]
