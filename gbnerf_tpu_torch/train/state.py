"""Field construction: coarse + fine fields from a config.

Port of the field half of gbnerf_tpu/train/state.py. In PyTorch a field
module owns its parameters, so ``create_params`` returns the initialised
modules. The Adam state and the LR schedule come with training.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..config import Config
from ..core.cp_field import CPGridField
from ..core.fields import NeRFMLP


def build_field(cfg: Config, fine: bool = False, *, device=None,
                generator: Optional[torch.Generator] = None) -> nn.Module:
    f = cfg.field
    if f.no_tcnn:
        dtype = torch.bfloat16 if f.compute_dtype == "bfloat16" else torch.float32
        return NeRFMLP(
            depth=f.netdepth_fine if fine else f.netdepth,
            width=f.netwidth_fine if fine else f.netwidth,
            multires=f.multires, multires_views=f.multires_views,
            use_viewdirs=f.use_viewdirs, compute_dtype=dtype,
            device=device, generator=generator)
    if f.field_type == "hash":
        raise NotImplementedError("HashGridField is not ported yet; use "
                                  "field_type = cp")
    res, rank = tuple(f.cp_resolutions), f.cp_rank
    if not fine:
        # proposal-style coarse field (FieldConfig.cp_resolutions_coarse)
        res = tuple(f.cp_resolutions_coarse or res)
        rank = f.cp_rank_coarse or rank
    return CPGridField(bound=f.cp_bound, resolutions=res, rank=rank,
                       device=device, generator=generator)


def create_params(cfg: Config, generator: torch.Generator, device=None
                  ) -> Tuple[nn.Module, Optional[nn.Module]]:
    """Init the coarse and fine fields → (coarse, fine); fine is None when
    N_importance == 0 (the coarse field is then reused)."""
    coarse = build_field(cfg, fine=False, device=device, generator=generator)
    fine = None
    if cfg.render.N_importance > 0:
        fine = build_field(cfg, fine=True, device=device, generator=generator)
    return coarse, fine
