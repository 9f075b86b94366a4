"""Train state: the coarse and fine fields, one Adam over both, the LR
schedule.

Port of gbnerf_tpu/train/state.py. In PyTorch a field module owns its
parameters, so ``create_params`` returns the initialised modules and
``TrainState`` holds them beside the optimizer and the step count. The
state is updated in place; the step functions return it for the JAX
package's calling convention.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

import torch
from torch import nn

from ..config import Config
from ..core.cp_field import CPGridField
from ..core.fields import HashGridField, NeRFMLP
from ..utils import jax_random as jr


def build_field(cfg: Config, fine: bool = False, *, device=None,
                generator: Optional[torch.Generator] = None) -> nn.Module:
    """The field the config names: the NeRF MLP (no_tcnn), the hash grid
    (field_type = hash; the coarse and fine fields alike) or the CP grid
    (with the proposal-style coarse field of cp_resolutions_coarse)."""
    f = cfg.field
    dtype = torch.bfloat16 if f.compute_dtype == "bfloat16" else torch.float32
    if f.no_tcnn:
        return NeRFMLP(
            depth=f.netdepth_fine if fine else f.netdepth,
            width=f.netwidth_fine if fine else f.netwidth,
            multires=f.multires, multires_views=f.multires_views,
            use_viewdirs=f.use_viewdirs, compute_dtype=dtype,
            device=device, generator=generator)
    if f.field_type == "hash":
        return HashGridField(
            bound=f.bound, n_levels=f.n_levels, n_features=f.n_features,
            log2_hashmap_size=f.log2_hashmap_size, base_res=f.base_res,
            compute_dtype=dtype, device=device, generator=generator)
    res, rank = tuple(f.cp_resolutions), f.cp_rank
    if not fine:
        # proposal-style coarse field (FieldConfig.cp_resolutions_coarse)
        res = tuple(f.cp_resolutions_coarse or res)
        rank = f.cp_rank_coarse or rank
    return CPGridField(bound=f.cp_bound, resolutions=res, rank=rank,
                       device=device, generator=generator)


def create_params(cfg: Config, generator, device=None
                  ) -> Tuple[nn.Module, Optional[nn.Module]]:
    """Init the coarse and fine fields → (coarse, fine); fine is None when
    N_importance == 0 (the coarse field is then reused). generator: a
    torch.Generator, or a JaxKey for the JAX package's
    ``create_train_state(cfg, key)`` fields (utils/jax_init.py)."""
    key = generator if jr.is_jax(generator) else None
    if key is not None:
        generator = torch.Generator().manual_seed(0)
    coarse = build_field(cfg, fine=False, device=device, generator=generator)
    fine = None
    if cfg.render.N_importance > 0:
        fine = build_field(cfg, fine=True, device=device, generator=generator)
    if key is not None:
        from ..utils.jax_init import init_train_fields

        init_train_fields(coarse, fine, key)
    return coarse, fine


def lr_schedule(cfg: Config) -> Callable[[int], float]:
    """lr(step) = lrate · 0.1^(step / (lrate_decay · 1000)) (the reference's
    run.py:1542-1546)."""
    t = cfg.train

    def schedule(step):
        return t.lrate * 0.1 ** (step / (t.lrate_decay * 1000.0))

    return schedule


def make_optimizer(cfg: Config, params) -> torch.optim.Adam:
    """One Adam over ``params``, as optax.adam(lr_schedule): betas (0.9,
    0.999), eps 1e-8. The step sets each update's learning rate from
    ``lr_schedule`` at the step count before the update, as optax does."""
    return torch.optim.Adam(list(params), lr=cfg.train.lrate,
                            betas=(0.9, 0.999), eps=1e-8)


@dataclass
class TrainState:
    step: int                     # updates done so far
    coarse: nn.Module
    fine: Optional[nn.Module]
    optimizer: torch.optim.Adam

    def fields(self) -> List[nn.Module]:
        return [self.coarse] + ([self.fine] if self.fine is not None else [])

    def state_dict(self) -> dict:
        out = {"step": self.step, "coarse": self.coarse.state_dict(),
               "optimizer": self.optimizer.state_dict()}
        if self.fine is not None:
            out["fine"] = self.fine.state_dict()
        return out

    def load_state_dict(self, sd: dict) -> None:
        """Load in place: the step functions close over these modules."""
        self.step = int(sd["step"])
        self.coarse.load_state_dict(sd["coarse"])
        if self.fine is not None:
            self.fine.load_state_dict(sd["fine"])
        self.optimizer.load_state_dict(sd["optimizer"])


def adam_step(state: TrainState, schedule: Callable[[int], float]) -> None:
    """One Adam update of the gradients in place, as optax.adam(schedule):
    the learning rate is schedule(step) at the update count before the
    update, the bias corrections use the count after it (torch's ``step``
    state); then the count advances."""
    for group in state.optimizer.param_groups:
        group["lr"] = schedule(state.step)
    state.optimizer.step()
    state.step += 1


def create_train_state(cfg: Config, generator: torch.Generator, device=None
                       ) -> Tuple[TrainState, nn.Module, Optional[nn.Module]]:
    """Init the fields (drawn from ``generator``, a torch.Generator or a
    JaxKey, on ``device``) and the optimizer → (state, coarse, fine), as
    the JAX package returns (state, coarse_model, fine_model)."""
    coarse, fine = create_params(cfg, generator, device)
    params = list(coarse.parameters())
    if fine is not None:
        params += list(fine.parameters())
    state = TrainState(0, coarse, fine, make_optimizer(cfg, params))
    return state, coarse, fine
