"""What the NeRF traffic kinds share: the port's Config from a
configuration's flags, read by the port's own parser as it reads
configs/spinnerf_scene.txt."""
from __future__ import annotations

import os


def port_config(flags: dict, scratch) -> "object":
    from gbnerf_tpu_torch.config import load_reference_config

    path = os.path.join(scratch, "config.txt")
    with open(path, "w") as fh:
        for k, v in flags.items():
            fh.write(f"{k} = {v}\n")
    return load_reference_config(path)


def render_dict(cfg) -> dict:
    r = cfg.render
    return {"N_samples": r.N_samples, "N_importance": r.N_importance,
            "lindisp": r.lindisp, "perturb": r.perturb,
            "raw_noise_std": r.raw_noise_std, "white_bkgd": r.white_bkgd}
