"""Convert a reference (GB-NeRF / DS-NeRF torch) checkpoint to the port.

The twin of tools/convert_ref_ckpt.py. The reference saves
``{global_step, network_fn_state_dict, network_fine_state_dict,
optimizer_state_dict}`` every i_weights iterations (its run.py:1550-1560);
the networks are the original-NeRF MLPs (run_nerf_helpers.py:75-158),
whose topology the port's ``NeRFMLP`` has layer for layer. So the state
dicts carry across by a key map alone: ``pts_linears.{i}`` → ``trunk_{i}``,
``alpha_linear`` → ``sigma``, ``feature_linear`` → ``feature``,
``views_linears.0`` → ``views_0``, ``rgb_linear`` → ``rgb``,
``output_linear`` → ``output`` (torch's [out, in] layout on both sides).
The result is written as a port checkpoint that ``--set
train.ft_path=<out>`` loads:

    python -m gbnerf_tpu_torch.tools.convert_ref_ckpt ref_060000.tar OUT \\
        [--config scene_cfg.txt]
    python -m gbnerf_tpu_torch.run --config scene_cfg.txt \\
        --set train.ft_path=OUT

The optimizer moments are not converted (a fresh Adam state): torch Adam's
state is keyed by parameter order. The config must select the MLP
(no_tcnn = True, with the reference run's netdepth, netwidth, multires);
without --config an 8×256 MLP. The reference's tcnn checkpoints carry no
weights (its run.py:2199-2202), so there is nothing to convert for them.
"""
from __future__ import annotations

import argparse
import dataclasses
import os

_RENAMES = (("pts_linears.", "trunk_"), ("alpha_linear.", "sigma."),
            ("feature_linear.", "feature."), ("views_linears.", "views_"),
            ("rgb_linear.", "rgb."), ("output_linear.", "output."))


def ref_nerf_to_port(sd: dict) -> dict:
    """A reference NeRF state dict → the port NeRFMLP's (f32 tensors).

    use_viewdirs with its heads, or the single output head; a NeRF_RGB
    dict (no alpha_linear) maps the same, its σ then comes from
    alpha_model_path, as in the reference. Other keys raise."""
    import torch

    out = {}
    for key, v in sd.items():
        for old, new in _RENAMES:
            if key.startswith(old):
                out[new + key[len(old):]] = torch.as_tensor(v).float().clone()
                break
        else:
            raise ValueError(f"unknown reference key {key!r}")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("tar", help="reference .tar checkpoint")
    ap.add_argument("out", help="output checkpoint dir (use as ft_path)")
    ap.add_argument("--config", help="config matching the reference run's "
                    "MLP; default an 8x256 no_tcnn MLP")
    args = ap.parse_args(argv)

    import torch

    from ..config import Config, load_reference_config
    from ..train.checkpoint import CheckpointManager
    from ..train.state import create_train_state

    # the reference's .tar holds its optimizer state too: a full unpickle
    ckpt = torch.load(args.tar, map_location="cpu", weights_only=False)
    step = int(ckpt.get("global_step", 0))
    coarse_sd = ckpt.get("network_fn_state_dict")
    fine_sd = ckpt.get("network_fine_state_dict")
    if coarse_sd is None and fine_sd is None:
        raise SystemExit("no network_fn/network_fine state dicts in the tar")
    if args.config:
        cfg = load_reference_config(args.config)
    else:
        cfg = Config()
        cfg = cfg.replace(field=dataclasses.replace(cfg.field, no_tcnn=True))
    if not cfg.field.no_tcnn:
        raise SystemExit(
            "config selects a grid field; reference MLP checkpoints convert "
            "only onto no_tcnn = True runs (tcnn tars carry no weights, the "
            "reference's run.py:2199-2202)")
    state, coarse, fine = create_train_state(
        cfg, torch.Generator().manual_seed(0), "cpu")
    converted = {}
    if coarse_sd is not None:
        converted["coarse"] = (coarse, ref_nerf_to_port(coarse_sd))
    if fine_sd is not None and fine is not None:
        converted["fine"] = (fine, ref_nerf_to_port(fine_sd))
    elif fine_sd is not None:
        print("[convert] the tar has network_fine but the config has "
              "N_importance = 0; dropping the fine net")
    for name, (module, sd) in converted.items():
        ours = {k: tuple(v.shape) for k, v in module.state_dict().items()}
        theirs = {k: tuple(v.shape) for k, v in sd.items()}
        if ours != theirs:
            raise SystemExit(
                f"{name} architecture mismatch (set netdepth/netwidth/"
                f"multires to the reference run's):\n ours={ours}\n"
                f" tar ={theirs}")
        module.load_state_dict(sd)
    state.step = step
    CheckpointManager(args.out).save(step, state)
    print(f"[convert] wrote {'+'.join(sorted(converted))} @ step {step} -> "
          f"{args.out}\nresume:  --set train.ft_path="
          f"{os.path.abspath(args.out)}")
    return state


if __name__ == "__main__":
    main()
