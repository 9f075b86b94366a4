"""Convert torchvision VGG16 weights (+ optional lpips-package linear heads)
to the npz layout ``utils/lpips.py::load_vgg16_npz`` reads.

The twin of tools/convert_vgg.py: the same CLI and the same npz. The
reference computes LPIPS through the ``lpips`` pip package; with no
network, a user drops the checkpoints locally:

    torchvision vgg16:   features.{i}.weight/bias (conv indices
                         0,2,5,7,10,12,14,17,19,21,24,26,28)
    lpips vgg heads:     lin{k}.model.1.weight [1, C, 1, 1], k = 0..4
                         (or lins.{k}.model.1.weight)

and this tool writes one npz with ``conv_{j}/kernel`` (HWIO),
``conv_{j}/bias`` and the flat per-channel ``lin_{k}`` vectors, in f32.
``.pth`` files are read by ``torch.load(weights_only=True)``,
``.safetensors`` by ``guidance/weights.py::read_safetensors`` (no
safetensors package needed).

    python -m gbnerf_tpu_torch.tools.convert_vgg vgg16.pth out.npz \\
        [--lpips lpips_vgg.pth]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

# torchvision VGG16 `features` indices of the 13 conv layers, in order
TORCH_CONV_IDX = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)


def load_torch_sd(path: str) -> dict:
    """A .pth or .safetensors state dict → {name: f32 numpy array}."""
    if path.endswith(".safetensors"):
        from ..guidance.weights import read_safetensors

        sd = read_safetensors(path)
    else:
        sd = torch.load(path, map_location="cpu", weights_only=True)
        if hasattr(sd, "state_dict"):
            sd = sd.state_dict()
    return {k: v.float().numpy() for k, v in sd.items()}


def convert(vgg_sd: dict, lpips_sd: dict | None = None) -> dict:
    """State dicts (numpy) → the npz's arrays: OIHW convs to HWIO, the
    lin heads flattened."""
    out = {}
    for j, idx in enumerate(TORCH_CONV_IDX):
        w = vgg_sd[f"features.{idx}.weight"]          # OIHW
        b = vgg_sd[f"features.{idx}.bias"]
        out[f"conv_{j}/kernel"] = w.transpose(2, 3, 1, 0).astype(np.float32)
        out[f"conv_{j}/bias"] = b.astype(np.float32)
    if lpips_sd is not None:
        for k in range(5):
            key = next(k2 for k2 in (f"lin{k}.model.1.weight",
                                     f"lins.{k}.model.1.weight")
                       if k2 in lpips_sd)
            out[f"lin_{k}"] = lpips_sd[key].reshape(-1).astype(np.float32)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("vgg", help="torchvision vgg16 state dict (.pth or "
                                ".safetensors)")
    ap.add_argument("out", help="output npz")
    ap.add_argument("--lpips", help="lpips package vgg.pth (linear heads)")
    args = ap.parse_args(argv)

    vgg_sd = load_torch_sd(args.vgg)
    lpips_sd = load_torch_sd(args.lpips) if args.lpips else None
    out = convert(vgg_sd, lpips_sd)
    np.savez(args.out, **out)
    lins = "with" if lpips_sd else "without"
    print(f"wrote {args.out}: {len(out)} arrays ({lins} lpips lin heads)")


if __name__ == "__main__":
    main()
