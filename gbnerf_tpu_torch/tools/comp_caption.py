#!/usr/bin/env python
"""Caption prep: prefix every caption txt with its modality tag.

The port's twin of tools/comp_caption.py (parity with the reference's
comp_caption.py): the LoRA prior is trained jointly on RGB and
surface-normal images, distinguished by caption prefixes ("RGB image, ..."
/ "normal map, ..."). The files it writes are byte for byte the JAX
tool's.

    python -m gbnerf_tpu_torch.tools.comp_caption <caption_dir> \\
        --prefix "RGB image"
"""
from __future__ import annotations

import argparse
import os


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("caption_dir")
    ap.add_argument("--prefix", required=True,
                    help='e.g. "RGB image" or "normal map"')
    ap.add_argument("--suffix_sep", default=", ")
    args = ap.parse_args(argv)

    n = 0
    for f in sorted(os.listdir(args.caption_dir)):
        if not f.endswith(".txt"):
            continue
        p = os.path.join(args.caption_dir, f)
        with open(p) as fh:
            text = fh.read().strip()
        if text.startswith(args.prefix):
            continue
        with open(p, "w") as fh:
            fh.write(f"{args.prefix}{args.suffix_sep}{text}")
        n += 1
    print(f"prefixed {n} captions in {args.caption_dir}")
    return n


if __name__ == "__main__":
    main()
