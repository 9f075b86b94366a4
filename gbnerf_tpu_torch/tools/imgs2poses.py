"""Camera poses for a scene directory with COLMAP → poses_bounds.npy.

The twin of tools/imgs2poses.py (the reference's DS_NeRF/imgs2poses.py),
on the port's COLMAP reader:

    python -m gbnerf_tpu_torch.tools.imgs2poses <scenedir> \\
        [--match_type exhaustive_matcher|sequential_matcher] \\
        [--colmap_bin colmap]

Runs COLMAP (feature_extractor → matcher → mapper) unless <scenedir>/
sparse/0 already holds a model, then writes <scenedir>/poses_bounds.npy.
"""
from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("scenedir")
    ap.add_argument("--match_type", default="exhaustive_matcher",
                    choices=["exhaustive_matcher", "sequential_matcher"])
    ap.add_argument("--colmap_bin", default="colmap")
    args = ap.parse_args(argv)

    from ..data.pose_utils import gen_poses

    arr = gen_poses(args.scenedir, args.match_type, args.colmap_bin)
    print(f"wrote poses_bounds.npy with {len(arr)} poses")
    return arr


if __name__ == "__main__":
    main()
