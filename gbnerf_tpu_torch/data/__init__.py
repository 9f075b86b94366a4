"""Scene loaders, ray banks (numpy on the host, torch on the device), the
COLMAP pose conversion and the native host library."""
from .llff import (LLFFScene, load_llff_data, load_colmap_depth,
                   load_sensor_depth, load_nerd_data,
                   load_poses_bounds, render_path_spiral, recenter_poses,
                   spherify_poses, poses_avg)
from .rays_bank import RayBanks, RayStream, build_ray_banks, sample_batch
from .pose_utils import colmap_to_poses_bounds, gen_poses, run_colmap
from . import colmap, native

__all__ = [
    "LLFFScene", "load_llff_data", "load_colmap_depth", "load_sensor_depth",
    "load_nerd_data", "load_poses_bounds",
    "render_path_spiral", "recenter_poses", "spherify_poses", "poses_avg",
    "RayBanks", "RayStream", "build_ray_banks", "sample_batch", "colmap",
    "native", "colmap_to_poses_bounds", "gen_poses", "run_colmap",
]
