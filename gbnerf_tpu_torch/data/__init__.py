"""Scene loaders and ray banks (numpy on the host, torch on the device)."""
from .llff import (LLFFScene, load_llff_data, load_colmap_depth,
                   load_sensor_depth, load_nerd_data,
                   load_poses_bounds, render_path_spiral, recenter_poses,
                   spherify_poses, poses_avg)
from .rays_bank import RayBanks, RayStream, build_ray_banks, sample_batch
from . import colmap

__all__ = [
    "LLFFScene", "load_llff_data", "load_colmap_depth", "load_sensor_depth",
    "load_nerd_data", "load_poses_bounds",
    "render_path_spiral", "recenter_poses", "spherify_poses", "poses_avg",
    "RayBanks", "RayStream", "build_ray_banks", "sample_batch", "colmap",
]
