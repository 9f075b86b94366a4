"""Rays, encodings, fields, sampling, rendering and normals.

The ray and normal helpers and the hash-grid field are exported here;
import the other submodules directly.
"""
from .rays import get_rays, get_rays_by_coord, ndc_rays
from .fields import HashGridField, hash_encode
from .normals import (depth2xyz, depth2normal_geo, render_normal_map,
                      pointcloud_normals, field_normals,
                      estimate_normals_grad)

__all__ = [
    "get_rays", "get_rays_by_coord", "ndc_rays", "HashGridField",
    "hash_encode",
    "depth2xyz", "depth2normal_geo", "render_normal_map",
    "pointcloud_normals", "field_normals", "estimate_normals_grad",
]
