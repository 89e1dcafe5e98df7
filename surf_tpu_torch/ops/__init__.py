"""Sampling, projection and sparse-voxel ops, with the wrappers of the
hand-written CUDA kernels K1-K3 (K4 lives with the sparse U-Net in
nn/reg_net.py)."""

from .grid_sample import (bilinear_sample, bilinear_sample_2d,
                          trilinear_sample, trilinear_sample_3d,
                          nearest_sample_2d, nearest_sample_3d, lookup_volume,
                          resize_bilinear_2d, upsample_trilinear_x2)
from .projection import (to_homo, world_to_cam, cam_to_pixel, project_points,
                         project_points_all, pixel_to_normalized,
                         in_frustum_mask, pixels_to_rays, ray_z_cos,
                         compute_ray_diff, make_pixel_grid)
from .embedder import embedder

__all__ = [
    "bilinear_sample", "bilinear_sample_2d", "trilinear_sample",
    "trilinear_sample_3d", "nearest_sample_2d", "nearest_sample_3d",
    "lookup_volume", "resize_bilinear_2d", "upsample_trilinear_x2", "to_homo",
    "world_to_cam", "cam_to_pixel", "project_points", "project_points_all",
    "pixel_to_normalized", "in_frustum_mask", "pixels_to_rays", "ray_z_cos",
    "compute_ray_diff", "make_pixel_grid", "embedder",
]
