"""Camera projection / ray geometry (torch counterpart of
surf_tpu/ops/projection.py; same conventions):

  * ``intr``: (4, 4) pinhole intrinsics (top-left 3x3 = K)
  * ``c2w``:  (4, 4) camera-to-world pose
  * world points live in the unit-sphere-normalized scene frame
"""

from __future__ import annotations

import torch


def to_homo(pts):
    """(..., 3) -> (..., 4) homogeneous."""
    return torch.cat([pts, torch.ones_like(pts[..., :1])], dim=-1)


def invert_pose(c2w):
    """Closed-form inverse of rigid pose(s) [R|t]: [R^T | -R^T t]."""
    R = c2w[..., :3, :3]
    t = c2w[..., :3, 3]
    Rt = R.transpose(-1, -2)
    new_t = -torch.einsum("...ij,...j->...i", Rt, t)
    top = torch.cat([Rt, new_t[..., None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=c2w.dtype,
                          device=c2w.device).expand(*c2w.shape[:-2], 1, 4)
    return torch.cat([top, bottom], dim=-2)


def invert_intrinsics(intr):
    """Closed-form inverse of pinhole K, batched: (..., 4, 4) -> (..., 3, 3)."""
    K = intr[..., :3, :3]
    fx, s, cx = K[..., 0, 0], K[..., 0, 1], K[..., 0, 2]
    fy, cy = K[..., 1, 1], K[..., 1, 2]
    z = torch.zeros_like(fx)
    o = torch.ones_like(fx)
    return torch.stack([
        torch.stack([1.0 / fx, -s / (fx * fy), (s * cy - cx * fy) / (fx * fy)], -1),
        torch.stack([z, 1.0 / fy, -cy / fy], -1),
        torch.stack([z, z, o], -1),
    ], dim=-2)


def world_to_cam(pts, c2w):
    """pts (..., 3), c2w (4, 4) -> camera-frame points (..., 3)."""
    return torch.einsum("ij,...j->...i", invert_pose(c2w)[:3, :4], to_homo(pts))


def cam_to_pixel(cam_pts, intr):
    """cam_pts (..., 3) -> (xy (..., 2), depth (...,))."""
    proj = torch.einsum("ij,...j->...i", intr[:3, :3], cam_pts)
    depth = proj[..., 2]
    return proj[..., :2] / (depth[..., None] + 1e-10), depth


def project_points(pts, intr, c2w):
    """World points -> (pixel xy (..., 2), camera depth (...,)), the
    projection of volume.py:68-79 and projector.py:529-536."""
    return cam_to_pixel(world_to_cam(pts, c2w), intr)


def project_points_all(pts, intrs, c2ws):
    """pts (N, 3); intrs/c2ws (V, 4, 4) -> (xy (V, N, 2), depth (V, N))."""
    w2cs = invert_pose(c2ws)
    cam = torch.einsum("vij,nj->vni", w2cs[:, :3, :4], to_homo(pts))
    proj = torch.einsum("vij,vnj->vni", intrs[:, :3, :3], cam)
    depth = proj[..., 2]
    xy = proj[..., :2] / (depth[..., None] + 1e-10)
    return xy, depth


def pixel_to_normalized(xy, hw, *, align_corners=True):
    """Pixel xy -> [-1, 1] normalized coords (``x / ((w-1)/2) - 1`` with
    align_corners, the reference's volume.py:73-74 convention)."""
    h, w = hw
    if align_corners:
        nx = xy[..., 0] / ((w - 1) / 2.0) - 1.0
        ny = xy[..., 1] / ((h - 1) / 2.0) - 1.0
    else:
        nx = (2.0 * xy[..., 0] + 1.0) / w - 1.0
        ny = (2.0 * xy[..., 1] + 1.0) / h - 1.0
    return torch.stack([nx, ny], dim=-1)


def in_frustum_mask(xy, depth, hw, *, inclusive=True):
    """Inside the image and in front of the camera (inclusive bounds as
    volume.py:78, half-open as projector.py:536 otherwise)."""
    h, w = hw
    x, y = xy[..., 0], xy[..., 1]
    if inclusive:
        return ((x / ((w - 1) / 2.0) - 1.0).abs() <= 1.0) & \
            ((y / ((h - 1) / 2.0) - 1.0).abs() <= 1.0) & (depth > 0)
    return (x >= 0) & (x < w) & (y >= 0) & (y < h) & (depth > 0)


def pixels_to_rays(pixels_xy, intr, c2w):
    """Pixel coordinates -> (rays_o (..., 3), unit rays_d (..., 3))."""
    p = to_homo(pixels_xy)
    cam_dirs = torch.einsum("ij,...j->...i", invert_intrinsics(intr), p)
    cam_dirs = cam_dirs / torch.linalg.norm(cam_dirs, dim=-1, keepdim=True)
    rays_d = torch.einsum("ij,...j->...i", c2w[:3, :3], cam_dirs)
    rays_o = c2w[:3, 3].expand(rays_d.shape)
    return rays_o, rays_d


def ray_z_cos(rays_d, c2w):
    """depth = z_val * (R^T d)_z for a normalized ray."""
    return torch.einsum("ji,...j->...i", c2w[:3, :3], rays_d)[..., 2]


def compute_ray_diff(pts, ref_c2w, src_c2ws):
    """IBRNet ray-direction difference: (n, s, 4) = unit diff (3) + dot (1)."""
    def _snorm(x):
        return torch.sqrt((x * x).sum(-1, keepdim=True) + 1e-12)

    ray2ref = ref_c2w[:3, 3][None, None] - pts[:, None, :]
    ray2ref = ray2ref / (_snorm(ray2ref) + 1e-6)
    ray2src = src_c2ws[None, :, :3, 3] - pts[:, None, :]
    ray2src = ray2src / (_snorm(ray2src) + 1e-6)
    diff = ray2ref - ray2src
    dot = (ray2ref * ray2src).sum(-1, keepdim=True)
    direction = diff / _snorm(diff).clamp(min=1e-6)
    return torch.cat([direction, dot], dim=-1)


def make_pixel_grid(hw, out_hw=None, *, device=None, dtype=torch.float32):
    """Pixel (x, y) grid over ``hw`` strided to ``out_hw`` by a linspace over
    the original extent: (out_h*out_w, 2).  ``j*(w-1)/(n-1)`` is exact in
    f32, so floors of these coordinates land on the reference's pixels."""
    h, w = hw
    oh, ow = out_hw if out_hw is not None else hw

    def _axis(n, extent):
        if n <= 1:
            return torch.zeros((max(n, 1),), dtype=dtype, device=device)
        j = torch.arange(n, dtype=dtype, device=device)
        return (j * float(extent - 1)) / float(n - 1)

    yy, xx = torch.meshgrid(_axis(oh, h), _axis(ow, w), indexing="ij")
    return torch.stack([xx.reshape(-1), yy.reshape(-1)], dim=-1)
