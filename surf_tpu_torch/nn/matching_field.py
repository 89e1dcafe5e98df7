"""Matching field: per-view depth maps rendered from the 1-channel density
volume, which drive the cascade's sparsification (torch counterpart of
surf_tpu/nn/matching_field.py).

Per view: a ray grid at ``img_hw / depth_res_levels[stage]``; per ray
``n_samples_depths[stage]`` z-vals in the stage's band and, after stage 0,
in the previous stage's band around the previous depth; density by K2
(align_corners=False); depth = softmax expectation of z times the ray's
z-cosine; bilinear (K1) upsampling to full resolution.
"""

from __future__ import annotations

import torch

from ..ops.grid_sample import trilinear_sample_3d, resize_bilinear_2d
from ..ops.projection import make_pixel_grid, pixels_to_rays, ray_z_cos


def _band_from_depth(pre_z_val, stage_range, near_ori, far_ori):
    near = pre_z_val - stage_range / 2.0
    far = pre_z_val + stage_range / 2.0
    near = torch.where(far > far_ori, near - (far - far_ori), near)
    far = torch.where(near < near_ori, far + (near_ori - near), far)
    return near.clamp(near_ori, far_ori), far.clamp(near_ori, far_ori)


def depth_render(rays_o, rays_d, near, far, c2w, matching_volume, n_samples,
                 *, t_rand=None):
    """near/far: (nr, k), one column per band.  ``t_rand`` (nr, 1) in
    [-0.5, 0.5) jitters the samples (None: no jitter).
    Returns (render_depth (nr,), occ_reg scalar)."""
    nr, k = near.shape
    lin = torch.linspace(0.0, 1.0, n_samples, device=near.device)
    z = near[..., None] + (far - near)[..., None] * lin
    if t_rand is not None:
        z = z + (t_rand[..., None] * (far - near)[:, :, None]) / n_samples
    z_vals = torch.sort(z.reshape(nr, k * n_samples), dim=-1).values
    pts = rays_o[:, None, :] + rays_d[:, None, :] * z_vals[..., None]
    outside = (torch.linalg.norm(pts, dim=-1) > 1.0).float()
    density = trilinear_sample_3d(matching_volume, pts, align_corners=False)[..., 0]
    weights = torch.softmax(density, dim=-1)
    render_depth = (z_vals * weights).sum(-1) * ray_z_cos(rays_d, c2w)
    occ_reg = density[:, :6].mean() + \
        (density * outside).sum() / (outside.sum() + 1e-10)
    return render_depth, occ_reg


def apply(conf_static, ipts, matching_volume, stage_idx, range_ratios,
          pre_depths=None, *, grad_views_only=False, perturb=False,
          generator=None):
    """Per-view depth maps at the stage's resolution level.
    ipts: imgs (nv, H, W, 3), intrs/c2ws (nv, 4, 4), near_fars (nv, 2),
    optional src_idx.  Returns (depths (nv, H, W), occ_regs (nv,)).
    With ``grad_views_only`` (the last stage) only the reference and
    source views {0, src_idx} are rendered; the others stay zero.

    Gradients flow only through views {0, src_idx} (matching_field.py:
    129-133 of the reference): when the volume requires grad the other
    views render value-only, outside the graph, and the two grad views
    render differentiably.  ``perturb`` jitters the grad views' samples
    with numbers drawn from ``generator``; the other views never jitter."""
    intrs, c2ws, near_fars = ipts["intrs"], ipts["c2ws"], ipts["near_fars"]
    img_h, img_w = ipts["imgs"].shape[1:3]
    dev = intrs.device
    level = conf_static["depth_res_levels"][stage_idx]
    n_samples = conf_static["n_samples_depths"][stage_idx]
    h, w = img_h // level, img_w // level
    pixels = make_pixel_grid((img_h, img_w), (h, w), device=dev)
    nv = intrs.shape[0]
    src_idx = int(ipts.get("src_idx", 0))
    grad_views = sorted({0, src_idx})

    def per_view(v, volume, t_rand):
        rays_o, rays_d = pixels_to_rays(pixels, intrs[v], c2ws[v])
        near_ori, far_ori = near_fars[v, 0], near_fars[v, 1]
        if pre_depths is not None:
            px = torch.floor(pixels[:, 0]).long()
            py = torch.floor(pixels[:, 1]).long()
            pre_z = pre_depths[v].detach()[py, px] / ray_z_cos(rays_d, c2ws[v])
            base_range = far_ori - near_ori
            near_s, far_s = _band_from_depth(
                pre_z, base_range * range_ratios[stage_idx], near_ori, far_ori)
            near_p, far_p = _band_from_depth(
                pre_z, base_range * range_ratios[stage_idx - 1], near_ori, far_ori)
            near = torch.stack([near_s, near_p], dim=-1)
            far = torch.stack([far_s, far_p], dim=-1)
        else:
            near = near_ori.expand(rays_o.shape[0], 1)
            far = far_ori.expand(rays_o.shape[0], 1)
        d, occ = depth_render(rays_o, rays_d, near, far, c2ws[v], volume,
                              n_samples, t_rand=t_rand)
        d = d.reshape(h, w)
        if level != 1:
            d = resize_bilinear_2d(d[..., None], (img_h, img_w))[..., 0]
        return d, occ

    zero_d = torch.zeros((img_h, img_w), device=dev)
    zero_o = torch.zeros((), device=dev)
    depths, occ_regs = [zero_d] * nv, [zero_o] * nv
    views = grad_views if grad_views_only else range(nv)
    if torch.is_grad_enabled() and matching_volume.requires_grad:
        with torch.no_grad():
            for v in views:
                if v not in grad_views:
                    depths[v], occ_regs[v] = per_view(v, matching_volume.detach(), None)
        views = grad_views
    for v in views:
        t_rand = None
        if perturb and v in grad_views:
            t_rand = torch.rand((h * w, 1), generator=generator, device=dev) - 0.5
        depths[v], occ_regs[v] = per_view(v, matching_volume, t_rand)
    return torch.stack(depths), torch.stack(occ_regs)
