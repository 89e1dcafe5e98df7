"""Photometric warping loss on matching-field depths (torch counterpart of
surf_tpu/losses/photometric.py): the source images are warped into the
reference view through the rendered depth map (K1, differentiable in the
coordinates by K1b), then SSIM + smooth-L1 + image-gradient smooth-L1
differences are taken, each keeping the ``topk`` lowest values across
source views per pixel and normalized by the reference mask."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.grid_sample import bilinear_sample_2d
from ..ops.projection import invert_pose, invert_intrinsics, pixel_to_normalized


def _avg_pool3(x):
    """3x3 stride-1 mean pool, no padding.  x (n, H, W, c)."""
    return F.avg_pool2d(x.permute(0, 3, 1, 2), 3, stride=1).permute(0, 2, 3, 1)


def _reflect_pad(x):
    return F.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="reflect").permute(0, 2, 3, 1)


def ssim_loss_map(x, y, mask):
    """(1 - SSIM)/2 per pixel, mask-pooled.  x, y (n, H, W, c); mask
    (n, H, W, 1)."""
    C1, C2 = 0.01 ** 2, 0.03 ** 2
    x, y, mask = _reflect_pad(x), _reflect_pad(y), _reflect_pad(mask)
    mu_x, mu_y = _avg_pool3(x), _avg_pool3(y)
    sigma_x = _avg_pool3(x ** 2) - mu_x ** 2
    sigma_y = _avg_pool3(y ** 2) - mu_y ** 2
    sigma_xy = _avg_pool3(x * y) - mu_x * mu_y
    n = (2 * mu_x * mu_y + C1) * (2 * sigma_xy + C2)
    d = (mu_x ** 2 + mu_y ** 2 + C1) * (sigma_x + sigma_y + C2)
    return _avg_pool3(mask) * ((1 - n / d) / 2).clamp(0.0, 1.0)


def smooth_l1(a, b):
    d = a - b
    ad = d.abs()
    return torch.where(ad < 1.0, 0.5 * d * d, ad - 0.5)


def _topk_lowest(x, k):
    return torch.sort(x, dim=0).values[:k]


def compute_ptloss(depth, imgs, mask_ref, intrs, c2ws, ref_idx=0, topk=2):
    """depth (H, W) rendered depth of view ``ref_idx``; imgs (nv, H, W, 3);
    mask_ref (H, W); intrs/c2ws (nv, 4, 4).  The other views, in order,
    are the sources."""
    nv, H, W, _ = imgs.shape
    ref_idx = int(ref_idx)
    others = [v for v in range(nv) if v != ref_idx]
    ref_img = imgs[ref_idx][None]
    nsrc = nv - 1
    topk = min(topk, nsrc)

    ys, xs = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=depth.device),
                            torch.arange(W, dtype=torch.float32, device=depth.device),
                            indexing="ij")
    pix = torch.stack([xs, ys, torch.ones_like(xs)], -1).reshape(-1, 3)
    cam = (pix * depth.reshape(-1, 1)) @ invert_intrinsics(intrs[ref_idx]).T
    world = cam @ c2ws[ref_idx, :3, :3].T + c2ws[ref_idx, :3, 3]
    grids, masks = [], []
    for s in others:
        w2c = invert_pose(c2ws[s])
        c = world @ w2c[:3, :3].T + w2c[:3, 3]
        proj = c @ intrs[s, :3, :3].T
        z = proj[:, 2]
        grid = pixel_to_normalized(proj[:, :2] / (z[:, None] + 1e-8), (H, W))
        grids.append(grid)
        masks.append((grid[:, 0].abs() <= 1) & (grid[:, 1].abs() <= 1) & (z > 0))
    warp_imgs = bilinear_sample_2d(imgs[others], torch.stack(grids),
                                   align_corners=True).reshape(nsrc, H, W, 3)
    mask = torch.stack(masks).reshape(nsrc, H, W, 1)

    mref = mask_ref.reshape(1, H, W, 1)
    ssim = ssim_loss_map(warp_imgs, ref_img.expand_as(warp_imgs),
                         (mask & (mref > 0.5)).float()).mean(-1, keepdim=True)
    ssim = (_topk_lowest(ssim, topk) * mref).sum() / (mref.sum() + 1e-8)
    l1 = _topk_lowest(smooth_l1(warp_imgs, ref_img).mean(-1, keepdim=True), topk)
    l1 = (l1 * mref).sum() / (mref.sum() + 1e-8)

    ref_dy = ref_img[:, :-1] - ref_img[:, 1:]
    ref_dx = ref_img[:, :, :-1] - ref_img[:, :, 1:]
    mref_y = mref[:, :-1] * mref[:, 1:]
    mref_x = mref[:, :, :-1] * mref[:, :, 1:]
    w_dy = warp_imgs[:, :-1] - warp_imgs[:, 1:]
    w_dx = warp_imgs[:, :, :-1] - warp_imgs[:, :, 1:]
    gx = _topk_lowest(smooth_l1(w_dx, ref_dx).mean(-1, keepdim=True), topk)
    gx = (gx * mref_x).sum() / (mref_x.sum() + 1e-8)
    gy = _topk_lowest(smooth_l1(w_dy, ref_dy).mean(-1, keepdim=True), topk)
    gy = (gy * mref_y).sum() / (mref_y.sum() + 1e-8)
    return l1 + gx + gy + ssim
