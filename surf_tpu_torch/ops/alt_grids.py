"""Alternative scene parameterizations (torch counterpart of
surf_tpu/ops/alt_grids.py; the reference's projector extras,
projector.py:423-482): a spherical (inverted-sphere background) volume
lookup through K2 and a triplane lookup through K1, both twice
differentiable (K1g / K1s, K2g / K2s)."""

from __future__ import annotations

import math

import torch

from .grid_sample import bilinear_sample_2d, trilinear_sample_3d


def equirect2sphere(pts):
    """(n, 3) xyz -> (n, 3) (theta, phi, 1/r), r clipped to >= 1
    (projector.py:423-439).  The arcsin's gradient is not finite at the
    poles (|z| / r = 1)."""
    dist = torch.linalg.norm(pts, dim=1, keepdim=True).clamp(1.0, 1e10)
    unit = pts / dist
    theta = torch.asin(unit[:, 2:3])
    phi = torch.atan2(unit[:, 1:2], unit[:, 0:1])
    return torch.cat([theta, phi, 1.0 / dist], dim=1)


def lookup_sphe_volume(sphe_pts, volume, align_corners=False):
    """A volume (X, Y, Z, C) sampled at normalized spherical coordinates
    (projector.py:441-450)."""
    theta = sphe_pts[:, 0:1] / (math.pi / 2)
    phi = sphe_pts[:, 1:2] / math.pi
    r = ((sphe_pts[:, 2:3] - 1e-10) / (1 - 1e-10) - 0.5) * 2
    return trilinear_sample_3d(volume, torch.cat([theta, phi, r], dim=1),
                               align_corners=align_corners)


def lookup_triplane(pts, triplanes, align_corners=False):
    """Triplane features: the sum of the xy, xz and yz plane samples of
    each entry, concatenated over the entries (projector.py:453-482).
    ``triplanes``: [{'xy', 'xz', 'yz'}: (H, W, C) planes]."""
    planes = {"xy": pts[:, :2], "xz": pts[:, 0::2], "yz": pts[:, 1:]}
    feats = []
    for tri in triplanes:
        f = None
        for k in ("xy", "xz", "yz"):
            s = bilinear_sample_2d(tri[k], planes[k], align_corners=align_corners)
            f = s if f is None else f + s
        feats.append(f)
    return torch.cat(feats, dim=-1)
