"""IBRNet-style cross-view colour blending head (torch counterpart of
surf_tpu/nn/blending_net.py): ray-direction-difference MLP added to the
per-view features, anti-alias pooling weights exp(|s| (dot - 1)),
weighted mean/variance across source views, two visibility MLPs and a
softmax blend of the source-view RGBs."""

from __future__ import annotations

import torch

from .core import linear_init, linear_apply, elu, kaiming_normal


def _mlp_init(gen, dims, device, kaiming=True):
    out = []
    for i in range(len(dims) - 1):
        if kaiming:
            out.append(linear_init(
                gen, dims[i], dims[i + 1], device=device,
                w_init=lambda g, shape: kaiming_normal(g, shape, shape[0], device),
                b_init=lambda g, shape: torch.zeros(shape, device=device)))
        else:
            out.append(linear_init(gen, dims[i], dims[i + 1], device=device))
    return out


def init(gen, conf, device=None):
    d_feature = conf.get_int("d_feature", default=16)
    anti_alias_pooling = conf.get_bool("anti_alias_pooling", default=True)
    params = {
        "ray_dir_fc": _mlp_init(gen, [4, 16, d_feature + 3], device, kaiming=False),
        "base_fc": _mlp_init(gen, [(d_feature + 3) * 3, 64, 32], device),
        "vis_fc": _mlp_init(gen, [32, 32, 33], device),
        "vis_fc2": _mlp_init(gen, [32, 32, 1], device),
        "rgb_fc": _mlp_init(gen, [32 + 1 + 4, 16, 8, 1], device),
    }
    if anti_alias_pooling:
        params["s"] = torch.tensor(0.2, device=device)
    return params, {"anti_alias_pooling": anti_alias_pooling}


def _seq(layers, x, elu_all=False):
    for i, p in enumerate(layers):
        x = linear_apply(p, x)
        if i < len(layers) - 1 or elu_all:
            x = elu(x)
    return x


def apply(params, static, rgb_feat, ray_diff, mask):
    """rgb_feat (n, nsrc, 3 + c), ray_diff (n, nsrc, 4), mask (n, nsrc)
    bool -> blended rgb (n, 3)."""
    rgb_in = rgb_feat[..., :3]
    m = mask[..., None].to(rgb_feat.dtype)
    num_views = rgb_feat.shape[1]
    rgb_feat = rgb_feat + _seq(params["ray_dir_fc"], ray_diff, elu_all=True)
    if static["anti_alias_pooling"]:
        exp_dot = torch.exp(params["s"].abs() * (ray_diff[..., 3:4] - 1.0))
        weight = (exp_dot - exp_dot.min(dim=1, keepdim=True).values) * m
        weight = weight / (weight.sum(1, keepdim=True) + 1e-8)
    else:
        weight = m / (m.sum(1, keepdim=True) + 1e-8)
    mean = (rgb_feat * weight).sum(1, keepdim=True)
    var = (weight * (rgb_feat - mean) ** 2).sum(1, keepdim=True)
    globalfeat = torch.cat([mean, var], dim=-1)
    x = torch.cat([globalfeat.expand(-1, num_views, -1), rgb_feat], dim=-1)
    x = _seq(params["base_fc"], x, elu_all=True)
    x_vis = _seq(params["vis_fc"], x * weight, elu_all=True)
    x_res, vis = x_vis[..., :-1], x_vis[..., -1:]
    vis = torch.sigmoid(vis) * m
    x = x + x_res
    vis = torch.sigmoid(_seq(params["vis_fc2"], x * vis)) * m
    x = _seq(params["rgb_fc"], torch.cat([x, vis, ray_diff], dim=-1))
    x = torch.where(m == 0, torch.full_like(x, -1e9), x)
    return (rgb_in * torch.softmax(x, dim=1)).sum(1)
