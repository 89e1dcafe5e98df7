"""NeuS renderer over the sparse volume cascade (torch counterpart of
surf_tpu/nn/implicit_surface.py).

* ``build_z_vals``: n_samples[0] uniform samples over [near, far] plus
  surface-centric bands around the softmax-expected surface of a
  256-sample density pre-render of the matching volume (K2);
* ``render_core``: the SDF MLP with grad and H.1 (K3 + autograd), the
  occupancy mask from the same K3 launch (SDF pinned to 100 outside),
  the colour fetch (K1) and blending, NeuS alpha compositing and the
  first zero crossing; given patch features (training), the homography
  patch warp at the crossing for the NCC loss.  In training the SDF
  outputs, grad and H.1 keep their graph to the parameters and the stage
  storages.
"""

from __future__ import annotations

import torch

from . import core, sdf_net, blending_net, variance
from ..ops.grid_sample import trilinear_sample_3d, resize_bilinear_2d
from ..ops.feature_lookup import lookup_feature, lookup_feature_fused, fuse_pyramid
from ..ops.homography import surface_patch_warp


def init(gen, conf, device=None):
    sdf_p, sdf_static = sdf_net.init(gen, conf["sdf_network"], device)
    blend_p, blend_static = blending_net.init(gen, conf["color_network"], device)
    params = {"sdf_network": sdf_p, "color_network": blend_p,
              "deviation_network": variance.init(conf["variance_network"], device)}
    static = {
        "sdf": sdf_static,
        "blend": blend_static,
        "n_samples": conf.get_list("render.n_samples"),
        "sample_ranges": conf.get_list("render.sample_ranges"),
        "n_depth": conf.get_int("render.n_depth"),
        "perturb": conf.get_float("render.perturb"),
        "fused_pyramid": conf.get_bool("render.fused_pyramid", default=True),
    }
    return params, static


def _safe_norm(x, dim=-1, keepdim=False, eps=1e-12):
    return torch.sqrt((x * x).sum(dim, keepdim=keepdim) + eps)


def _band(center, half_range, near, far):
    lo, hi = center - half_range, center + half_range
    lo = torch.where(hi > far, lo - (hi - far), lo)
    hi = torch.where(lo < near, hi + (near - lo), hi)
    return torch.minimum(torch.maximum(lo, near), far), \
        torch.minimum(torch.maximum(hi, near), far)


def build_z_vals(static, rays_o, rays_d, near, far, matching_volume,
                 generator=None):
    """near/far (nr, 1) -> sorted z_vals (nr, sum(n_samples)).  Jitter
    (``render.perturb`` > 0) is drawn from ``generator``; None disables it."""
    n0 = static["n_samples"][0]
    nr = rays_o.shape[0]
    dev = rays_o.device
    jitter = generator is not None and static["perturb"] > 0
    z_uniform = near + (far - near) * torch.linspace(0.0, 1.0, n0, device=dev)[None]
    if jitter:
        t = torch.rand((nr, 1), generator=generator, device=dev) - 0.5
        z_uniform = z_uniform + t * 2.0 / n0
    z_all = [z_uniform]

    base_range = far - near
    z_d = near + (far - near) * torch.linspace(0.0, 1.0, static["n_depth"],
                                               device=dev)[None]
    pts = rays_o[:, None, :] + rays_d[:, None, :] * z_d[..., None]
    # the surface localization carries no gradient
    density = trilinear_sample_3d(matching_volume.detach(), pts,
                                  align_corners=False)[..., 0]
    surf_z = (z_d * torch.softmax(density, dim=-1)).sum(-1, keepdim=True)
    for ratio, ns in zip(static["sample_ranges"][1:], static["n_samples"][1:]):
        lo, hi = _band(surf_z, base_range * ratio, near, far)
        z_s = lo + (hi - lo) * torch.linspace(0.0, 1.0, ns, device=dev)[None]
        if jitter:
            t = torch.rand((nr, 1), generator=generator, device=dev) - 0.5
            z_s = z_s + t * (hi - lo) / ns
        z_all.append(z_s)
    return torch.sort(torch.cat(z_all, dim=-1), dim=-1).values


def prepare_patch_features(features, match_features, step):
    """Per-scene patch-warp feature image, outside the graph: the 3 finest
    maps upsampled to full resolution and concatenated, from the frozen
    matching feature network from step 2 on (implicit_surface.py:230-243
    of the reference).  Maps are finest-first."""
    def cat3(maps):
        hw = maps[0].shape[1:3]
        return torch.cat([maps[0]] + [resize_bilinear_2d(m, hw) for m in maps[1:3]], -1)

    with torch.no_grad():
        use_live = match_features is None or step is None or step < 2
        return cat3(features if use_live else match_features)


def neus_alpha_weights(sdf, gradients, dirs, dists, pts, vmask_f, inv_s,
                       cos_anneal_ratio):
    """NeuS section alpha with the annealed cos, cumprod transmittance and
    the sphere masks.  Returns (alpha, weights, inside_sphere,
    relax_inside), each (nr, ns)."""
    nr, ns = dists.shape
    true_cos = (dirs * gradients).sum(-1, keepdim=True)
    iter_cos = -(torch.relu(-true_cos * 0.5 + 0.5) * (1.0 - cos_anneal_ratio)
                 + torch.relu(-true_cos) * cos_anneal_ratio)
    iter_cos = (iter_cos * vmask_f[:, None]).clamp(-10.0, 10.0)
    d_flat = dists.reshape(-1, 1)
    est_next = sdf + iter_cos * d_flat * 0.5
    est_prev = sdf - iter_cos * d_flat * 0.5
    prev_cdf = torch.sigmoid(est_prev * inv_s)
    next_cdf = torch.sigmoid(est_next * inv_s)
    alpha = ((prev_cdf - next_cdf + 1e-5) / (prev_cdf + 1e-5)).clamp(0.0, 1.0)
    vm = vmask_f.reshape(nr, ns)
    alpha = alpha.reshape(nr, ns) * vm
    pts_norm = torch.linalg.norm(pts, dim=-1).reshape(nr, ns)
    inside_sphere = (pts_norm < 1.0).float() * vm
    relax_inside = (pts_norm < 1.2).float() * vm
    trans = torch.cumprod(torch.cat([torch.ones((nr, 1), device=alpha.device),
                                     1.0 - alpha + 1e-7], dim=-1), dim=-1)[:, :-1]
    return alpha, alpha * trans, inside_sphere, relax_inside


def neus_zero_crossing(sdf, grads_rs, mid_z, vmask_f, inside_sphere, ray_cos):
    """First SDF sign change per ray with the sphere and gradient-cos > 0.5
    gates; linear interpolation of z at sdf = 0.
    Returns (mid_inside (nr, 1), z_sdf0 (nr, 1), sdf_depth (nr, 1))."""
    nr, ns = mid_z.shape
    sdf_d = sdf.reshape(nr, ns)
    vm = vmask_f.reshape(nr, ns)
    pair_valid = (vm[:, :-1] * vm[:, 1:]) > 0
    sign = (sdf_d[:, :-1] * sdf_d[:, 1:] <= 0).float() * pair_valid
    idx_desc = torch.arange(ns - 1, 0, -1, dtype=torch.float32, device=sdf.device)[None]
    tmp = sign * idx_desc
    prev_idx = torch.argmax(tmp, dim=1, keepdim=True)
    next_idx = prev_idx + 1
    has_cross = (tmp.sum(-1, keepdim=True) > 0).float()

    def take(a, i):
        return torch.gather(a, 1, i)

    mid_inside = ((0.5 * (take(inside_sphere, prev_idx) + take(inside_sphere, next_idx)))
                  > 0.5).float() * has_cross
    g1 = torch.gather(grads_rs, 1, prev_idx[..., None].expand(-1, -1, 3))[:, 0]
    g2 = torch.gather(grads_rs, 1, next_idx[..., None].expand(-1, -1, 3))[:, 0]
    cos_d = (g1 * g2).sum(-1) / (torch.linalg.norm(g1, dim=-1)
                                 * torch.linalg.norm(g2, dim=-1) + 1e-8)
    mid_inside = mid_inside * (cos_d[:, None] > 0.5)
    sdf1, sdf2 = take(sdf_d, prev_idx), take(sdf_d, next_idx)
    z1, z2 = take(mid_z, prev_idx), take(mid_z, next_idx)
    denom = sdf1 - sdf2
    tiny = torch.where(denom < 0, torch.full_like(denom, -1e-6),
                       torch.full_like(denom, 1e-6))
    denom = torch.where(denom.abs() < 1e-6, tiny, denom)
    z_sdf0 = (sdf1 * z2 - sdf2 * z1) / denom
    return mid_inside, z_sdf0, z_sdf0 * ray_cos[:, None] * mid_inside


def _needs_graph(tree, stages):
    """Whether the SDF outputs must keep their graph: grad is on and a
    parameter or a stage storage requires it (training)."""
    return torch.is_grad_enabled() and any(
        t.requires_grad for t in core.tree_leaves(tree) + [s for _, s in stages])


def render_core(params, static, rays_o, rays_d, z_vals, sample_dist, stages,
                features, imgs, intrs, c2ws, cos_anneal_ratio,
                fused_colors=None, generator=None, warp_feats=None,
                pts_random=None):
    """stages: [(VoxelGrid, storage (P*8, C))] fine-to-coarse; features:
    FPN maps finest-first; warp_feats: ``prepare_patch_features`` output,
    or None to skip the patch warp (the reference's ref_gray_val /
    sampled_gray_val, which only the training loss reads); pts_random:
    the 1024 random SDF probe points, drawn from ``generator`` if None."""
    nr, ns = z_vals.shape
    sdf_p, sdf_s = params["sdf_network"], static["sdf"]
    dev = z_vals.device
    dists = torch.cat([z_vals[:, 1:] - z_vals[:, :-1],
                       torch.full((nr, 1), sample_dist, device=dev)], dim=-1)
    mid_z = z_vals + dists * 0.5
    pts = (rays_o[:, None, :] + rays_d[:, None, :] * mid_z[..., None]).reshape(-1, 3)
    dirs = rays_d[:, None, :].expand(nr, ns, 3).reshape(-1, 3)

    # SDF, features, grad and H.1, and the visibility mask, from one K3
    # launch per pass; pinned to +100 outside the active set
    sdf_out, grads_all, smooth_all, vmask = sdf_net.value_features_grads_occ(
        sdf_p, sdf_s, pts, stages, create_graph=_needs_graph(sdf_p, stages))
    vmask_f = vmask.float()
    sdf = torch.where(vmask[:, None], sdf_out[:, :1], torch.full_like(sdf_out[:, :1], 100.0))
    gradients = grads_all * vmask_f[:, None]
    smooth = smooth_all * vmask_f[:, None]

    if fused_colors is not None:
        hw_levels = [f.shape[1:3] for f in features]
        rgb_feat, ray_diff, src_mask = lookup_feature_fused(
            pts, fused_colors, intrs, c2ws, hw_levels)
    else:
        rgb_feat, ray_diff, src_mask = lookup_feature(pts, imgs, intrs, c2ws, features)
    sampled_color = blending_net.apply(params["color_network"], static["blend"],
                                       rgb_feat, ray_diff, src_mask)
    sampled_color = (sampled_color * vmask_f[:, None]).reshape(nr, ns, 3)
    src_seen = (src_mask & vmask[:, None]).sum(-1).reshape(nr, ns)
    valid_mask = (src_seen > 1).float().sum(-1, keepdim=True) > 8

    inv_s = variance.inv_s(params["deviation_network"]).clamp(1e-6, 1e6)
    alpha, weights, inside_sphere, relax_inside = neus_alpha_weights(
        sdf, gradients, dirs, dists, pts, vmask_f, inv_s, cos_anneal_ratio)

    color = (sampled_color * weights[..., None]).sum(1)
    grads_rs = gradients.reshape(nr, ns, 3)
    rot = c2ws[0, :3, :3].T
    normal = (grads_rs * weights[..., None]).sum(1) @ rot.T
    ray_cos = (rays_d @ rot.T)[:, 2]
    render_depth = (mid_z * weights).sum(-1) * ray_cos

    gradient_error = (((_safe_norm(grads_rs) - 1.0) ** 2 * relax_inside).sum()
                      / (relax_inside.sum() + 1e-5))
    smooth_error = ((_safe_norm(smooth).reshape(nr, ns) * inside_sphere).sum()
                    / (inside_sphere.sum() + 1e-5))

    # random sparse-SDF sample (reference lines 174-178)
    if pts_random is None:
        pts_random = torch.rand((1024, 3), generator=generator, device=dev) * 2.0 - 1.0
    rnd_out, rnd_mask = sdf_net.apply_occ(sdf_p, sdf_s, pts_random, stages)
    sdf_random = rnd_out[:, :1] * rnd_mask[:, None].float()

    mid_inside, z_sdf0, sdf_depth = neus_zero_crossing(
        sdf, grads_rs, mid_z, vmask_f, inside_sphere, ray_cos)
    warp = {}
    if warp_feats is not None:
        # patch warp at the first zero crossing (reference lines 218-237):
        # differentiable through the crossing's depth, with the normal
        # (from a detached SDF pass) and the patch features held fixed
        z0 = torch.where((z_sdf0 < 0) | (z_sdf0 > z_vals.max()),
                         torch.zeros_like(z_sdf0), z_sdf0)
        pts_sdf0 = rays_o + rays_d * z0
        detached = [(g, st.detach()) for g, st in stages]
        sdf_p0 = {"layers": [{k: v.detach() for k, v in lin.items()}
                             for lin in sdf_p["layers"]]}
        grad0, _ = sdf_net.gradient(sdf_p0, sdf_s, pts_sdf0.detach(), detached)
        gnorm = torch.linalg.norm(grad0, dim=-1, keepdim=True)
        grad0 = grad0 / torch.where(gnorm <= 0, torch.full_like(gnorm, 1e-8), gnorm)
        normal0 = (grad0 @ c2ws[0, :3, :3]).detach()
        warp["ref_gray_val"], warp["sampled_gray_val"] = surface_patch_warp(
            pts_sdf0, normal0, warp_feats, intrs, c2ws)
    return {
        **warp,
        "mid_inside_sphere": mid_inside,
        "smooth_error": smooth_error,
        "color_fine": color,
        "render_depth": render_depth,
        "valid_mask": valid_mask,
        "sparse_sdf": torch.cat([sdf_random, sdf]),
        "mid_z_vals": mid_z.detach(),
        "gradients": grads_rs,
        "normal": normal,
        "s_val": 1.0 / inv_s,
        "weights": weights,
        "weight_sum": weights.sum(-1, keepdim=True),
        "weight_max": weights.max(-1, keepdim=True).values,
        "gradient_error": gradient_error,
        "inside_sphere": inside_sphere,
        "sdf_depth": sdf_depth,
    }


def render(params, static, rays_o, rays_d, near, far, matching_volume, stages,
           features, imgs, intrs, c2ws, cos_anneal_ratio=1.0, fused_colors=None,
           generator=None, *, match_features=None, step=None, warp_feats=None,
           pts_random=None):
    """Surface-centric z-vals then ``render_core``.  ``generator`` drives
    the z jitter (``render.perturb``) and the random SDF probe; None means
    no jitter.  Callers rendering many chunks pass ``fuse_pyramid`` once.
    Training passes ``match_features`` and ``step`` (or ``warp_feats``):
    the patch warp for the NCC loss runs only then."""
    params = core.materialize_weight_norm(params)
    if near.shape[0] == 1:
        near = near.expand(rays_o.shape[0], 1)
        far = far.expand(rays_o.shape[0], 1)
    if fused_colors is None and static.get("fused_pyramid", False):
        fused_colors = fuse_pyramid(imgs, features)
    if warp_feats is None and match_features is not None:
        warp_feats = prepare_patch_features(features, match_features, step)
    z_vals = build_z_vals(static, rays_o, rays_d, near, far, matching_volume,
                          generator)
    return render_core(params, static, rays_o, rays_d, z_vals,
                       2.0 / static["n_samples"][0], stages, features, imgs,
                       intrs, c2ws, cos_anneal_ratio, fused_colors=fused_colors,
                       generator=generator, warp_feats=warp_feats,
                       pts_random=pts_random)


def pseudo_sdf(params, static, pseudo_pts, stages):
    """|SDF| supervision at the pseudo points (implicit_surface.py:425-434
    of the reference): the SDF there, zero outside the active set."""
    sdf_p = core.materialize_weight_norm(params)["sdf_network"]
    out, occ = sdf_net.apply_occ(sdf_p, static["sdf"], pseudo_pts, stages)
    return out[:, :1] * occ[:, None].float()
