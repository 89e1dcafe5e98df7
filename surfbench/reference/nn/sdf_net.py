"""Volume-conditioned SDF MLP with geometric initialization (torch
counterpart of surf_tpu/nn/sdf_net.py).

* positional encoding (multires) of xyz; the stage features (K3, fine to
  coarse) appended to every hidden layer; a skip re-injecting the
  embedded input at layer 3 divided by sqrt(2); Softplus(beta=100,
  threshold 20); weight norm on every linear;
* geometric init: the last layer ~ N(sqrt(pi)/sqrt(fan_in), 1e-4) with
  bias -0.5, so a random model's SDF is about a unit sphere; all
  feature-channel input columns start at zero.

Output (n, d_out): the SDF (divided by ``scale``) then the features.
``gradient`` / ``value_features_grads`` give grad(sdf) and H.1 through
autograd of K3's ``SparseTrilinear``; with ``create_graph`` (training)
all three outputs stay differentiable with respect to the parameters and
the stage storages (the eikonal term reads grad(sdf), the smoothness
term H.1).
"""

from __future__ import annotations

import math

import torch

from .core import linear_apply, softplus_beta
from ..ops.embedder import embedder
from ..ops.sparse import stage_features


def init(gen, conf, device=None):
    d_in = conf.get_int("d_in")
    d_out = conf.get_int("d_out")
    d_hidden = conf.get_int("d_hidden")
    n_layers = conf.get_int("n_layers")
    skip_in = tuple(conf.get_list("skip_in"))
    multires = conf.get_int("multires")
    bias = conf.get_float("bias")
    scale = conf.get_float("scale")
    geometric_init = conf.get_bool("geometric_init")
    weight_norm = conf.get_bool("weight_norm")
    feat_channels = conf.get_int("feat_channels")
    feat_multires = conf.get_int("feat_multires", default=0)
    inside_outside = conf.get_bool("inside_outside", default=False)

    _, d_embed = embedder(multires, d_in)
    _, feat_ch = embedder(feat_multires, feat_channels)
    dims = [d_embed] + [d_hidden + feat_ch] * n_layers + [d_out]
    num_layers = len(dims)

    def normal(shape, std):
        return torch.randn(shape, generator=gen, device=device) * std

    layers = []
    for l in range(num_layers - 1):
        out_dim = dims[l + 1] - dims[0] if l + 1 in skip_in else dims[l + 1]
        if l < num_layers - 2:
            out_dim -= feat_ch
        in_dim = dims[l]
        if geometric_init:
            if l == num_layers - 2:
                sign = -1.0 if inside_outside else 1.0
                w = sign * math.sqrt(math.pi) / math.sqrt(in_dim) + \
                    normal((in_dim, out_dim), 1e-4)
                b = torch.full((out_dim,), -sign * bias, device=device)
                w[-feat_ch:, :] = 0.0
                b[-feat_ch:] = 0.0
            elif multires > 0 and l == 0:
                w = torch.zeros((in_dim, out_dim), device=device)
                w[:3, :] = normal((3, out_dim), math.sqrt(2) / math.sqrt(out_dim))
                b = torch.zeros((out_dim,), device=device)
            elif multires > 0 and l in skip_in:
                w = normal((in_dim, out_dim), math.sqrt(2) / math.sqrt(out_dim))
                w[-(dims[0] - 3 + feat_ch):, :] = 0.0
                b = torch.zeros((out_dim,), device=device)
            else:
                w = normal((in_dim, out_dim), math.sqrt(2) / math.sqrt(out_dim))
                w[-feat_ch:, :] = 0.0
                b = torch.zeros((out_dim,), device=device)
        else:
            w = normal((in_dim, out_dim), 1.0 / math.sqrt(in_dim))
            b = torch.zeros((out_dim,), device=device)
        layers.append({"v": w, "g": torch.linalg.norm(w, dim=0), "b": b}
                      if weight_norm else {"w": w, "b": b})

    static = {"skip_in": skip_in, "scale": scale, "multires": multires,
              "feat_multires": feat_multires, "feat_channels": feat_channels,
              "num_layers": num_layers}
    return {"layers": layers}, static


def mlp(params, static, pts, feats):
    """The MLP on points (n, 3) and their stage features (n, F)."""
    if static["feat_multires"] > 0:
        fe, _ = embedder(static["feat_multires"], static["feat_channels"])
        feats = fe(feats)
    x_in = pts * static["scale"]
    if static["multires"] > 0:
        embed_fn, _ = embedder(static["multires"], pts.shape[-1])
        x_in = embed_fn(x_in)
    x = x_in
    num_layers = static["num_layers"]
    for l, lin in enumerate(params["layers"]):
        if l in static["skip_in"]:
            x = torch.cat([x, x_in], dim=-1) / math.sqrt(2)
        if 0 < l < num_layers - 1:
            x = torch.cat([x, feats], dim=-1)
        x = linear_apply(lin, x)
        if l < num_layers - 2:
            x = softplus_beta(x)
    return torch.cat([x[:, :1] / static["scale"], x[:, 1:]], dim=-1)


def apply_occ(params, static, pts, stages):
    """pts (n, 3) -> ((n, d_out), nearest occupancy (n,)) in one K3 launch."""
    feats, occ = stage_features(stages, pts)
    return mlp(params, static, pts, feats), occ


def apply(params, static, pts, stages):
    """pts (n, 3) -> (n, d_out): [sdf, geometry features]."""
    return apply_occ(params, static, pts, stages)[0]


def sdf_only(params, static, pts, stages):
    return apply(params, static, pts, stages)[:, :1]


def value_features_grads_occ(params, static, pts, stages, *, create_graph=False):
    """(out (n, d_out), grad sdf (n, 3), H.1 (n, 3), occupancy (n,)):
    grad = d sum(sdf)/d pts with the graph kept, H.1 = d (grad . 1)/d pts
    (H is symmetric); per point, since points do not interact.  With
    ``create_graph`` the outputs keep their graph (training); otherwise
    they are detached."""
    with torch.enable_grad():
        p = pts.detach().requires_grad_(True)
        out, occ = apply_occ(params, static, p, stages)
        g, = torch.autograd.grad(out[:, 0].sum(), p, create_graph=True)
        h, = torch.autograd.grad(g, p, torch.ones_like(g), create_graph=create_graph)
    if create_graph:
        return out, g, h, occ
    return out.detach(), g.detach(), h.detach(), occ


def value_features_grads(params, static, pts, stages):
    """(out (n, d_out), grad sdf (n, 3), H.1 (n, 3)), detached."""
    return value_features_grads_occ(params, static, pts, stages)[:3]


def gradient(params, static, pts, stages):
    """(grad sdf (n, 3), H.1 (n, 3)), detached."""
    return value_features_grads(params, static, pts, stages)[1:]
