"""IDR-style per-point colour MLP (torch counterpart of
surf_tpu/nn/rendering_net.py; the reference's switchable colour head,
rendering_network.py:9-86): modes 'idr' (points, view directions,
normals), 'no_view_dir' and 'no_normal'; the geometry features appended
to every hidden layer; weight-norm linears folded as ``core._fold`` does;
an optional positional encoding of the view direction; a sigmoid output."""

from __future__ import annotations

import math

import torch

from .core import linear_apply
from ..ops.embedder import embedder


def init(gen, conf, device=None):
    """-> (params {"layers": [...]}, static)."""
    d_feature = conf.get_int("d_feature")
    mode = conf.get_string("mode", default="idr")
    d_hidden = conf.get_int("d_hidden")
    n_layers = conf.get_int("n_layers")
    skip_in = tuple(conf.get_list("skip_in", default=[2]))
    weight_norm = conf.get_bool("weight_norm", default=True)
    multires_view = conf.get_int("multires_view", default=0)
    dims = [conf.get_int("d_in")] + [d_hidden + d_feature] * n_layers + [conf.get_int("d_out")]
    if multires_view > 0:
        dims[0] += embedder(multires_view, 3)[1] - 3
    num_layers = len(dims)
    layers = []
    for l in range(num_layers - 1):
        out_dim = dims[l + 1] - dims[0] if l + 1 in skip_in else dims[l + 1]
        if l < num_layers - 2:
            out_dim -= d_feature
        w = torch.randn((dims[l], out_dim), generator=gen, device=device) / math.sqrt(dims[l])
        b = torch.zeros(out_dim, device=device)
        layers.append({"v": w, "g": torch.linalg.norm(w, dim=0), "b": b} if weight_norm
                      else {"w": w, "b": b})
    static = {"mode": mode, "skip_in": skip_in, "multires_view": multires_view,
              "squeeze_out": conf.get_bool("squeeze_out", default=True),
              "num_layers": num_layers}
    return {"layers": layers}, static


def apply(params, static, points, normals, view_dirs, feature_vectors):
    if static["multires_view"] > 0:
        view_dirs = embedder(static["multires_view"], 3)[0](view_dirs)
    inputs = {"idr": (points, view_dirs, normals), "no_view_dir": (points, normals),
              "no_normal": (points, view_dirs)}
    if static["mode"] not in inputs:
        raise ValueError(static["mode"])
    x_in = torch.cat(inputs[static["mode"]], dim=-1)
    x, n = x_in, static["num_layers"]
    for l, lin in enumerate(params["layers"]):
        if l in static["skip_in"]:
            x = torch.cat([x, x_in], dim=-1) / math.sqrt(2)
        if 0 < l < n - 1:
            x = torch.cat([x, feature_vectors], dim=-1)
        x = linear_apply(lin, x)
        if l < n - 2:
            x = torch.relu(x)
    return torch.sigmoid(x) if static["squeeze_out"] else x
