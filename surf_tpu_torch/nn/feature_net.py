"""Multi-scale FPN image encoder (torch counterpart of
surf_tpu/nn/feature_net.py): 4 encoder stages (stride 1, 2, 2, 2; two
3x3 conv + InstanceNorm + ReLU blocks each), a transposed-conv decoder
with additive skips and a bias-free 3x3 head per stage.  Images are
channel-last (nv, H, W, 3); the output maps run low-res -> high-res."""

from __future__ import annotations

from .core import (conv_init, conv2d_apply, conv2d_transpose_apply,
                   instance_norm_2d, relu)


def init(gen, conf, device=None):
    d_in = conf.get_int("d_in")
    d_base = conf.get_int("d_base")
    d_outs = conf.get_list("d_out")
    params = {"encoder": [], "decoder": [], "out": []}
    c_in = d_in
    for i in range(len(d_outs)):
        dim_m = d_base * 2 ** i
        params["encoder"].append({"c0": conv_init(gen, c_in, dim_m, 3, 2, device),
                                  "c1": conv_init(gen, dim_m, dim_m, 3, 2, device)})
        c_in = dim_m
        params["out"].append(conv_init(gen, dim_m, d_outs[i], 3, 2, device))
        if i < len(d_outs) - 1:
            params["decoder"].append(
                conv_init(gen, d_base * 2 ** (i + 1), d_base * 2 ** i, 3, 2, device))
    return params


def _block(p, x, stride=1):
    return relu(instance_norm_2d(conv2d_apply(p, x, stride=stride)))


def apply(params, images):
    """images (nv, H, W, 3) -> [(nv, h_s, w_s, c)] low-res -> high-res."""
    n = len(params["encoder"])
    x = images
    e_outs = []
    for i in range(n):
        x = _block(params["encoder"][i]["c0"], x, stride=2 if i > 0 else 1)
        x = _block(params["encoder"][i]["c1"], x)
        e_outs.append(x)
    d_outs = [e_outs[-1]]
    for i in range(n - 2, -1, -1):
        up = relu(instance_norm_2d(conv2d_transpose_apply(
            params["decoder"][i], d_outs[-1], stride=2, padding=1,
            output_padding=1)))
        d_outs.append(up + e_outs[i])
    d_outs = d_outs[::-1]
    outs = [conv2d_apply(params["out"][i], d_outs[i]) for i in range(n)]
    return outs[::-1]
