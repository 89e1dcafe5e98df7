"""Multi-scale FPN image encoder (torch counterpart of
surf_tpu/nn/feature_net.py): 4 encoder stages (stride 1, 2, 2, 2; two
3x3 conv + InstanceNorm + ReLU blocks each), a transposed-conv decoder
with additive skips and a bias-free 3x3 head per stage.  Images are
channel-last (nv, H, W, 3); the output maps run low-res -> high-res.

``init_legacy`` / ``apply_legacy``: the reference's unused 3-scale
FeatureNetworkOld (feature_network.py:78-123), its upsampling through K1
(``resize_bilinear_2d``, batched over views)."""

from __future__ import annotations

from .core import (conv_init, conv2d_apply, conv2d_transpose_apply,
                   instance_norm_2d, relu)
from ..ops.grid_sample import resize_bilinear_2d


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


def init_legacy(gen, conf, device=None):
    """The 3-scale FPN (FeatureNetworkOld): a stride-1 conv0 encoder, 5x5
    stride-2 downsamplers, lateral 3x3 inner convs, bilinear upsampling and
    three ``d_out`` heads, all bias-free."""
    d_base = conf.get_int("d_base")
    d_out = conf.get_list("d_out")[0] if isinstance(conf.get("d_out"), list) \
        else conf.get_int("d_out")

    def c(ci, co, k=3):
        return conv_init(gen, ci, co, k, 2, device)
    return {"conv0": [c(3, d_base), c(d_base, d_base)],
            "conv1": [c(d_base, d_base * 2, 5), c(d_base * 2, d_base * 2),
                      c(d_base * 2, d_base * 2)],
            "conv2": [c(d_base * 2, d_base * 4, 5), c(d_base * 4, d_base * 4),
                      c(d_base * 4, d_base * 4)],
            "out2": c(d_base * 4, d_out), "out1": c(d_base * 4, d_out),
            "out0": c(d_base * 4, d_out), "inner1": c(d_base * 2, d_base * 4),
            "inner0": c(d_base, d_base * 4)}


def apply_legacy(params, images):
    """images (nv, H, W, 3) -> [out2 (1/4), out1 (1/2), out0 (1/1)]."""
    def seq(blocks, x, strides):
        for p, s in zip(blocks, strides):
            x = _block(p, x, stride=s)
        return x

    feat0 = seq(params["conv0"], images, [1, 1])
    feat1 = seq(params["conv1"], feat0, [2, 1, 1])
    feat2 = seq(params["conv2"], feat1, [2, 1, 1])
    out2 = conv2d_apply(params["out2"], feat2)
    intra = resize_bilinear_2d(feat2, feat1.shape[1:3], align_corners=True) + \
        conv2d_apply(params["inner1"], feat1)
    out1 = conv2d_apply(params["out1"], intra)
    intra = resize_bilinear_2d(intra, feat0.shape[1:3], align_corners=True) + \
        conv2d_apply(params["inner0"], feat0)
    return [out2, out1, conv2d_apply(params["out0"], intra)]
