"""MNASNet-backed 5-level feature pyramid (torch counterpart of
surf_tpu/nn/feature_net_mnasnet.py; the reference's unused
feature_network_mnasnet.py:52-103).

The MNASNet-1.0 trunk written out (torchvision is not a dependency): a
stem (3->32 stride 2, depthwise 3x3, 1x1 -> 16) and six inverted-residual
stacks, batch norm in inference form (eps 1e-5), depthwise convs through
``conv2d_apply(groups=C)``; a transposed-conv FPN decoder with additive
skips and bias-free 3x3 heads.  Channel-last activations; the parameter
tree is the JAX package's."""

from __future__ import annotations

import torch

from .core import (conv_init, conv2d_apply, conv2d_transpose_apply, instance_norm_2d,
                   kaiming_uniform_torch, relu)

# (c_out, kernel, stride, expansion, repeats) of each inverted-residual stack
_STACKS = [
    (24, 3, 2, 3, 3),
    (40, 5, 2, 3, 3),
    (80, 5, 2, 6, 3),
    (96, 3, 1, 6, 2),
    (192, 5, 2, 6, 4),
    (320, 3, 1, 6, 1),
]


def _bn_init(c, device):
    return {"scale": torch.ones(c, device=device), "bias": torch.zeros(c, device=device),
            "mean": torch.zeros(c, device=device), "var": torch.ones(c, device=device)}


def _bn_apply(p, x, eps=1e-5):
    return (x - p["mean"]) * torch.rsqrt(p["var"] + eps) * p["scale"] + p["bias"]


def _dw_init(gen, c, k, device):
    # depthwise kernel (k, k, 1, c)
    return {"w": kaiming_uniform_torch(gen, (k, k, 1, c), k * k, device)}


def _dw_apply(p, x, *, stride=1):
    return conv2d_apply(p, x, stride=stride, groups=x.shape[-1])


def _ir_init(gen, c_in, c_out, k, expansion, device):
    mid = c_in * expansion
    return {"expand": conv_init(gen, c_in, mid, 1, 2, device), "bn1": _bn_init(mid, device),
            "dw": _dw_init(gen, mid, k, device), "bn2": _bn_init(mid, device),
            "project": conv_init(gen, mid, c_out, 1, 2, device),
            "bn3": _bn_init(c_out, device)}


def _ir_apply(p, x, *, stride):
    y = relu(_bn_apply(p["bn1"], conv2d_apply(p["expand"], x)))
    y = relu(_bn_apply(p["bn2"], _dw_apply(p["dw"], y, stride=stride)))
    y = _bn_apply(p["bn3"], conv2d_apply(p["project"], y))
    if stride == 1 and x.shape[-1] == y.shape[-1]:
        y = y + x
    return y


def init(gen, conf, device=None):
    """conf: ``d_out`` with 5 entries (fine to coarse)."""
    d_out = conf.get_list("d_out")
    if len(d_out) != 5:
        raise ValueError("the MNASNet FPN emits 5 levels: d_out needs 5 entries")
    params = {"stem": {"conv0": conv_init(gen, 3, 32, 3, 2, device),
                       "bn0": _bn_init(32, device), "dw": _dw_init(gen, 32, 3, device),
                       "bn1": _bn_init(32, device),
                       "proj": conv_init(gen, 32, 16, 1, 2, device),
                       "bn2": _bn_init(16, device)}}
    c_in, stacks = 16, []
    for c_out, k, _, e, r in _STACKS:
        stacks.append([_ir_init(gen, c_in if i == 0 else c_out, c_out, k, e, device)
                       for i in range(r)])
        c_in = c_out
    params["stacks"] = stacks
    # decoder (reference lines 66-76): deconvs 320->96->40->24->16->8
    params["decod"] = [conv_init(gen, ci, co, 3, 2, device)
                       for ci, co in ((320, 96), (96, 40), (40, 24), (24, 16), (16, 8))]
    params["out"] = [conv_init(gen, c, d, 3, 2, device)
                     for c, d in zip((96, 40, 24, 16, 8), d_out[::-1])]
    return params


def apply(params, imgs):
    """imgs (nv, H, W, 3) -> 5 feature maps, fine to coarse (/1 ... /16)."""
    st = params["stem"]
    x = relu(_bn_apply(st["bn0"], conv2d_apply(st["conv0"], imgs, stride=2)))
    x = relu(_bn_apply(st["bn1"], _dw_apply(st["dw"], x)))
    enc1 = _bn_apply(st["bn2"], conv2d_apply(st["proj"], x))       # 16 ch, /2
    feats, x = [enc1], enc1
    for blocks, (_, _, s, _, _) in zip(params["stacks"], _STACKS):
        for i, bp in enumerate(blocks):
            x = _ir_apply(bp, x, stride=s if i == 0 else 1)
        feats.append(x)
    # the reference's slices: enc2 = stack 0 (24 ch, /4), enc3 = stack 1
    # (40, /8), enc4 = stacks 2-3 (96, /16), enc5 = stacks 4-5 (320, /32)
    enc2, enc3, enc4, enc5 = feats[1], feats[2], feats[4], feats[6]

    def deconv(p, x):
        return relu(instance_norm_2d(conv2d_transpose_apply(p, x, stride=2, padding=1,
                                                            output_padding=1)))
    dec5 = deconv(params["decod"][0], enc5) + enc4
    dec4 = deconv(params["decod"][1], dec5) + enc3
    dec3 = deconv(params["decod"][2], dec4) + enc2
    dec2 = deconv(params["decod"][3], dec3) + enc1
    dec1 = deconv(params["decod"][4], dec2)
    return [conv2d_apply(p, d) for p, d in zip(params["out"][::-1],
                                                (dec1, dec2, dec3, dec4, dec5))]
