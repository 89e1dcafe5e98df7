"""Parameter intake.

* ``from_jax(params_np, state_np)``: the JAX package's parameter and
  state pytrees, given as numpy arrays (for example ``jax.tree.map(
  np.asarray, params)``), as the port's pytrees of torch tensors, key by
  key.  The two packages share the pytree layout, so weight norm stays as
  (v, g) pairs; ``nn.core.materialize_weight_norm`` folds them when
  wanted.
* ``convert_checkpoint(state_dict)``: a reference (PyTorch) SuRF
  state_dict as (params, state) numpy pytrees of that layout (numpy
  only; the counterpart of surf_tpu/convert/torch_converter.py:31-206).
  The CLI writes them as an npz that ``main --resume`` loads in val and
  finetune:

      python -m surf_tpu_torch.convert --src model_000015.ckpt --dst converted.npz

Key space of the reference state_dict:
  feature_network.encoder_layers.{i}.{0,1}.conv.weight        Conv2d, no bias
  feature_network.decoder_layers.{i}.conv.weight              ConvTranspose2d
  feature_network.out_layers.{i}.weight                       Conv2d bias-free
  match_feature_network.*                                     frozen copy
  volume.agg_mlp.{0,2}.{weight,bias}                          Linear
  reg_network.nets.{s}.conv{k}.net.0.kernel                   torchsparse conv
  reg_network.nets.{s}.conv{k}.net.1.{weight,bias,running_*}  BatchNorm
  reg_network.nets.{s}.out_lin.weight                         Linear bias-free
  implicit_surface.sdf_network.lin{l}.{weight_g,weight_v,bias} weight norm
  implicit_surface.color_network.{...}.{weight,bias} + .s
  implicit_surface.deviation_network.variance

Layout mappings:
  Linear  (out, in)            -> (in, out)                 transpose
  Conv2d  (out, in, kh, kw)    -> (kh, kw, in, out)
  ConvT2d (in, out, kh, kw)    -> (kh, kw, in, out)
  weight-norm Linear: v (out, in) -> (in, out); g (out, 1) -> (out,)
  torchsparse conv kernel (k^3, in, out) -> (k, k, k, in, out): tap t is
  the spatial offset (t % k, (t // k) % k, t // k^2), x fastest (torchsparse
  2.1.0's get_kernel_offsets), so the reshaped (z, y, x) axes are
  transposed to (x, y, z); in_coord = out_coord + offset, no flip.
"""

from __future__ import annotations

import argparse

import numpy as np

from .nn.core import tree_leaves
from .utils.checkpoint import save_checkpoint, to_torch_tree


def from_jax(params_np, state_np, device=None):
    """(params, state) of the port from the JAX package's numpy pytrees,
    the state's batch-norm statistics and frozen ``match_feature_network``
    copy included."""
    return to_torch_tree(params_np, device), to_torch_tree(state_np, device)


# ---------------------------------------------------------------------------
# the reference state_dict
# ---------------------------------------------------------------------------

def _lin(sd, prefix):
    p = {"w": np.ascontiguousarray(sd[f"{prefix}.weight"].T)}
    if f"{prefix}.bias" in sd:
        p["b"] = np.asarray(sd[f"{prefix}.bias"])
    return p


def _lin_wn(sd, prefix):
    return {"v": np.ascontiguousarray(sd[f"{prefix}.weight_v"].T),
            "g": np.asarray(sd[f"{prefix}.weight_g"]).reshape(-1),
            "b": np.asarray(sd[f"{prefix}.bias"])}


def _conv2d(sd, prefix, transposed=False):
    w = np.asarray(sd[f"{prefix}.weight"])   # (out, in, kh, kw); transposed (in, out, kh, kw)
    p = {"w": np.ascontiguousarray(w.transpose((2, 3, 0, 1) if transposed else (2, 3, 1, 0)))}
    if f"{prefix}.bias" in sd:
        p["b"] = np.asarray(sd[f"{prefix}.bias"])
    return p


def _sparse_conv3d(sd, prefix):
    """torchsparse kernel (k^3, in, out), or a dense torch (out, in, k, k, k)
    weight, -> (k, k, k, in, out) on (x, y, z) axes."""
    key = f"{prefix}.kernel" if f"{prefix}.kernel" in sd else f"{prefix}.weight"
    w = np.asarray(sd[key])
    if w.ndim == 3:
        k = round(w.shape[0] ** (1 / 3))
        if k % 2 != 1:
            raise ValueError("even torchsparse kernels enumerate their taps differently")
        w = w.reshape(k, k, k, w.shape[1], w.shape[2]).transpose(2, 1, 0, 3, 4)
    elif w.ndim == 5:
        w = w.transpose(2, 3, 4, 1, 0)
    return {"w": np.ascontiguousarray(w)}


def _bn(sd, prefix):
    return ({"scale": np.asarray(sd[f"{prefix}.weight"]),
             "bias": np.asarray(sd[f"{prefix}.bias"])},
            {"mean": np.asarray(sd[f"{prefix}.running_mean"]),
             "var": np.asarray(sd[f"{prefix}.running_var"])})


def convert_feature_network(sd, prefix, num_stage):
    out = {"encoder": [], "decoder": [], "out": []}
    for i in range(num_stage):
        out["encoder"].append({"c0": _conv2d(sd, f"{prefix}.encoder_layers.{i}.0.conv"),
                               "c1": _conv2d(sd, f"{prefix}.encoder_layers.{i}.1.conv")})
        out["out"].append(_conv2d(sd, f"{prefix}.out_layers.{i}"))
        if i < num_stage - 1:
            out["decoder"].append(_conv2d(sd, f"{prefix}.decoder_layers.{i}.conv",
                                          transposed=True))
    return out


def convert_feature_network_old(sd, prefix):
    """The reference's unused 3-scale FeatureNetworkOld
    (feature_network.py:78-123) in ``nn.feature_net.init_legacy``'s
    layout."""
    def conv(name):
        return _conv2d(sd, f"{prefix}.{name}")
    return {"conv0": [conv(f"conv0.{i}.conv") for i in range(2)],
            "conv1": [conv(f"conv1.{i}.conv") for i in range(3)],
            "conv2": [conv(f"conv2.{i}.conv") for i in range(3)],
            **{k: conv(k) for k in ("out2", "out1", "out0", "inner1", "inner0")}}


REG_CONVS = ("conv0", "conv1", "conv2", "conv3", "conv4", "conv5", "conv6", "conv7",
             "conv9", "conv11")


def convert_reg_network(sd, num_stages):
    params, state = [], []
    for s in range(num_stages):
        p, st = {}, {}
        for n in REG_CONVS:
            base = f"reg_network.nets.{s}.{n}.net"
            bn_p, bn_s = _bn(sd, f"{base}.1")
            p[n] = {"conv": _sparse_conv3d(sd, f"{base}.0"), "bn": bn_p}
            st[n] = {"bn": bn_s}
        p["out_lin"] = {"w": np.ascontiguousarray(
            np.asarray(sd[f"reg_network.nets.{s}.out_lin.weight"]).T)}
        params.append(p)
        state.append(st)
    return params, state


def convert_blending_network(sd, prefix):
    def seq(name, idx):
        return [_lin(sd, f"{prefix}.{name}.{i}") for i in idx]
    p = {"ray_dir_fc": seq("ray_dir_fc", [0, 2]), "base_fc": seq("base_fc", [0, 2]),
         "vis_fc": seq("vis_fc", [0, 2]), "vis_fc2": seq("vis_fc2", [0, 2]),
         "rgb_fc": seq("rgb_fc", [0, 2, 4])}
    if f"{prefix}.s" in sd:
        p["s"] = np.asarray(sd[f"{prefix}.s"])
    return p


def convert_checkpoint(state_dict, *, num_stage=4, sdf_layers=7):
    """state_dict: name -> numpy array (``load_torch_checkpoint`` gives
    one).  Returns (params, state) numpy pytrees in the layout of
    ``nn.surf.init``."""
    sd = {k[len("module."):] if k.startswith("module.") else k: np.asarray(v)
          for k, v in state_dict.items()}                   # DDP prefixes
    reg_p, reg_s = convert_reg_network(sd, num_stage)
    params = {
        "feature_network": convert_feature_network(sd, "feature_network", num_stage),
        "volume": {"agg_mlp": [_lin(sd, "volume.agg_mlp.0"), _lin(sd, "volume.agg_mlp.2")]},
        "reg_network": reg_p,
        "implicit_surface": {
            "sdf_network": {"layers": [_lin_wn(sd, f"implicit_surface.sdf_network.lin{i}")
                                       for i in range(sdf_layers)]},
            "color_network": convert_blending_network(sd, "implicit_surface.color_network"),
            "deviation_network": {
                "variance": np.asarray(sd["implicit_surface.deviation_network.variance"])},
        },
    }
    state = {"reg_network": reg_s,
             "match_feature_network": convert_feature_network(
                 sd, "match_feature_network", num_stage)}
    return params, state


def load_torch_checkpoint(path):
    """A reference .ckpt read on the CPU, as name -> numpy array."""
    import torch
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get("model", ckpt)
    return {k: v.detach().cpu().numpy() for k, v in sd.items() if hasattr(v, "detach")}


def main(argv=None):
    p = argparse.ArgumentParser(description="reference SuRF checkpoint -> the port's npz")
    p.add_argument("--src", type=str, required=True, help="reference .ckpt")
    p.add_argument("--dst", type=str, required=True, help="output .npz")
    p.add_argument("--num_stage", type=int, default=4)
    p.add_argument("--sdf_layers", type=int, default=7)
    args = p.parse_args(argv)
    sd = load_torch_checkpoint(args.src)
    print(f"loaded {len(sd)} tensors from {args.src}")
    params, state = convert_checkpoint(sd, num_stage=args.num_stage,
                                       sdf_layers=args.sdf_layers)
    save_checkpoint(args.dst, {"epoch": -1, "model": params, "state": state})
    n = sum(a.size for a in tree_leaves(params))
    print(f"wrote {args.dst} ({n:,} parameters)")


if __name__ == "__main__":
    main()
