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

``sdf_lattice`` is the mesh lattice's own path: the SDF column alone,
pinned to +100 off the occupancy, no derivatives and no graph; on the card
one launch of the hand-written kernel K5 (csrc/sdf_lattice_mlp.cu), whose
weight layout ``lattice_layout`` builds.
"""

from __future__ import annotations

import ctypes
import math

import torch

from .core import linear_apply, softplus_beta
from .. import _build
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


# ---------------------------------------------------------------------------
# K5: the mesh lattice's SDF (one column, pinned), csrc/sdf_lattice_mlp.cu
# ---------------------------------------------------------------------------

K5_WIDTH = 128          # the kernel's hidden width: h rows and outputs a layer
K5_SLICE = 8            # rows of a weight slice
K5_MAX_ROWS = 416       # canonical rows that fit its shared memory
K5_MAX_SLICES = 512
K5_MAX_HIDDEN = 16


def sdf_lattice_plain(params, static, pts, feats, occ):
    """Plain version of K5: the MLP's SDF at pts (n, 3) with their stage
    features (n, F), +100 where ``occ`` (n,) is false."""
    sdf = mlp(params, static, pts, feats)[:, 0]
    return torch.where(occ, sdf, torch.full_like(sdf, 100.0))


def lattice_layout(params, static):
    """The (weight-norm folded) layers of ``params`` in K5's layout.  Each
    layer reads 8-row slices of a canonical input [h (K5_WIDTH rows) | x_in
    (E) | features (F)]: the layer's rows are placed there, zero elsewhere
    (the kernel scales a skip layer's [h, x_in] by 1/sqrt(2) itself).
    Returns a dict: ``w`` (slices, 8, K5_WIDTH) of the hidden layers,
    ``slice_row`` (each slice's first row), ``layer_end`` (cumulative slices
    a layer), ``skip`` (bit l: layer l is a skip layer), ``bias`` (hidden
    layers, K5_WIDTH), ``w_last`` (rows,) and ``b_last``, the last layer's
    SDF column, and the sizes ``rows``, ``e_row``, ``f_row``, ``E``,
    ``F``."""
    layers = params["layers"]
    L = static["num_layers"]
    skip = static["skip_in"]
    _, E = embedder(static["multires"], 3)
    _, F = embedder(static["feat_multires"], static["feat_channels"])
    e_row, f_row = K5_WIDTH, K5_WIDTH + E
    rows = -(-(f_row + F) // K5_SLICE) * K5_SLICE
    n_hidden = L - 2
    if not 1 <= n_hidden <= K5_MAX_HIDDEN or 0 in skip or rows > K5_MAX_ROWS:
        raise ValueError(f"sdf_lattice: {n_hidden} hidden layers, skip {list(skip)}, "
                         f"{rows} input rows: beyond the kernel's layout")
    dev = layers[0]["w"].device
    blocks, slice_row, layer_end, biases = [], [], [], []
    w_last = b_last = None
    for l, lin in enumerate(layers):
        w = lin["w"].detach().float()
        segs = [(e_row, E)] if l == 0 else [(0, layers[l - 1]["w"].shape[1])]
        if l in skip:
            segs.append((e_row, E))
        if 0 < l < L - 1:
            segs.append((f_row, F))
        if sum(n for _, n in segs) != w.shape[0] or (l < n_hidden and w.shape[1] > K5_WIDTH):
            raise ValueError(f"sdf_lattice: layer {l} is ({w.shape[0]}, {w.shape[1]}), not "
                             f"the kernel's [h | x_in | features] with at most "
                             f"{K5_WIDTH} outputs")
        cw = torch.zeros((rows, K5_WIDTH if l < n_hidden else 1), device=dev)
        off = 0
        for r0, n in segs:
            part = w[off:off + n, :cw.shape[1]]
            cw[r0:r0 + n, :part.shape[1]] = part
            off += n
        b = lin["b"].detach().float() if "b" in lin else torch.zeros(w.shape[1], device=dev)
        if l == n_hidden:
            w_last, b_last = cw[:, 0].contiguous(), float(b[0])
            break
        used = sorted({r // K5_SLICE for r0, n in segs for r in range(r0, r0 + n)})
        blocks += [cw[s * K5_SLICE:(s + 1) * K5_SLICE] for s in used]
        slice_row += [s * K5_SLICE for s in used]
        layer_end.append(len(slice_row))
        biases.append(torch.nn.functional.pad(b, (0, K5_WIDTH - b.shape[0])))
    if len(slice_row) > K5_MAX_SLICES:
        raise ValueError(f"sdf_lattice: {len(slice_row)} weight slices, beyond the "
                         f"kernel's {K5_MAX_SLICES}")
    return {"w": torch.stack(blocks).contiguous(), "slice_row": slice_row,
            "layer_end": layer_end, "skip": sum(1 << l for l in skip if l < L),
            "bias": torch.stack(biases).contiguous(),
            "w_last": w_last, "b_last": b_last, "rows": rows, "e_row": e_row,
            "f_row": f_row, "E": E, "F": F}


def sdf_lattice(params, static, pts, feats, occ, layout=None):
    """The SDF (n,) at the lattice's points pts (n, 3), given their stage
    features (n, F) and nearest occupancy (n,): the MLP's first output
    column, +100 where ``occ`` is false.  CPU tensors take the plain
    version; CUDA tensors launch K5 (``layout``: ``lattice_layout``'s,
    built here when not given), which needs contiguous f32 points and
    features and a bool occupancy on one card, and raises otherwise."""
    if pts.device.type == "cpu":
        return sdf_lattice_plain(params, static, pts, feats, occ)
    if static["feat_multires"] > 0:
        fe, _ = embedder(static["feat_multires"], static["feat_channels"])
        feats = fe(feats).contiguous()
    _build.require_cuda("sdf_lattice_mlp", pts, feats, occ)
    n = pts.shape[0]
    if pts.dtype != torch.float32 or feats.dtype != torch.float32 or \
            occ.dtype != torch.bool or pts.shape != (n, 3) or occ.shape != (n,) or \
            feats.dim() != 2 or feats.shape[0] != n:
        raise ValueError("sdf_lattice_mlp: needs f32 points (n, 3), f32 features (n, F) "
                         "and a bool occupancy (n,)")
    if layout is None:
        layout = lattice_layout(params, static)
    if feats.shape[1] != layout["F"]:
        raise ValueError(f"sdf_lattice_mlp: {feats.shape[1]} feature channels, the layers "
                         f"take {layout['F']}")
    _build.require_cuda("sdf_lattice_mlp", pts, layout["w"], layout["bias"], layout["w_last"])
    out = torch.empty((n,), dtype=torch.float32, device=pts.device)
    if n == 0:
        return out
    _P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    ns, nh = len(layout["slice_row"]), len(layout["layer_end"])
    slice_row = (ctypes.c_int * ns)(*layout["slice_row"])
    layer_end = (ctypes.c_int * nh)(*layout["layer_end"])
    with _build.on_device(pts):
        fn = _build.kernel_fn("sdf_lattice_mlp", "sdf_lattice_mlp",
                              [_P, _P, _P, _L, _I, _I, _F, _P, _P, _P, _I, ctypes.c_uint,
                               _P, _P, _F, _I, _I, _I, _P, _P])
        rc = fn(pts.data_ptr(), feats.data_ptr(), occ.data_ptr(), n, layout["F"],
                max(static["multires"], 0), static["scale"], layout["w"].data_ptr(),
                ctypes.addressof(slice_row), ctypes.addressof(layer_end), nh,
                layout["skip"], layout["bias"].data_ptr(), layout["w_last"].data_ptr(),
                layout["b_last"], layout["rows"], layout["e_row"], layout["f_row"],
                out.data_ptr(), _build.stream_of(pts))
    _build.check(rc, "sdf_lattice_mlp")
    _build.launches["sdf_lattice_mlp"] += 1
    return out
