"""Network building blocks (torch counterpart of surf_tpu/nn/core.py).

Parameters are the JAX package's pytrees with torch tensors as leaves (so
``convert.from_jax`` is a tree map), in the JAX layouts: dense weights
``(in, out)``, 2D kernels ``(kh, kw, c_in, c_out)``, 3D kernels ``(k, k,
k, c_in, c_out)``.  Activations are channel-last at every public function;
the convolutions move channels to PyTorch's NC... order inside.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


# ---------------------------------------------------------------------------
# initializers (the JAX package's distributions, drawn from a Generator)
# ---------------------------------------------------------------------------

def _normal(gen, shape, std, device):
    return torch.randn(shape, generator=gen, device=device) * std


def _uniform(gen, shape, bound, device):
    return (torch.rand(shape, generator=gen, device=device) * 2.0 - 1.0) * bound


def kaiming_normal(gen, shape, fan_in, device=None):
    """He-normal (torch kaiming_normal_ default: fan_in, relu gain)."""
    return _normal(gen, shape, math.sqrt(2.0 / fan_in), device)


def kaiming_uniform_torch(gen, shape, fan_in, device=None):
    """torch's default Linear/Conv init (kaiming_uniform, a=sqrt(5))."""
    bound = math.sqrt(2.0 / (1 + 5.0)) * math.sqrt(3.0 / fan_in)
    return _uniform(gen, shape, bound, device)


def bias_uniform_torch(gen, shape, fan_in, device=None):
    bound = 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0
    return _uniform(gen, shape, bound, device)


def linear_init(gen, d_in, d_out, *, w_init=None, b_init=None, device=None):
    """{"w" (d_in, d_out), "b" (d_out,)}: torch's default init unless
    ``w_init`` / ``b_init`` (gen, shape) say otherwise."""
    if w_init is None:
        w = kaiming_uniform_torch(gen, (d_in, d_out), d_in, device)
    else:
        w = w_init(gen, (d_in, d_out))
    b = bias_uniform_torch(gen, (d_out,), d_in, device) if b_init is None \
        else b_init(gen, (d_out,))
    return {"w": w, "b": b}


def conv_init(gen, c_in, c_out, k, ndim, device=None):
    """Bias-free (k,)*ndim + (c_in, c_out) kernel, torch default init."""
    fan_in = c_in * k ** ndim
    return {"w": kaiming_uniform_torch(gen, (k,) * ndim + (c_in, c_out),
                                       fan_in, device)}


# ---------------------------------------------------------------------------
# activations
# ---------------------------------------------------------------------------

def elu(x):
    return F.elu(x)


def relu(x):
    return F.relu(x)


def softplus_beta(x, beta=100.0, threshold=20.0):
    """torch.nn.Softplus(beta, threshold) written out as the JAX package
    does: linear where beta*x > threshold."""
    scaled = x * beta
    return torch.where(scaled > threshold, x, F.softplus(scaled) / beta)


# ---------------------------------------------------------------------------
# linear (+ weight norm)
# ---------------------------------------------------------------------------

def _fold(v, g):
    return v * (g / (torch.linalg.norm(v, dim=0) + 1e-12))[None, :]


def linear_apply(p, x):
    w = _fold(p["v"], p["g"]) if "v" in p else p["w"]
    y = x @ w
    if "b" in p:
        y = y + p["b"]
    return y


def tree_leaves(tree):
    """The leaves of a pytree of dicts and lists, in order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def materialize_weight_norm(tree):
    """Fold every weight-norm (v, g) pair into w = v * g / ||v|| (the
    reference's torch weight_norm(dim=0) on an (out, in) weight)."""
    if isinstance(tree, dict):
        if "v" in tree and "g" in tree:
            out = {"w": _fold(tree["v"], tree["g"])}
            if "b" in tree:
                out["b"] = tree["b"]
            return out
        return {k: materialize_weight_norm(x) for k, x in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(materialize_weight_norm(x) for x in tree)
    return tree


# ---------------------------------------------------------------------------
# convolutions (channel-last in and out)
# ---------------------------------------------------------------------------

def _w2d(w):           # (kh, kw, ci, co) -> (co, ci, kh, kw)
    return w.permute(3, 2, 0, 1)


def _w3d(w):           # (k, k, k, ci, co) -> (co, ci, k, k, k)
    return w.permute(4, 3, 0, 1, 2)


def conv2d_apply(p, x, *, stride=1, groups=1):
    """x (N, H, W, C); 'same' padding (k-1)//2; ``groups`` as
    ``F.conv2d``'s (a depthwise conv: groups = C, kernel (k, k, 1, C))."""
    k = p["w"].shape[0]
    y = F.conv2d(x.permute(0, 3, 1, 2), _w2d(p["w"]), stride=stride,
                 padding=(k - 1) // 2, groups=groups)
    if "b" in p:
        y = y + p["b"][:, None, None]
    return y.permute(0, 2, 3, 1)


def conv2d_transpose_apply(p, x, *, stride=2, padding=1, output_padding=1):
    """torch ConvTranspose2d(k, stride, padding, output_padding) with the
    JAX layout (kh, kw, c_in, c_out) kernel.  cuDNN is held to a
    deterministic algorithm for this call: its default one gives other bits
    from call to call, enough to move a voxel in or out of the stage-3
    active set (PERF.md)."""
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        y = F.conv_transpose2d(x.permute(0, 3, 1, 2), p["w"].permute(2, 3, 0, 1),
                               stride=stride, padding=padding,
                               output_padding=output_padding)
    finally:
        torch.backends.cudnn.deterministic = prev
    if "b" in p:
        y = y + p["b"][:, None, None]
    return y.permute(0, 2, 3, 1)


def instance_norm_2d(x, eps=1e-5):
    """InstanceNorm2d(affine=False) on (N, H, W, C): biased variance."""
    mean = x.mean(dim=(1, 2), keepdim=True)
    var = x.var(dim=(1, 2), keepdim=True, unbiased=False)
    return (x - mean) * torch.rsqrt(var + eps)


def conv3d_apply(p, x, *, stride=1):
    """x (N, X, Y, Z, C); padding 1 for k=3."""
    k = p["w"].shape[0]
    y = F.conv3d(x.permute(0, 4, 1, 2, 3), _w3d(p["w"]), stride=stride,
                 padding=(k - 1) // 2)
    return y.permute(0, 2, 3, 4, 1)


# per axis, _PARITY_SEL[a, i, t] = 1 where output parity a of the stride-2
# transposed conv applies kernel tap t to input m + i:
# out[2m] = w[1] x[m], out[2m + 1] = w[2] x[m] + w[0] x[m + 1]
_PARITY_SEL = torch.tensor([[[0.0, 1.0, 0.0], [0.0, 0.0, 0.0]],
                            [[0.0, 0.0, 1.0], [1.0, 0.0, 0.0]]])


def _subpixel_weight(w):
    """(3, 3, 3, Cin, Cout) transposed-conv kernel -> the (8 Cout, Cin, 2,
    2, 2) forward kernel that gives all 8 output parities at once."""
    sel = _PARITY_SEL.to(w)
    ws = torch.einsum("aix,bjy,clz,xyzdo->abcodijl", sel, sel, sel, w)
    return ws.reshape(8 * w.shape[-1], w.shape[-2], 2, 2, 2)


def conv3d_transpose_apply(p, x):
    """Transposed 3D conv with torchsparse's stride-2 geometry (k=3,
    padding 1, output padding 1): output = 2 x input.  Computed as one
    forward conv at the input's resolution (2^3 kernel, 8 Cout channels,
    one per output parity) and an interleave: cuDNN's transposed 3-D
    algorithms give other bits from call to call, and its deterministic
    one is far slower (PERF.md)."""
    N, X, Y, Z, _ = x.shape
    cout = p["w"].shape[-1]
    xp = F.pad(x.permute(0, 4, 1, 2, 3), (0, 1, 0, 1, 0, 1))
    y = F.conv3d(xp, _subpixel_weight(p["w"]))
    y = y.reshape(N, 2, 2, 2, cout, X, Y, Z).permute(0, 5, 1, 6, 2, 7, 3, 4)
    return y.reshape(N, 2 * X, 2 * Y, 2 * Z, cout)


# ---------------------------------------------------------------------------
# masked batch norm
# ---------------------------------------------------------------------------

def batch_norm_init(c, device=None):
    return ({"scale": torch.ones(c, device=device), "bias": torch.zeros(c, device=device)},
            {"mean": torch.zeros(c, device=device), "var": torch.ones(c, device=device)})


def masked_batch_norm_apply(params, state, x, mask, *, training=False,
                            momentum=0.1, eps=1e-5):
    """BatchNorm over the active rows of a capacity-padded set, zeroed
    outside ``mask`` (x (..., C); mask broadcastable to x[..., 0]).  In
    training the statistics are the batch's over the mask (torchsparse's
    BatchNorm over the active set) and the running statistics move by
    torch's momentum rule with the unbiased variance.  Returns (y,
    new_state); the new state is detached."""
    m = mask.to(x.dtype)[..., None]
    if training:
        dims = tuple(range(x.dim() - 1))
        n = torch.clamp(m.sum(), min=1.0)
        mean = (x * m).sum(dims) / n
        var = (((x - mean) ** 2) * m).sum(dims) / n
        unbiased = var * n / torch.clamp(n - 1.0, min=1.0)
        new_state = {"mean": ((1 - momentum) * state["mean"] + momentum * mean).detach(),
                     "var": ((1 - momentum) * state["var"] + momentum * unbiased).detach()}
    else:
        mean, var = state["mean"], state["var"]
        new_state = state
    y = (x - mean) * torch.rsqrt(var + eps) * params["scale"] + params["bias"]
    return y * m, new_state
