"""Image / volume sampling (torch counterpart of surf_tpu/ops/grid_sample.py).

Conventions are the JAX package's: images are channel-last ``(H, W, C)``
or batched ``(V, H, W, C)``; volumes are ``(X, Y, Z, C)`` indexed by
world-ordered coordinates with no xyz->zyx flip.  ``coords`` are (x, y) /
(x, y, z); with ``normalized`` they live in [-1, 1], and ``align_corners``
puts -1/+1 at the corner texel centres (True) or the outer edges (False).
Taps outside the image/volume contribute zero.

Two hand-written kernels live here (csrc/grid_sample.cu):

* K1 ``bilinear_sample`` — the values of ``_bilinear_core`` and
  ``_bsp_core`` (the packed form is a TPU layout; K1 reads the image);
* K2 ``trilinear_sample`` — the values of ``_trilinear_core_cm`` /
  ``trilinear_sample_3d`` / ``PackedVolume``.

Each wrapper launches its kernel for CUDA tensors and takes the plain
PyTorch version beside it only for CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


def _unnormalize(c, size, align_corners):
    if align_corners:
        return (c + 1.0) * 0.5 * (size - 1)
    return ((c + 1.0) * size - 1.0) * 0.5


# ---------------------------------------------------------------------------
# K1: bilinear sampling, batched over views
# ---------------------------------------------------------------------------

def bilinear_sample_plain(images, coords, *, normalized=True,
                          align_corners=True):
    """Plain version of K1.  images (V, H, W, C) f32; coords (V, N, 2) ->
    (V, N, C).  Corners summed in the reference's order."""
    V, H, W, C = images.shape
    x, y = coords[..., 0], coords[..., 1]
    if normalized:
        x = _unnormalize(x, W, align_corners)
        y = _unnormalize(y, H, align_corners)
    x0f, y0f = torch.floor(x), torch.floor(y)
    fx, fy = x - x0f, y - y0f
    x0, y0 = x0f.long(), y0f.long()
    flat = images.reshape(V * H * W, C)
    vbase = (torch.arange(V, device=images.device) * (H * W))[:, None]
    out = None
    for ox, oy in ((0, 0), (1, 0), (0, 1), (1, 1)):
        cx, cy = x0 + ox, y0 + oy
        valid = (cx >= 0) & (cx < W) & (cy >= 0) & (cy < H)
        idx = vbase + cy.clamp(0, H - 1) * W + cx.clamp(0, W - 1)
        w = (fx if ox else 1.0 - fx) * (fy if oy else 1.0 - fy)
        w = w * valid.to(images.dtype)
        term = flat[idx.reshape(-1)].reshape(*idx.shape, C) * w[..., None]
        out = term if out is None else out + term
    return out


def bilinear_sample(images, coords, *, normalized=True, align_corners=True):
    """K1 wrapper.  images (V, H, W, C) f32; coords (V, N, 2) f32 ->
    (V, N, C) f32."""
    if images.device.type == "cpu" and coords.device.type == "cpu":
        return bilinear_sample_plain(images, coords, normalized=normalized,
                                     align_corners=align_corners)
    _build.require_cuda("bilinear_sample", images, coords)
    V, H, W, C = images.shape
    if images.dtype != torch.float32 or coords.dtype != torch.float32 \
            or coords.shape[0] != V or coords.shape[-1] != 2 or coords.dim() != 3:
        raise ValueError("bilinear_sample: needs f32 images (V,H,W,C) and "
                         "f32 coords (V,N,2)")
    N = coords.shape[1]
    out = torch.empty((V, N, C), dtype=torch.float32, device=images.device)
    fn = _build.kernel_fn("grid_sample", "bilinear_sample_2d",
                          [_P, _P, _P, _I, _I, _I, _I, _L, _I, _I, _P])
    _build.check(fn(images.data_ptr(), coords.data_ptr(), out.data_ptr(),
                    V, H, W, C, N, int(normalized), int(align_corners),
                    _build.stream_of(images)), "bilinear_sample_2d")
    _build.launches["bilinear_sample_2d"] += 1
    return out


def bilinear_sample_2d(image, coords, *, normalized=True, align_corners=True):
    """Bilinear sample of one image (H, W, C) at coords (..., 2), or of a
    view batch (V, H, W, C) at coords (V, ..., 2).  Returns (..., C) /
    (V, ..., C)."""
    batched = image.dim() == 4
    imgs = image if batched else image[None]
    lead = coords.shape[:-1]
    co = coords.reshape(imgs.shape[0], -1, 2).float().contiguous()
    out = bilinear_sample(imgs.float().contiguous(), co, normalized=normalized,
                          align_corners=align_corners)
    C = imgs.shape[-1]
    return out.reshape(*lead, C)


def resize_bilinear_2d(image, out_hw, *, align_corners=False):
    """torch ``F.interpolate(mode='bilinear')`` semantics through K1:
    (H, W, C) -> (oh, ow, C), or batched (V, H, W, C) -> (V, oh, ow, C)."""
    oh, ow = out_hw
    H, W = image.shape[-3:-1]
    dev = image.device
    ys = torch.arange(oh, dtype=torch.float32, device=dev)
    xs = torch.arange(ow, dtype=torch.float32, device=dev)
    if align_corners:
        yy = ys * ((H - 1) / max(oh - 1, 1))
        xx = xs * ((W - 1) / max(ow - 1, 1))
    else:
        yy = ((ys + 0.5) * (H / oh) - 0.5).clamp(0, H - 1)
        xx = ((xs + 0.5) * (W / ow) - 0.5).clamp(0, W - 1)
    gy, gx = torch.meshgrid(yy, xx, indexing="ij")
    grid = torch.stack([gx, gy], dim=-1)                    # (oh, ow, 2)
    if image.dim() == 4:
        grid = grid.expand(image.shape[0], oh, ow, 2)
    return bilinear_sample_2d(image, grid, normalized=False)


def nearest_sample_2d(image, coords, *, normalized=True, align_corners=True):
    """Nearest-neighbour 2D sampling (round half to even), zero outside."""
    H, W, C = image.shape
    x, y = coords[..., 0], coords[..., 1]
    if normalized:
        x = _unnormalize(x, W, align_corners)
        y = _unnormalize(y, H, align_corners)
    xi, yi = torch.round(x).long(), torch.round(y).long()
    valid = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
    idx = yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)
    val = image.reshape(H * W, C)[idx.reshape(-1)].reshape(*xi.shape, C)
    return val * valid[..., None].to(image.dtype)


# ---------------------------------------------------------------------------
# K2: trilinear sampling of a dense volume
# ---------------------------------------------------------------------------

def trilinear_sample_plain(volume, coords, *, normalized=True,
                           align_corners=True):
    """Plain version of K2.  volume (X, Y, Z, C) f32/bf16; coords (N, 3) ->
    (N, C) f32 (values widened to f32 before the weighted sum)."""
    X, Y, Z, C = volume.shape
    x, y, z = coords[..., 0], coords[..., 1], coords[..., 2]
    if normalized:
        x = _unnormalize(x, X, align_corners)
        y = _unnormalize(y, Y, align_corners)
        z = _unnormalize(z, Z, align_corners)
    x0f, y0f, z0f = torch.floor(x), torch.floor(y), torch.floor(z)
    fx, fy, fz = x - x0f, y - y0f, z - z0f
    gx, gy, gz = 1.0 - fx, 1.0 - fy, 1.0 - fz
    x0, y0, z0 = x0f.long(), y0f.long(), z0f.long()
    flat = volume.reshape(X * Y * Z, C)
    out = None
    for k in range(8):
        ox, oy, oz = (k >> 2) & 1, (k >> 1) & 1, k & 1
        cx, cy, cz = x0 + ox, y0 + oy, z0 + oz
        valid = (cx >= 0) & (cx < X) & (cy >= 0) & (cy < Y) & \
            (cz >= 0) & (cz < Z)
        idx = (cx.clamp(0, X - 1) * Y + cy.clamp(0, Y - 1)) * Z + \
            cz.clamp(0, Z - 1)
        w = (fx if ox else gx) * (fy if oy else gy) * (fz if oz else gz)
        w = w * valid.to(w.dtype)
        vals = flat[idx.reshape(-1)].reshape(*idx.shape, C).float()
        term = vals * w[..., None]
        out = term if out is None else out + term
    return out


def trilinear_sample(volume, coords, *, normalized=True, align_corners=True):
    """K2 wrapper.  volume (X, Y, Z, C) f32 or bf16; coords (N, 3) f32 ->
    (N, C) f32."""
    if volume.device.type == "cpu" and coords.device.type == "cpu":
        return trilinear_sample_plain(volume, coords, normalized=normalized,
                                      align_corners=align_corners)
    _build.require_cuda("trilinear_sample", volume, coords)
    if volume.dtype not in (torch.float32, torch.bfloat16) \
            or coords.dtype != torch.float32 or coords.dim() != 2 \
            or coords.shape[1] != 3 or volume.dim() != 4:
        raise ValueError("trilinear_sample: needs an f32/bf16 volume "
                         "(X,Y,Z,C) and f32 coords (N,3)")
    X, Y, Z, C = volume.shape
    N = coords.shape[0]
    out = torch.empty((N, C), dtype=torch.float32, device=volume.device)
    fn = _build.kernel_fn("grid_sample", "trilinear_sample_3d",
                          [_P, _I, _P, _P, _I, _I, _I, _I, _L, _I, _I, _P])
    _build.check(fn(volume.data_ptr(), int(volume.dtype == torch.bfloat16),
                    coords.data_ptr(), out.data_ptr(), X, Y, Z, C, N,
                    int(normalized), int(align_corners),
                    _build.stream_of(volume)), "trilinear_sample_3d")
    _build.launches["trilinear_sample_3d"] += 1
    return out


def trilinear_sample_3d(volume, coords, *, normalized=True, align_corners=True):
    """Trilinear sample of a volume (X, Y, Z, C) at coords (..., 3) ->
    (..., C) f32."""
    lead = coords.shape[:-1]
    out = trilinear_sample(volume.contiguous(),
                           coords.reshape(-1, 3).float().contiguous(),
                           normalized=normalized, align_corners=align_corners)
    return out.reshape(*lead, volume.shape[-1])


def nearest_sample_3d(volume, coords, *, normalized=True, align_corners=True):
    """Nearest-neighbour 3D sampling (round half to even), zero outside."""
    X, Y, Z, C = volume.shape
    x, y, z = coords[..., 0], coords[..., 1], coords[..., 2]
    if normalized:
        x = _unnormalize(x, X, align_corners)
        y = _unnormalize(y, Y, align_corners)
        z = _unnormalize(z, Z, align_corners)
    xi, yi, zi = torch.round(x).long(), torch.round(y).long(), torch.round(z).long()
    valid = (xi >= 0) & (xi < X) & (yi >= 0) & (yi < Y) & (zi >= 0) & (zi < Z)
    idx = (xi.clamp(0, X - 1) * Y + yi.clamp(0, Y - 1)) * Z + zi.clamp(0, Z - 1)
    val = volume.reshape(-1, C)[idx.reshape(-1)].reshape(*xi.shape, C)
    return val * valid[..., None].to(volume.dtype)


def upsample_trilinear_x2(volume):
    """2x trilinear upsampling, ``F.interpolate(scale_factor=2,
    mode='trilinear', align_corners=False)`` semantics, as a separable
    closed form: along each axis the even output is 0.75 v[i] + 0.25
    v[i-1] and the odd one 0.75 v[i] + 0.25 v[i+1] (edges repeated).
    (X, Y, Z, C) -> (2X, 2Y, 2Z, C), in the input's dtype."""
    out = volume
    for ax in range(3):
        lo = torch.cat([out.narrow(ax, 0, 1), out.narrow(ax, 0, out.shape[ax] - 1)], ax)
        hi = torch.cat([out.narrow(ax, 1, out.shape[ax] - 1), out.narrow(ax, out.shape[ax] - 1, 1)], ax)
        even = 0.75 * out + 0.25 * lo
        del lo
        odd = 0.75 * out + 0.25 * hi
        del hi
        shape = list(out.shape)
        shape[ax] *= 2
        out = torch.stack([even, odd], dim=ax + 1).reshape(shape)
        del even, odd
    return out
