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

Their backward kernels (training) are K1b ``bilinear_sample_bwd`` and
K2b ``trilinear_sample_bwd``.  ``bilinear_sample_2d`` and
``trilinear_sample_3d`` are differentiable: they run through
``torch.autograd.Function``s whose backward is K1b / K2b.

Each wrapper launches its kernel for CUDA tensors and takes the plain
PyTorch version beside it only for CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch
from torch.autograd.function import once_differentiable

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


def _k1_layout(what, images, coords):
    """K1 / K1b's size rule (32-bit texel offsets: the image below 2^31
    elements, a view's points below 2^31) and coordinates on an 8-byte
    boundary for their float2 loads (a copy in the rare case they are
    not).  Vector loads of 16-byte rows are the kernel's choice: it takes
    them where the rows are aligned."""
    if images.numel() >= 2 ** 31 - 1 or coords.shape[1] >= 2 ** 31 - 256 \
            or images.shape[0] > 65535:
        raise ValueError(f"{what}: image of {images.numel()} elements, "
                         f"{coords.shape[1]} points a view: beyond the kernel's "
                         "32-bit offsets")
    return coords if coords.data_ptr() % 8 == 0 else coords.clone()


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
    coords = _k1_layout("bilinear_sample", images, coords)
    out = torch.empty((V, N, C), dtype=torch.float32, device=images.device)
    fn = _build.kernel_fn("grid_sample", "bilinear_sample_2d",
                          [_P, _P, _P, _I, _I, _I, _I, _L, _I, _I, _P])
    _build.check(fn(images.data_ptr(), coords.data_ptr(), out.data_ptr(),
                    V, H, W, C, N, int(normalized), int(align_corners),
                    _build.stream_of(images)), "bilinear_sample_2d")
    _build.launches["bilinear_sample_2d"] += 1
    return out


def _coord_scale(size, normalized, align_corners):
    """d(unnormalized coordinate) / d(coordinate)."""
    if not normalized:
        return 1.0
    return 0.5 * (size - 1) if align_corners else 0.5 * size


def bilinear_sample_bwd_plain(images, coords, ct, *, normalized=True,
                              align_corners=True, need_images=True,
                              need_coords=True):
    """Plain version of K1b: the VJP of ``bilinear_sample_plain`` for the
    cotangent ct (V, N, C).  Returns (d_images (V, H, W, C) | None,
    d_coords (V, N, 2) | None); corner indices carry no gradient."""
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
    d_flat = torch.zeros_like(flat) if need_images else None
    dx = dy = 0.0
    for ox, oy in ((0, 0), (1, 0), (0, 1), (1, 1)):
        cx, cy = x0 + ox, y0 + oy
        valid = ((cx >= 0) & (cx < W) & (cy >= 0) & (cy < H)).to(images.dtype)
        idx = (vbase + cy.clamp(0, H - 1) * W + cx.clamp(0, W - 1)).reshape(-1)
        wx = fx if ox else 1.0 - fx
        wy = fy if oy else 1.0 - fy
        if need_images:
            d_flat.index_add_(0, idx, (ct * (wx * wy * valid)[..., None]).reshape(-1, C))
        if need_coords:
            s = (flat[idx].reshape(V, -1, C) * ct).sum(-1) * valid
            dx = dx + s * (1.0 if ox else -1.0) * wy
            dy = dy + s * (1.0 if oy else -1.0) * wx
    d_coords = None
    if need_coords:
        d_coords = torch.stack([dx * _coord_scale(W, normalized, align_corners),
                                dy * _coord_scale(H, normalized, align_corners)], -1)
    return (d_flat.reshape(V, H, W, C) if need_images else None), d_coords


def bilinear_sample_bwd(images, coords, ct, *, normalized=True,
                        align_corners=True, need_images=True, need_coords=True):
    """K1b wrapper.  Same contract as ``bilinear_sample_bwd_plain``; f32
    images (V, H, W, C), coords (V, N, 2) and ct (V, N, C)."""
    if images.device.type == "cpu" and coords.device.type == "cpu":
        return bilinear_sample_bwd_plain(
            images, coords, ct, normalized=normalized, align_corners=align_corners,
            need_images=need_images, need_coords=need_coords)
    _build.require_cuda("bilinear_sample_bwd", images, coords, ct)
    V, H, W, C = images.shape
    N = coords.shape[1]
    if images.dtype != torch.float32 or coords.dtype != torch.float32 \
            or ct.dtype != torch.float32 or tuple(ct.shape) != (V, N, C) \
            or tuple(coords.shape) != (V, N, 2):
        raise ValueError("bilinear_sample_bwd: needs f32 images (V,H,W,C), "
                         "coords (V,N,2) and ct (V,N,C)")
    coords = _k1_layout("bilinear_sample_bwd", images, coords)
    d_img = torch.zeros_like(images) if need_images else None
    d_co = torch.empty_like(coords) if need_coords else None
    fn = _build.kernel_fn("grid_sample", "bilinear_sample_2d_bwd",
                          [_P, _P, _P, _P, _P, _I, _I, _I, _I, _L, _I, _I, _P])
    _build.check(fn(images.data_ptr(), coords.data_ptr(), ct.data_ptr(),
                    d_img.data_ptr() if need_images else None,
                    d_co.data_ptr() if need_coords else None,
                    V, H, W, C, N, int(normalized), int(align_corners),
                    _build.stream_of(images)), "bilinear_sample_2d_bwd")
    _build.launches["bilinear_sample_2d_bwd"] += 1
    return d_img, d_co


class _BilinearSample(torch.autograd.Function):
    """K1 with K1b as its backward (first order only)."""

    @staticmethod
    def forward(ctx, images, coords, normalized, align_corners):
        ctx.save_for_backward(images, coords)
        ctx.flags = (normalized, align_corners)
        return bilinear_sample(images, coords, normalized=normalized,
                               align_corners=align_corners)

    @staticmethod
    @once_differentiable
    def backward(ctx, ct):
        images, coords = ctx.saved_tensors
        normalized, align_corners = ctx.flags
        d_img, d_co = bilinear_sample_bwd(
            images, coords, ct.float().contiguous(), normalized=normalized,
            align_corners=align_corners, need_images=ctx.needs_input_grad[0],
            need_coords=ctx.needs_input_grad[1])
        return d_img, d_co, None, None


def bilinear_sample_2d(image, coords, *, normalized=True, align_corners=True):
    """Bilinear sample of one image (H, W, C) at coords (..., 2), or of a
    view batch (V, H, W, C) at coords (V, ..., 2).  Returns (..., C) /
    (V, ..., C).  Differentiable in the image and the coordinates (K1b)."""
    batched = image.dim() == 4
    imgs = image if batched else image[None]
    lead = coords.shape[:-1]
    co = coords.reshape(imgs.shape[0], -1, 2).float().contiguous()
    imgs = imgs.float().contiguous()
    out = _BilinearSample.apply(imgs, co, normalized, align_corners)
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


def _k2_size_rule(volume, coords):
    """K2's size rule: 32-bit voxel offsets (the volume below 2^31
    elements) and the points below 2^31."""
    if volume.numel() >= 2 ** 31 - 1 or coords.shape[0] >= 2 ** 31 - 256:
        raise ValueError(f"trilinear_sample: volume of {volume.numel()} elements, "
                         f"{coords.shape[0]} points: beyond the kernel's 32-bit offsets")


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
    _k2_size_rule(volume, coords)
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


def trilinear_sample_bwd_plain(volume, coords, ct, *, normalized=True,
                               align_corners=True, need_volume=True,
                               need_coords=True):
    """Plain version of K2b: the VJP of ``trilinear_sample_plain`` for the
    cotangent ct (N, C).  Returns (d_volume in the volume's dtype, summed
    in f32 | None, d_coords (N, 3) | None)."""
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
    d_flat = torch.zeros((X * Y * Z, C), dtype=torch.float32,
                         device=volume.device) if need_volume else None
    dx = dy = dz = 0.0
    for k in range(8):
        ox, oy, oz = (k >> 2) & 1, (k >> 1) & 1, k & 1
        cx, cy, cz = x0 + ox, y0 + oy, z0 + oz
        valid = ((cx >= 0) & (cx < X) & (cy >= 0) & (cy < Y) & (cz >= 0)
                 & (cz < Z)).float()
        idx = ((cx.clamp(0, X - 1) * Y + cy.clamp(0, Y - 1)) * Z
               + cz.clamp(0, Z - 1)).reshape(-1)
        wx, wy, wz = (fx if ox else gx), (fy if oy else gy), (fz if oz else gz)
        if need_volume:
            d_flat.index_add_(0, idx, ct * (wx * wy * wz * valid)[..., None])
        if need_coords:
            s = (flat[idx].float() * ct).sum(-1) * valid
            dx = dx + s * (1.0 if ox else -1.0) * wy * wz
            dy = dy + s * wx * (1.0 if oy else -1.0) * wz
            dz = dz + s * wx * wy * (1.0 if oz else -1.0)
    d_coords = None
    if need_coords:
        d_coords = torch.stack([dx * _coord_scale(X, normalized, align_corners),
                                dy * _coord_scale(Y, normalized, align_corners),
                                dz * _coord_scale(Z, normalized, align_corners)], -1)
    d_vol = d_flat.reshape(X, Y, Z, C).to(volume.dtype) if need_volume else None
    return d_vol, d_coords


BRICK = 8          # K2b's bricks: 8^3 voxels


def k2b_bricks(shape):
    """The shape (ceil(X/8), ceil(Y/8), ceil(Z/8)) of K2b's brick map for
    a volume of ``shape`` (X, Y, Z, ...)."""
    return tuple(-(-int(n) // BRICK) for n in shape[:3])


def k2b_bricked(volume, n):
    """K2b's form for a volume and n samples.  The single pass zero-fills
    the full f32 gradient and casts it: 8 bytes a volume element besides
    the bf16 output.  The bricked form first re-reads the coordinates and
    the cotangent (16 bytes a sample) to mark the 8^3 bricks that the
    samples touch, and zeroes and casts only those.  A bf16 volume takes
    the bricked form where the full buffer's 8 bytes an element outweigh
    the 16 a sample (on the training step's four calls: bricked at 352^3
    and 704^3, where it measured faster, and not at 88^3 and 176^3, where
    it measured slower); an f32 volume's gradient is the f32 buffer
    itself, which the single pass fills."""
    return volume.dtype == torch.bfloat16 and volume.numel() * 8 > n * 16


def trilinear_sample_bwd(volume, coords, ct, *, normalized=True,
                         align_corners=True, need_volume=True, need_coords=True,
                         bricked=None, counts=None):
    """K2b wrapper.  Same contract as ``trilinear_sample_bwd_plain``; an
    f32 or bf16 volume (X, Y, Z, C), f32 coords (N, 3) and ct (N, C).
    ``bricked`` (None: ``k2b_bricked``'s rule) picks the form of a bf16
    volume's gradient; ``counts``, a zeroed (2,) int64 CUDA tensor, receives
    the (corner, channel) scatters of nonzero cotangents and the global
    atomics the kernel issued (the rest were merged before an atomic)."""
    if volume.device.type == "cpu" and coords.device.type == "cpu":
        return trilinear_sample_bwd_plain(
            volume, coords, ct, normalized=normalized, align_corners=align_corners,
            need_volume=need_volume, need_coords=need_coords)
    _build.require_cuda("trilinear_sample_bwd", volume, coords, ct)
    X, Y, Z, C = volume.shape
    N = coords.shape[0]
    if volume.dtype not in (torch.float32, torch.bfloat16) \
            or coords.dtype != torch.float32 or ct.dtype != torch.float32 \
            or tuple(coords.shape) != (N, 3) or tuple(ct.shape) != (N, C):
        raise ValueError("trilinear_sample_bwd: needs an f32/bf16 volume "
                         "(X,Y,Z,C), f32 coords (N,3) and ct (N,C)")
    _k2_size_rule(volume, coords)
    bf16 = volume.dtype == torch.bfloat16
    if bricked is None:
        bricked = k2b_bricked(volume, N)
    if bricked and not bf16:
        raise ValueError("trilinear_sample_bwd: the bricked form is for a bf16 volume")
    d_vol = d_out = bricks = None
    if need_volume:
        # the f32 sum: uninitialised in the bricked form (the kernel zeroes
        # the bricks it touches and reads no other)
        alloc = torch.empty if bricked else torch.zeros
        d_vol = alloc(volume.shape, dtype=torch.float32, device=volume.device)
        if bf16:
            d_out = torch.empty_like(volume)
        if bricked:
            bricks = torch.zeros(k2b_bricks(volume.shape), dtype=torch.int32,
                                 device=volume.device)
    d_co = torch.empty_like(coords) if need_coords else None
    fn = _build.kernel_fn("grid_sample", "trilinear_sample_3d_bwd",
                          [_P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _L, _I, _I, _P,
                           _P, _P, _P])
    _build.check(fn(volume.data_ptr(), int(bf16), coords.data_ptr(), ct.data_ptr(),
                    d_vol.data_ptr() if need_volume else None,
                    d_co.data_ptr() if need_coords else None,
                    X, Y, Z, C, N, int(normalized), int(align_corners),
                    _build.stream_of(volume),
                    d_out.data_ptr() if d_out is not None else None,
                    bricks.data_ptr() if bricks is not None else None,
                    counts.data_ptr() if counts is not None else None),
                 "trilinear_sample_3d_bwd")
    _build.launches["trilinear_sample_3d_bwd"] += 1
    return (d_out if bf16 else d_vol) if need_volume else None, d_co


class _TrilinearSample(torch.autograd.Function):
    """K2 with K2b as its backward (first order only)."""

    @staticmethod
    def forward(ctx, volume, coords, normalized, align_corners):
        ctx.save_for_backward(volume, coords)
        ctx.flags = (normalized, align_corners)
        return trilinear_sample(volume, coords, normalized=normalized,
                                align_corners=align_corners)

    @staticmethod
    @once_differentiable
    def backward(ctx, ct):
        volume, coords = ctx.saved_tensors
        normalized, align_corners = ctx.flags
        d_vol, d_co = trilinear_sample_bwd(
            volume, coords, ct.float().contiguous(), normalized=normalized,
            align_corners=align_corners, need_volume=ctx.needs_input_grad[0],
            need_coords=ctx.needs_input_grad[1])
        return d_vol, d_co, None, None


def trilinear_sample_3d(volume, coords, *, normalized=True, align_corners=True):
    """Trilinear sample of a volume (X, Y, Z, C) at coords (..., 3) ->
    (..., C) f32.  Differentiable in the volume and the coordinates (K2b)."""
    lead = coords.shape[:-1]
    vol = volume.contiguous()
    co = coords.reshape(-1, 3).float().contiguous()
    out = _TrilinearSample.apply(vol, co, normalized, align_corners)
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
