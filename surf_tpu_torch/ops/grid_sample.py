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
``trilinear_sample_3d`` are differentiable twice: they run through
``torch.autograd.Function``s whose backward is K1b / K2b, itself a
``Function`` whose backward (the second order) is K1 / K1b (K2 / K2b) on
the d_image (d_volume) cotangent and, on the d_coords one, the gather K1g
``bilinear_sample_bwd2_gather`` (K2g ``trilinear_sample_bwd2_gather``) and
the scatter K1s ``bilinear_sample_bwd2_scatter`` (K2s
``trilinear_sample_bwd2_scatter``).  A third order raises.

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

def _cell_2d(images, coords, normalized, align_corners):
    """The plain versions' bilinear geometry: per corner in the reference's
    order ((0,0), (1,0), (0,1), (1,1)): (flat texel index clamped to the
    image, 0/1 inside mask, wx, wy, sign of d_x wx, sign of d_y wy)."""
    V, H, W, _ = images.shape
    x, y = coords[..., 0], coords[..., 1]
    if normalized:
        x = _unnormalize(x, W, align_corners)
        y = _unnormalize(y, H, align_corners)
    x0f, y0f = torch.floor(x), torch.floor(y)
    fx, fy = x - x0f, y - y0f
    x0, y0 = x0f.long(), y0f.long()
    vbase = (torch.arange(V, device=images.device) * (H * W))[:, None]
    corners = []
    for ox, oy in ((0, 0), (1, 0), (0, 1), (1, 1)):
        cx, cy = x0 + ox, y0 + oy
        valid = ((cx >= 0) & (cx < W) & (cy >= 0) & (cy < H)).to(images.dtype)
        idx = (vbase + cy.clamp(0, H - 1) * W + cx.clamp(0, W - 1)).reshape(-1)
        corners.append((idx, valid, fx if ox else 1.0 - fx, fy if oy else 1.0 - fy,
                        1.0 if ox else -1.0, 1.0 if oy else -1.0))
    return corners


def bilinear_sample_plain(images, coords, *, normalized=True,
                          align_corners=True):
    """Plain version of K1.  images (V, H, W, C) f32; coords (V, N, 2) ->
    (V, N, C).  Corners summed in the reference's order."""
    V, H, W, C = images.shape
    flat = images.reshape(V * H * W, C)
    out = None
    for idx, valid, wx, wy, _, _ in _cell_2d(images, coords, normalized, align_corners):
        term = flat[idx].reshape(*coords.shape[:-1], C) * (wx * wy * valid)[..., None]
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
    with _build.on_device(images):
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
    flat = images.reshape(V * H * W, C)
    d_flat = torch.zeros_like(flat) if need_images else None
    dx = dy = 0.0
    for idx, valid, wx, wy, ex, ey in _cell_2d(images, coords, normalized, align_corners):
        if need_images:
            d_flat.index_add_(0, idx, (ct * (wx * wy * valid)[..., None]).reshape(-1, C))
        if need_coords:
            s = (flat[idx].reshape(V, -1, C) * ct).sum(-1) * valid
            dx = dx + s * ex * wy
            dy = dy + s * ey * wx
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
    with _build.on_device(images):
        _build.check(fn(images.data_ptr(), coords.data_ptr(), ct.data_ptr(),
                        d_img.data_ptr() if need_images else None,
                        d_co.data_ptr() if need_coords else None,
                        V, H, W, C, N, int(normalized), int(align_corners),
                        _build.stream_of(images)), "bilinear_sample_2d_bwd")
    _build.launches["bilinear_sample_2d_bwd"] += 1
    return d_img, d_co


# ---------------------------------------------------------------------------
# K1g / K1s: the second order of K1 (the backward of K1b's d_coords)
#
# With corner weights w_k(u) = wx_k wy_k (0 outside) at the unnormalized
# position u = s x + c, K1b's d_coords is s_a sum_k d_a w_k S_k, where
# S_k = sum_c image[i_k, c] ct[c].  Its cotangent h (V, N, 2) gives, with
# h'_a = s_a h_a and the directional weight dw_k = sum_a d_a w_k h'_a:
#   * d ct (K1g, directional): sum_k dw_k image[i_k]           (V, N, C)
#   * d coords (K1g, Hessian): s_x h'_y M, s_y h'_x M with
#     M = sum_k d_x d_y w_k S_k (the unmixed d_a^2 w_k are 0)   (V, N, 2)
#   * d image (K1s): the scatter of dw_k ct into the corners
# The d_image cotangent's terms are K1 (d ct) and K1b's d_coords (d coords).
# ---------------------------------------------------------------------------

def bilinear_sample_bwd2_gather_plain(images, coords, h, ct=None, *, normalized=True,
                                      align_corners=True, need_dir=True, need_hess=True):
    """Plain version of K1g.  images (V, H, W, C), coords and h (V, N, 2),
    ct (V, N, C) (read for the Hessian term only).  Returns (directional
    term (V, N, C) | None, Hessian term (V, N, 2) | None), each summed over
    the corners in the reference's order as the kernel sums them."""
    V, H, W, C = images.shape
    sx = _coord_scale(W, normalized, align_corners)
    sy = _coord_scale(H, normalized, align_corners)
    hx, hy = h[..., 0] * sx, h[..., 1] * sy
    flat = images.reshape(V * H * W, C)
    out = m = None
    for idx, valid, wx, wy, ex, ey in _cell_2d(images, coords, normalized, align_corners):
        vals = flat[idx].reshape(V, -1, C)
        if need_dir:
            dw = ((wy * ex) * hx + (wx * ey) * hy) * valid
            term = vals * dw[..., None]
            out = term if out is None else out + term
        if need_hess:
            t = (vals * ct).sum(-1) * valid * (ex * ey)
            m = t if m is None else m + t
    hess = torch.stack([(m * hy) * sx, (m * hx) * sy], -1) if need_hess else None
    return out, hess


def bilinear_sample_bwd2_scatter_plain(images, coords, h, ct, *, normalized=True,
                                       align_corners=True):
    """Plain version of K1s: the scatter of dw_k ct into the corners, a
    (V, H, W, C) gradient image."""
    V, H, W, C = images.shape
    sx = _coord_scale(W, normalized, align_corners)
    sy = _coord_scale(H, normalized, align_corners)
    hx, hy = h[..., 0] * sx, h[..., 1] * sy
    d_flat = images.new_zeros((V * H * W, C))
    for idx, valid, wx, wy, ex, ey in _cell_2d(images, coords, normalized, align_corners):
        dw = ((wy * ex) * hx + (wx * ey) * hy) * valid
        d_flat.index_add_(0, idx, (ct * dw[..., None]).reshape(-1, C))
    return d_flat.reshape(V, H, W, C)


def _k1_second_args(what, images, coords, h, ct):
    _build.require_cuda(what, images, coords, h, *([] if ct is None else [ct]))
    V, H, W, C = images.shape
    N = coords.shape[1]
    if images.dtype != torch.float32 or coords.dtype != torch.float32 \
            or h.dtype != torch.float32 or tuple(coords.shape) != (V, N, 2) \
            or tuple(h.shape) != (V, N, 2) or (ct is not None and (
                ct.dtype != torch.float32 or tuple(ct.shape) != (V, N, C))):
        raise ValueError(f"{what}: needs f32 images (V,H,W,C), coords and h (V,N,2) "
                         "and ct (V,N,C)")
    _k1_layout(what, images, coords)
    return V, H, W, C, N


def bilinear_sample_bwd2_gather(images, coords, h, ct=None, *, normalized=True,
                                align_corners=True, need_dir=True, need_hess=True):
    """K1g wrapper.  Same contract as ``bilinear_sample_bwd2_gather_plain``;
    ``ct`` is needed for the Hessian term only."""
    if images.device.type == "cpu" and coords.device.type == "cpu":
        return bilinear_sample_bwd2_gather_plain(
            images, coords, h, ct, normalized=normalized, align_corners=align_corners,
            need_dir=need_dir, need_hess=need_hess)
    V, H, W, C, N = _k1_second_args("bilinear_sample_bwd2_gather", images, coords, h,
                                    ct if need_hess else None)
    dir_ = torch.empty((V, N, C), dtype=torch.float32, device=images.device) \
        if need_dir else None
    hess = torch.empty_like(coords) if need_hess else None
    fn = _build.kernel_fn("grid_sample", "bilinear_sample_2d_bwd2_gather",
                          [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _L, _I, _I, _P])
    with _build.on_device(images):
        _build.check(fn(images.data_ptr(), coords.data_ptr(), h.data_ptr(),
                        ct.data_ptr() if need_hess else None,
                        dir_.data_ptr() if need_dir else None,
                        hess.data_ptr() if need_hess else None,
                        V, H, W, C, N, int(normalized), int(align_corners),
                        _build.stream_of(images)), "bilinear_sample_2d_bwd2_gather")
    _build.launches["bilinear_sample_2d_bwd2_gather"] += 1
    return dir_, hess


def bilinear_sample_bwd2_scatter(images, coords, h, ct, *, normalized=True,
                                 align_corners=True):
    """K1s wrapper.  Same contract as ``bilinear_sample_bwd2_scatter_plain``
    (``images`` gives the shape; its values are not read)."""
    if images.device.type == "cpu" and coords.device.type == "cpu":
        return bilinear_sample_bwd2_scatter_plain(
            images, coords, h, ct, normalized=normalized, align_corners=align_corners)
    V, H, W, C, N = _k1_second_args("bilinear_sample_bwd2_scatter", images, coords, h, ct)
    d_img = torch.zeros((V, H, W, C), dtype=torch.float32, device=images.device)
    fn = _build.kernel_fn("grid_sample", "bilinear_sample_2d_bwd2_scatter",
                          [_P, _P, _P, _P, _I, _I, _I, _I, _L, _I, _I, _P])
    with _build.on_device(images):
        _build.check(fn(coords.data_ptr(), h.data_ptr(), ct.data_ptr(), d_img.data_ptr(),
                        V, H, W, C, N, int(normalized), int(align_corners),
                        _build.stream_of(images)), "bilinear_sample_2d_bwd2_scatter")
    _build.launches["bilinear_sample_2d_bwd2_scatter"] += 1
    return d_img


def _add(a, b):
    return b if a is None else (a if b is None else a + b)


class _BilinearSampleBwd(torch.autograd.Function):
    """K1b as a function of (images, coords, ct), so that a backward that
    builds a graph can be differentiated once more: its backward is K1 and
    K1b on the d_image cotangent, K1g and K1s on the d_coords one; a
    third order raises."""

    @staticmethod
    def forward(ctx, images, coords, ct, normalized, align_corners, need_images,
                need_coords):
        # a cotangent that no gradient reaches comes as None: its terms are
        # skipped
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(images, coords, ct)
        ctx.flags = (normalized, align_corners)
        return bilinear_sample_bwd(images, coords, ct, normalized=normalized,
                                   align_corners=align_corners, need_images=need_images,
                                   need_coords=need_coords)

    @staticmethod
    @once_differentiable
    def backward(ctx, g_img, g_co):
        images, coords, ct = ctx.saved_tensors
        kw = dict(zip(("normalized", "align_corners"), ctx.flags))
        need_img, need_co, need_ct = ctx.needs_input_grad[:3]
        d_img = d_co = d_ct = None
        if g_img is not None:
            g_img = g_img.float().contiguous()
            if need_ct:
                d_ct = bilinear_sample(g_img, coords, **kw)
            if need_co:
                d_co = bilinear_sample_bwd(g_img, coords, ct, need_images=False, **kw)[1]
        if g_co is not None and (need_ct or need_co):
            dir_, hess = bilinear_sample_bwd2_gather(
                images, coords, g_co.float().contiguous(), ct, need_dir=need_ct,
                need_hess=need_co, **kw)
            d_ct, d_co = _add(d_ct, dir_), _add(d_co, hess)
        if g_co is not None and need_img:
            d_img = bilinear_sample_bwd2_scatter(images, coords, g_co.float().contiguous(),
                                                 ct, **kw)
        return d_img, d_co, d_ct, None, None, None, None


class _BilinearSample(torch.autograd.Function):
    """K1 with K1b as its backward, differentiable once more (K1g, K1s)."""

    @staticmethod
    def forward(ctx, images, coords, normalized, align_corners):
        ctx.save_for_backward(images, coords)
        ctx.flags = (normalized, align_corners)
        return bilinear_sample(images, coords, normalized=normalized,
                               align_corners=align_corners)

    @staticmethod
    def backward(ctx, ct):
        images, coords = ctx.saved_tensors
        args = (images, coords, ct.float().contiguous(), *ctx.flags,
                ctx.needs_input_grad[0], ctx.needs_input_grad[1])
        d_img, d_co = _BilinearSampleBwd.apply(*args)
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

def _cell_3d(volume, coords, normalized, align_corners):
    """The plain versions' trilinear geometry: per corner k = 4 ox + 2 oy +
    oz: (voxel index clamped to the volume, 0/1 inside mask, wx, wy, wz,
    signs of d_x wx, d_y wy, d_z wz)."""
    X, Y, Z, _ = volume.shape
    x, y, z = coords[..., 0], coords[..., 1], coords[..., 2]
    if normalized:
        x = _unnormalize(x, X, align_corners)
        y = _unnormalize(y, Y, align_corners)
        z = _unnormalize(z, Z, align_corners)
    x0f, y0f, z0f = torch.floor(x), torch.floor(y), torch.floor(z)
    fx, fy, fz = x - x0f, y - y0f, z - z0f
    x0, y0, z0 = x0f.long(), y0f.long(), z0f.long()
    corners = []
    for k in range(8):
        ox, oy, oz = (k >> 2) & 1, (k >> 1) & 1, k & 1
        cx, cy, cz = x0 + ox, y0 + oy, z0 + oz
        valid = ((cx >= 0) & (cx < X) & (cy >= 0) & (cy < Y) & (cz >= 0)
                 & (cz < Z)).float()
        idx = ((cx.clamp(0, X - 1) * Y + cy.clamp(0, Y - 1)) * Z
               + cz.clamp(0, Z - 1)).reshape(-1)
        corners.append((idx, valid, fx if ox else 1.0 - fx, fy if oy else 1.0 - fy,
                        fz if oz else 1.0 - fz, 1.0 if ox else -1.0,
                        1.0 if oy else -1.0, 1.0 if oz else -1.0))
    return corners


def trilinear_sample_plain(volume, coords, *, normalized=True,
                           align_corners=True):
    """Plain version of K2.  volume (X, Y, Z, C) f32/bf16; coords (N, 3) ->
    (N, C) f32 (values widened to f32 before the weighted sum)."""
    C = volume.shape[-1]
    flat = volume.reshape(-1, C)
    out = None
    for idx, valid, wx, wy, wz, _, _, _ in _cell_3d(volume, coords, normalized,
                                                    align_corners):
        vals = flat[idx].reshape(*coords.shape[:-1], C).float()
        term = vals * (wx * wy * wz * valid)[..., None]
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
    with _build.on_device(volume):
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
    flat = volume.reshape(X * Y * Z, C)
    d_flat = torch.zeros((X * Y * Z, C), dtype=torch.float32,
                         device=volume.device) if need_volume else None
    dx = dy = dz = 0.0
    for idx, valid, wx, wy, wz, ex, ey, ez in _cell_3d(volume, coords, normalized,
                                                       align_corners):
        if need_volume:
            d_flat.index_add_(0, idx, ct * (wx * wy * wz * valid)[..., None])
        if need_coords:
            s = (flat[idx].float() * ct).sum(-1) * valid
            dx = dx + s * ex * wy * wz
            dy = dy + s * wx * ey * wz
            dz = dz + s * wx * wy * ez
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
    with _build.on_device(volume):
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


# ---------------------------------------------------------------------------
# K2g / K2s: the second order of K2 (the backward of K2b's d_coords), as
# for K1 with 8 corners w_k = wx_k wy_k wz_k and three mixed second
# derivatives: with h'_a = s_a h_a and M_ab = sum_k d_a d_b w_k S_k,
#   * d ct (K2g, directional): sum_k dw_k volume[i_k]                 (N, C)
#   * d coords (K2g, Hessian): s_x (h'_y M_xy + h'_z M_xz), s_y (h'_x M_xy
#     + h'_z M_yz), s_z (h'_x M_xz + h'_y M_yz)                       (N, 3)
#   * d volume (K2s): the scatter of dw_k ct into the corners, summed in
#     f32 and given in the volume's dtype (K2b's rule and forms)
# ---------------------------------------------------------------------------

def _dir_scales(shape, h, normalized, align_corners):
    s = [_coord_scale(n, normalized, align_corners) for n in shape]
    return s, [h[..., a] * s[a] for a in range(len(s))]


def _tri_dweight(wx, wy, wz, ex, ey, ez, hx, hy, hz, valid):
    return (((wy * wz) * ex) * hx + ((wx * wz) * ey) * hy + ((wx * wy) * ez) * hz) * valid


def trilinear_sample_bwd2_gather_plain(volume, coords, h, ct=None, *, normalized=True,
                                       align_corners=True, need_dir=True, need_hess=True):
    """Plain version of K2g.  volume (X, Y, Z, C) f32/bf16, coords and h
    (N, 3), ct (N, C) (read for the Hessian term only).  Returns
    (directional term (N, C) f32 | None, Hessian term (N, 3) | None), each
    summed over the corners in order as the kernel sums them (values
    widened to f32)."""
    X, Y, Z, C = volume.shape
    (sx, sy, sz), (hx, hy, hz) = _dir_scales((X, Y, Z), h, normalized, align_corners)
    flat = volume.reshape(X * Y * Z, C)
    out = mxy = mxz = myz = None
    for idx, valid, wx, wy, wz, ex, ey, ez in _cell_3d(volume, coords, normalized,
                                                       align_corners):
        vals = flat[idx].reshape(-1, C).float()
        if need_dir:
            term = vals * _tri_dweight(wx, wy, wz, ex, ey, ez, hx, hy, hz, valid)[..., None]
            out = term if out is None else out + term
        if need_hess:
            s = (vals * ct).sum(-1) * valid
            txy, txz, tyz = s * (wz * (ex * ey)), s * (wy * (ex * ez)), s * (wx * (ey * ez))
            mxy, mxz, myz = ((txy, txz, tyz) if mxy is None
                             else (mxy + txy, mxz + txz, myz + tyz))
    hess = None
    if need_hess:
        hess = torch.stack([(mxy * hy + mxz * hz) * sx, (mxy * hx + myz * hz) * sy,
                            (mxz * hx + myz * hy) * sz], -1)
    return out, hess


def trilinear_sample_bwd2_scatter_plain(volume, coords, h, ct, *, normalized=True,
                                        align_corners=True):
    """Plain version of K2s: the scatter of dw_k ct into the corners,
    summed in f32, in the volume's dtype."""
    X, Y, Z, C = volume.shape
    _, (hx, hy, hz) = _dir_scales((X, Y, Z), h, normalized, align_corners)
    d_flat = torch.zeros((X * Y * Z, C), dtype=torch.float32, device=volume.device)
    for idx, valid, wx, wy, wz, ex, ey, ez in _cell_3d(volume, coords, normalized,
                                                       align_corners):
        dw = _tri_dweight(wx, wy, wz, ex, ey, ez, hx, hy, hz, valid)
        d_flat.index_add_(0, idx, ct * dw[..., None])
    return d_flat.reshape(X, Y, Z, C).to(volume.dtype)


def _k2_second_args(what, volume, coords, h, ct):
    _build.require_cuda(what, volume, coords, h, *([] if ct is None else [ct]))
    X, Y, Z, C = volume.shape
    N = coords.shape[0]
    if volume.dtype not in (torch.float32, torch.bfloat16) \
            or coords.dtype != torch.float32 or h.dtype != torch.float32 \
            or tuple(coords.shape) != (N, 3) or tuple(h.shape) != (N, 3) \
            or (ct is not None and (ct.dtype != torch.float32
                                    or tuple(ct.shape) != (N, C))):
        raise ValueError(f"{what}: needs an f32/bf16 volume (X,Y,Z,C), f32 coords "
                         "and h (N,3) and ct (N,C)")
    _k2_size_rule(volume, coords)
    return X, Y, Z, C, N


def trilinear_sample_bwd2_gather(volume, coords, h, ct=None, *, normalized=True,
                                 align_corners=True, need_dir=True, need_hess=True):
    """K2g wrapper.  Same contract as ``trilinear_sample_bwd2_gather_plain``;
    ``ct`` is needed for the Hessian term only."""
    if volume.device.type == "cpu" and coords.device.type == "cpu":
        return trilinear_sample_bwd2_gather_plain(
            volume, coords, h, ct, normalized=normalized, align_corners=align_corners,
            need_dir=need_dir, need_hess=need_hess)
    X, Y, Z, C, N = _k2_second_args("trilinear_sample_bwd2_gather", volume, coords, h,
                                    ct if need_hess else None)
    dir_ = torch.empty((N, C), dtype=torch.float32, device=volume.device) \
        if need_dir else None
    hess = torch.empty_like(coords) if need_hess else None
    fn = _build.kernel_fn("grid_sample", "trilinear_sample_3d_bwd2_gather",
                          [_P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _L, _I, _I, _P])
    with _build.on_device(volume):
        _build.check(fn(volume.data_ptr(), int(volume.dtype == torch.bfloat16),
                        coords.data_ptr(), h.data_ptr(),
                        ct.data_ptr() if need_hess else None,
                        dir_.data_ptr() if need_dir else None,
                        hess.data_ptr() if need_hess else None,
                        X, Y, Z, C, N, int(normalized), int(align_corners),
                        _build.stream_of(volume)), "trilinear_sample_3d_bwd2_gather")
    _build.launches["trilinear_sample_3d_bwd2_gather"] += 1
    return dir_, hess


def trilinear_sample_bwd2_scatter(volume, coords, h, ct, *, normalized=True,
                                  align_corners=True, bricked=None):
    """K2s wrapper.  Same contract as ``trilinear_sample_bwd2_scatter_plain``
    (``volume`` gives the shape and dtype; its values are not read): K2b's
    scatter kernels with the directional weights, in K2b's forms
    (``bricked``: None for ``k2b_bricked``'s rule)."""
    if volume.device.type == "cpu" and coords.device.type == "cpu":
        return trilinear_sample_bwd2_scatter_plain(
            volume, coords, h, ct, normalized=normalized, align_corners=align_corners)
    X, Y, Z, C, N = _k2_second_args("trilinear_sample_bwd2_scatter", volume, coords, h, ct)
    bf16 = volume.dtype == torch.bfloat16
    if bricked is None:
        bricked = k2b_bricked(volume, N)
    if bricked and not bf16:
        raise ValueError("trilinear_sample_bwd2_scatter: the bricked form is for a "
                         "bf16 volume")
    d_vol = (torch.empty if bricked else torch.zeros)(
        volume.shape, dtype=torch.float32, device=volume.device)
    d_out = torch.empty_like(volume) if bf16 else None
    bricks = torch.zeros(k2b_bricks(volume.shape), dtype=torch.int32,
                         device=volume.device) if bricked else None
    fn = _build.kernel_fn("grid_sample", "trilinear_sample_3d_bwd2_scatter",
                          [_P, _P, _P, _P, _I, _I, _I, _I, _L, _I, _I, _P, _P, _P])
    with _build.on_device(volume):
        _build.check(fn(coords.data_ptr(), h.data_ptr(), ct.data_ptr(), d_vol.data_ptr(),
                        X, Y, Z, C, N, int(normalized), int(align_corners),
                        _build.stream_of(volume),
                        d_out.data_ptr() if bf16 else None,
                        bricks.data_ptr() if bricked else None),
                     "trilinear_sample_3d_bwd2_scatter")
    _build.launches["trilinear_sample_3d_bwd2_scatter"] += 1
    return d_out if bf16 else d_vol


class _TrilinearSampleBwd(torch.autograd.Function):
    """K2b as a function of (volume, coords, ct), differentiable once more:
    its backward is K2 and K2b on the d_volume cotangent, K2g and K2s on
    the d_coords one; a third order raises."""

    @staticmethod
    def forward(ctx, volume, coords, ct, normalized, align_corners, need_volume,
                need_coords):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(volume, coords, ct)
        ctx.flags = (normalized, align_corners)
        return trilinear_sample_bwd(volume, coords, ct, normalized=normalized,
                                    align_corners=align_corners, need_volume=need_volume,
                                    need_coords=need_coords)

    @staticmethod
    @once_differentiable
    def backward(ctx, g_vol, g_co):
        volume, coords, ct = ctx.saved_tensors
        kw = dict(zip(("normalized", "align_corners"), ctx.flags))
        need_vol, need_co, need_ct = ctx.needs_input_grad[:3]
        d_vol = d_co = d_ct = None
        if g_vol is not None:
            g_vol = g_vol.contiguous()
            if need_ct:
                d_ct = trilinear_sample(g_vol, coords, **kw)
            if need_co:
                d_co = trilinear_sample_bwd(g_vol, coords, ct, need_volume=False, **kw)[1]
        if g_co is not None and (need_ct or need_co):
            dir_, hess = trilinear_sample_bwd2_gather(
                volume, coords, g_co.float().contiguous(), ct, need_dir=need_ct,
                need_hess=need_co, **kw)
            d_ct, d_co = _add(d_ct, dir_), _add(d_co, hess)
        if g_co is not None and need_vol:
            d_vol = trilinear_sample_bwd2_scatter(volume, coords, g_co.float().contiguous(),
                                                  ct, **kw)
        return d_vol, d_co, d_ct, None, None, None, None


class _TrilinearSample(torch.autograd.Function):
    """K2 with K2b as its backward, differentiable once more (K2g, K2s)."""

    @staticmethod
    def forward(ctx, volume, coords, normalized, align_corners):
        ctx.save_for_backward(volume, coords)
        ctx.flags = (normalized, align_corners)
        return trilinear_sample(volume, coords, normalized=normalized,
                                align_corners=align_corners)

    @staticmethod
    def backward(ctx, ct):
        volume, coords = ctx.saved_tensors
        args = (volume, coords, ct.float().contiguous(), *ctx.flags,
                ctx.needs_input_grad[0], ctx.needs_input_grad[1])
        d_vol, d_co = _TrilinearSampleBwd.apply(*args)
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


def lookup_volume(pts, volume, *, mode="bilinear", align_corners=None):
    """A dense volume (X, Y, Z, C), or a list of them concatenated on
    channels, sampled at world points (..., 3) in [-1, 1]^3: 'bilinear'
    (trilinear, K2), 'nearest', or 'grad' (trilinear too: it is twice
    differentiable, K2g / K2s, as the reference's ``gridsample_grad2``
    extension).  ``align_corners`` defaults to True for 'grad' and False
    otherwise, as the reference calls them (projector.py:392-420)."""
    if align_corners is None:
        align_corners = mode == "grad"
    vols = volume if isinstance(volume, (list, tuple)) else [volume]
    sample = nearest_sample_3d if mode == "nearest" else trilinear_sample_3d
    feats = [sample(v, pts, align_corners=align_corners) for v in vols]
    return feats[0] if len(feats) == 1 else torch.cat(feats, dim=-1)
