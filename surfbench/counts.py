"""The yardstick: the card's peaks and the bytes and operations each
hand-written kernel's function needs, counted from its arguments.

Copied from chip_smoke.py (commit 5b1d451: ``bound``, ``distinct_taps``,
``k3_bytes_read``, ``k4_bound``, ``bwd_bound``) and made to take any call
of a wrapper.  Conventions: each input byte that the function needs is
counted once and each output byte once, whatever a kernel reads again;
gathers count the distinct texels, voxels and table rows their taps
touch; an operation is a multiply or an add in f32.

* K1 ``bilinear_sample``: coordinates, output, distinct texels; 12
  operations a (point, channel).
* K1b ``bilinear_sample_bwd``: coordinates and cotangent, the image
  gradient written, the distinct texels again for d_coords; 4 a (point,
  channel) and output.
* K2 ``trilinear_sample``: coordinates, output, distinct voxels; 30.
* K2b ``trilinear_sample_bwd``: as K1b with 8 corners; 8 a term.
* K3 ``sparse_trilinear_multi``: points, outputs, distinct parent-table
  entries, validity flags and storage rows; 16 a (point, channel, sum).
* K3b ``sparse_trilinear_multi_bwd``: points, cotangents, the storage
  gradients written, the table entries; 16 a term.
* K4 ``gather_conv`` and K4w ``gather_conv_dw``: the table rows holding a
  present tap, each distinct input row once, the weights or cotangent,
  the output; 2 Cin Cout a present (row, tap) pair.
"""

from __future__ import annotations

import torch

from .reference.ops.sparse import child_offsets, lookup_rows

# NVIDIA H100 SXM data sheet, dense, at 700 W
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

# the wrappers whose calls are counted, by kernel: (module, function)
KERNELS = {
    "K1": ("surf_tpu_torch.ops.grid_sample", "bilinear_sample"),
    "K1b": ("surf_tpu_torch.ops.grid_sample", "bilinear_sample_bwd"),
    "K2": ("surf_tpu_torch.ops.grid_sample", "trilinear_sample"),
    "K2b": ("surf_tpu_torch.ops.grid_sample", "trilinear_sample_bwd"),
    "K3": ("surf_tpu_torch.ops.sparse", "sparse_trilinear_multi"),
    "K3b": ("surf_tpu_torch.ops.sparse", "sparse_trilinear_multi_bwd"),
    "K4": ("surf_tpu_torch.nn.reg_net", "gather_conv"),
    "K4w": ("surf_tpu_torch.nn.reg_net", "gather_conv_dw"),
}


def nbytes(t):
    return 0 if t is None else t.numel() * t.element_size()


def bound_s(bytes_moved, flops):
    """The least time the card can take: the longer of the bytes at the
    memory rate and the operations at the f32 rate."""
    return max(bytes_moved / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S)


def _unnormalize(c, size, align):
    return (c + 1.0) * 0.5 * (size - 1) if align else ((c + 1.0) * size - 1.0) * 0.5


def distinct_taps(sizes, co, align):
    """Distinct in-range texels (sizes (V, H, W), co (V, N, 2) as (x, y))
    or voxels (sizes (X, Y, Z), co (N, 3)) that the bilinear / trilinear
    taps at normalized coordinates ``co`` read."""
    if co.shape[-1] == 2:
        V, H, W = sizes
        axes = [(co[..., 1], H), (co[..., 0], W)]
        lead = torch.arange(V, device=co.device)[:, None] * (H * W)
    else:
        axes = [(co[:, a], sizes[a]) for a in range(3)]
        lead = 0
    base = [torch.floor(_unnormalize(c, n, align)).long() for c, n in axes]
    ids = []
    for k in range(2 ** len(axes)):
        ok = torch.ones_like(base[0], dtype=torch.bool)
        flat = torch.zeros_like(base[0])
        for a, (b0, (_, n)) in enumerate(zip(base, axes)):
            c = b0 + ((k >> a) & 1)
            ok &= (c >= 0) & (c < n)
            flat = flat * n + c
        ids.append((flat + lead)[ok])
    return torch.unique(torch.cat(ids)).numel()


def _normalized_2d(images, co, normalized, align):
    """Pixel coordinates as normalized ones (align_corners True)."""
    if normalized:
        return co, align
    H, W = images.shape[1:3]
    return torch.stack([co[..., 0] * (2.0 / (W - 1)) - 1.0,
                        co[..., 1] * (2.0 / (H - 1)) - 1.0], -1), True


def _stage_table_bytes(stages, pts, nearest):
    """Distinct parent-table entries (4 bytes), validity flags (1 byte) and
    storage rows (C f32, with ``nearest`` also the nearest voxel's) that the
    8 corners at ``pts`` need, over the stages."""
    off = child_offsets(pts.device)
    total = 0
    for g, s in stages:
        res, half = g.res, g.res // 2
        c0 = torch.floor((pts + 1.0) * 0.5 * (res - 1)).long()
        vox = [c0 + off[k] for k in range(8)]
        if nearest:
            vox.append(torch.floor(((pts + 1.0) * res - 1.0) * 0.5 + 0.5).long())
        vox = torch.cat(vox).clamp(0, res - 1)
        p = vox >> 1
        pidx = (p[:, 0] * half + p[:, 1]) * half + p[:, 2]
        rows, valid = lookup_rows(g, vox)
        present = g.parent_table.reshape(-1)[pidx] >= 0
        total += torch.unique(pidx).numel() * 4 + torch.unique(rows[present]).numel()
        if nearest:
            total += torch.unique(rows[valid]).numel() * s.shape[1] * 4
    return total


def _k4_counts(x, idx, live, c_out, fixed_bytes, row_bytes):
    """K4 / K4w: the table rows holding a present tap (with ``row_bytes``
    more bytes each), each distinct input row once, ``fixed_bytes``."""
    if live is not None:
        idx = torch.where(live[:, None], idx, torch.full_like(idx, -1))
    present = idx[idx >= 0]
    n_rows = int((idx >= 0).any(1).sum())
    T, Cin = idx.shape[1], x.shape[1]
    moved = n_rows * (T * 4 + row_bytes) + torch.unique(present).numel() * Cin * 4 \
        + fixed_bytes
    return moved, 2 * present.numel() * Cin * c_out


def call_counts(kernel, args, kwargs, out):
    """(bytes, operations) that one call of ``kernel``'s wrapper needs."""
    kw = kwargs
    if kernel == "K1":
        images, co = args[:2]
        V, N, C = out.shape
        co_n, align = _normalized_2d(images, co, kw.get("normalized", True),
                                     kw.get("align_corners", True))
        return (nbytes(co) + nbytes(out) + distinct_taps(images.shape[:3], co_n, align) * C * 4,
                V * N * C * 12)
    if kernel == "K1b":
        images, co, ct = args[:3]
        V, N, C = ct.shape
        need_img, need_co = kw.get("need_images", True), kw.get("need_coords", True)
        moved = nbytes(co) + nbytes(ct) + (nbytes(images) if need_img else 0)
        if need_co:
            co_n, align = _normalized_2d(images, co, kw.get("normalized", True),
                                         kw.get("align_corners", True))
            moved += distinct_taps(images.shape[:3], co_n, align) * C * 4 + nbytes(co)
        return moved, V * N * C * 4 * (2 * need_img + 2 * need_co)
    if kernel == "K2":
        vol, co = args[:2]
        n, C = out.shape
        voxels = distinct_taps(vol.shape[:3], co, kw.get("align_corners", True))
        return nbytes(co) + nbytes(out) + voxels * C * vol.element_size(), n * C * 30
    if kernel == "K2b":
        vol, co, ct = args[:3]
        N, C = ct.shape
        need_vol, need_co = kw.get("need_volume", True), kw.get("need_coords", True)
        moved = nbytes(co) + nbytes(ct) + (nbytes(vol) if need_vol else 0)
        if need_co:
            moved += distinct_taps(vol.shape[:3], co, kw.get("align_corners", True)) \
                * C * vol.element_size() + nbytes(co)
        return moved, N * C * 8 * (2 * need_vol + 2 * need_co)
    if kernel == "K3":
        stages, pts = args[:2]
        sums = 8 if kw.get("third") else 7 if kw.get("derivs") else 1
        n = pts.shape[0]
        ctot = sum(int(s.shape[1]) for _, s in stages)
        moved = nbytes(pts) + sum(nbytes(t) for t in out if torch.is_tensor(t)) \
            + _stage_table_bytes(stages, pts, nearest=True)
        return moved, n * ctot * sums * 8 * 2
    if kernel == "K3b":
        stages, pts = args[:2]
        names = ("ct_feats", "ct_jac", "ct_hmix", "ct_third")
        cts = list(args[2:6]) + [None] * (4 - len(args[2:6]))
        cts = [kw.get(k, c) for k, c in zip(names, cts)]
        n = pts.shape[0]
        ctot = sum(int(s.shape[1]) for _, s in stages)
        moved = nbytes(pts) + sum(nbytes(c) for c in cts if c is not None) \
            + sum(s.shape[0] * s.shape[1] * 4 for _, s in stages) \
            + _stage_table_bytes(stages, pts, nearest=False)
        terms = 1 + sum(3 if c.dim() == 3 else 1 for c in cts if c is not None)
        return moved, n * ctot * 8 * 2 * terms
    if kernel in ("K4", "K4w"):
        x, idx, third = args[:3]
        live = args[3] if len(args) > 3 else kw.get("live")
        if kernel == "K4":             # weights read, every output row written
            c_out = third.shape[2]
            return _k4_counts(x, idx, live, c_out, nbytes(third) + idx.shape[0] * c_out * 4, 0)
        # K4w: the cotangent rows of the rows holding a present tap, dW written
        c_out = third.shape[1]
        return _k4_counts(x, idx, live, c_out, idx.shape[1] * x.shape[1] * c_out * 4,
                          c_out * 4)
    raise KeyError(kernel)
