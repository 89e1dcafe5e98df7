"""Sparse voxel sets of the cascade (torch counterpart of
surf_tpu/ops/sparse.py).

A stage at resolution R keeps its voxels in parent blocks: ``P`` parent
cells at R/2, each owning its 2x2x2 children, with a dense int32
``parent_table`` at R/2 mapping a parent coordinate to its row (or -1).
Feature storage for a stage is any ``(P * 8, C)`` tensor indexed by
``row = parent_table[v >> 1] * 8 + slot(v)``.

The hand-written kernel K3 (csrc/sparse_trilinear.cu) serves every render
and mesh lookup: ``sparse_trilinear_multi`` returns the features of all
stages, their nearest occupancy and, in render mode, the derivatives
with respect to the point.  ``SparseTrilinear`` wraps it for autograd so
that ``grad(sdf)`` and ``grad(grad(sdf) . 1)`` (the SDF net's gradient and
H.1) flow through the kernel's own derivative outputs, and so that all of
them are differentiable with respect to the stage storages (training):
the storage gradient is the kernel K3b (``sparse_trilinear_multi_bwd``).
In this frozen copy (the benchmark's reference) both wrappers call the
plain versions beside them, on any device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


def child_offsets(device=None):
    """(8, 3) int64: slot k -> offset ((k>>2)&1, (k>>1)&1, k&1)."""
    k = torch.arange(8, device=device)
    return torch.stack([(k >> 2) & 1, (k >> 1) & 1, k & 1], dim=-1)


class VoxelGrid(NamedTuple):
    """Capacity-padded sparse voxel set at resolution ``res``.

    parents:      (P, 3) int64 parent coords at res//2
    pvalid:       (P,) bool
    cvalid:       (P*8,) bool, row-major by (parent, slot)
    parent_table: (res//2,)*3 int32, parent coord -> row or -1
    """
    parents: torch.Tensor
    pvalid: torch.Tensor
    cvalid: torch.Tensor
    parent_table: torch.Tensor

    @property
    def res(self) -> int:
        return self.parent_table.shape[0] * 2

    @property
    def capacity(self) -> int:
        return self.parents.shape[0] * 8

    def child_coords(self):
        """(P*8, 3) int64 voxel coords of every child slot."""
        off = child_offsets(self.parents.device)
        return (self.parents[:, None, :] * 2 + off[None]).reshape(-1, 3)


def build_parent_table(parents, pvalid, half_res: int):
    """Scatter parent rows into a dense int32 lookup grid."""
    n3 = half_res ** 3
    flat = torch.full((n3 + 1,), -1, dtype=torch.int32, device=parents.device)
    p = parents.clamp(0, half_res - 1)
    idx = (p[:, 0] * half_res + p[:, 1]) * half_res + p[:, 2]
    idx = torch.where(pvalid, idx, torch.full_like(idx, n3))
    rows = torch.arange(parents.shape[0], dtype=torch.int32, device=parents.device)
    flat[idx] = rows
    return flat[:n3].reshape(half_res, half_res, half_res)


def make_grid(parents, pvalid, cvalid, res: int) -> VoxelGrid:
    parents = parents.long()
    return VoxelGrid(parents, pvalid, cvalid.reshape(-1),
                     build_parent_table(parents, pvalid, res // 2))


def dense_base_grid(res: int, device=None) -> VoxelGrid:
    """Fully dense stage-0 grid in the sparse structure."""
    half = res // 2
    r = torch.arange(half, device=device)
    parents = torch.stack(torch.meshgrid(r, r, r, indexing="ij"), -1).reshape(-1, 3)
    pvalid = torch.ones((half ** 3,), dtype=torch.bool, device=device)
    cvalid = torch.ones((half ** 3 * 8,), dtype=torch.bool, device=device)
    return make_grid(parents, pvalid, cvalid, res)


def lookup_rows(grid: VoxelGrid, coords):
    """Voxel coords (..., 3) int -> (rows (...,), valid (...,))."""
    res = grid.res
    half = res // 2
    in_bounds = ((coords >= 0) & (coords < res)).all(-1)
    c = coords.clamp(0, res - 1)
    p = c >> 1
    k = ((c[..., 0] & 1) << 2) | ((c[..., 1] & 1) << 1) | (c[..., 2] & 1)
    pidx = (p[..., 0] * half + p[..., 1]) * half + p[..., 2]
    prow = grid.parent_table.reshape(-1)[pidx].long()
    row = prow.clamp(min=0) * 8 + k
    valid = in_bounds & (prow >= 0) & grid.cvalid[row]
    return row, valid


def gather_feats(storage, rows, valid):
    """storage (P*8, C); rows/valid (...,) -> (..., C), zero where invalid."""
    out = storage[rows.reshape(-1)].reshape(*rows.shape, storage.shape[-1])
    return out * valid[..., None].to(storage.dtype)


# ---------------------------------------------------------------------------
# K3: sparse trilinear features of all stages + occupancy (+ derivatives)
# ---------------------------------------------------------------------------

def _corner_terms(f, s, k):
    """Per-corner coefficients of slot k at cell fractions f (n, 3) and
    derivative scale s: (w, (dw/dx, dw/dy, dw/dz), (d2w/dxdy, d2w/dxdz,
    d2w/dydz), d3w/dxdydz)."""
    ox, oy, oz = (k >> 2) & 1, (k >> 1) & 1, k & 1
    fx, fy, fz = f[:, 0], f[:, 1], f[:, 2]
    wx, wy, wz = (fx if ox else 1.0 - fx), (fy if oy else 1.0 - fy), \
        (fz if oz else 1.0 - fz)
    sx, sy, sz = (s if ox else -s), (s if oy else -s), (s if oz else -s)
    return (wx * wy * wz, (sx * wy * wz, wx * sy * wz, wx * wy * sz),
            (sx * sy * wz, sx * wy * sz, wx * sy * sz), sx * sy * sz)


def _cell(grid, pts):
    """Trilinear cell of ``pts`` at the stage's resolution: (fractions
    (n, 3), derivative scale, [(rows, valid) of the 8 corners, clamped to
    the border before the lookup])."""
    res = grid.res
    coords = (pts + 1.0) * 0.5 * (res - 1)
    c0 = torch.floor(coords)
    c0i = c0.long()
    off = child_offsets(pts.device)
    corners = [lookup_rows(grid, (c0i + off[k]).clamp(0, res - 1)) for k in range(8)]
    return coords - c0, 0.5 * (res - 1), corners


def _stage_plain(grid, storage, pts, derivs, third=False):
    """One stage of the plain K3: (feats, occ, jac, hmix, third) with
    jac/hmix (n, 3, C) or None, third (n, C) or None."""
    res = grid.res
    n = pts.shape[0]
    nc = ((pts + 1.0) * res - 1.0) * 0.5
    ni = torch.floor(nc + 0.5).long()
    inside = ((ni >= 0) & (ni < res)).all(-1)
    _, nvalid = lookup_rows(grid, ni.clamp(0, res - 1))
    occ = nvalid & inside

    f, s, corners = _cell(grid, pts)
    C = storage.shape[-1]
    val = torch.zeros((n, C), dtype=torch.float32, device=pts.device)
    jac = hmix = t3 = None
    if derivs:
        jac = torch.zeros((n, 3, C), dtype=torch.float32, device=pts.device)
        hmix = torch.zeros((n, 3, C), dtype=torch.float32, device=pts.device)
    if third:
        t3 = torch.zeros((n, C), dtype=torch.float32, device=pts.device)
    for k, (rows, valid) in enumerate(corners):
        vals = gather_feats(storage, rows, valid)
        w, dw, d2w, d3w = _corner_terms(f, s, k)
        val = val + vals * w[:, None]
        if derivs:
            for a in range(3):
                jac[:, a] += vals * dw[a][:, None]
                hmix[:, a] += vals * d2w[a][:, None]
        if third:
            t3 += vals * d3w
    return val, occ, jac, hmix, t3


def sparse_trilinear_multi_plain(stages, pts, *, derivs=False, third=False):
    """Plain version of K3.  stages: [(VoxelGrid, storage (P*8, C)), ...];
    pts (n, 3) in [-1, 1]^3.  Returns (feats (n, sum C), occ (n,) bool,
    jac (n, 3, sum C) | None, hmix (n, 3, sum C) | None), and with
    ``third`` also d3/dxdydz (n, sum C); hmix holds d2/dxdy, d2/dxdz,
    d2/dydz."""
    outs = [_stage_plain(g, s, pts, derivs or third, third) for g, s in stages]
    feats = torch.cat([o[0] for o in outs], dim=-1)
    occ = outs[0][1]
    for o in outs[1:]:
        occ = occ | o[1]
    jac = hmix = t3 = None
    if derivs or third:
        jac = torch.cat([o[2] for o in outs], dim=-1)
        hmix = torch.cat([o[3] for o in outs], dim=-1)
    if third:
        t3 = torch.cat([o[4] for o in outs], dim=-1)
        return feats, occ, jac, hmix, t3
    return feats, occ, jac, hmix


def sparse_trilinear_multi(stages, pts, *, derivs=False, third=False):
    """K3 wrapper: one launch over up to 4 stages.  Same contract as
    ``sparse_trilinear_multi_plain`` (``third`` takes the training
    variant of the kernel)."""
    pts = pts.detach()
    return sparse_trilinear_multi_plain(stages, pts, derivs=derivs, third=third)


# ---------------------------------------------------------------------------
# K3b: gradient with respect to the stage storages
# ---------------------------------------------------------------------------

def sparse_trilinear_multi_bwd_plain(stages, pts, ct_feats=None, ct_jac=None,
                                     ct_hmix=None, ct_third=None):
    """Plain version of K3b: the storage gradients [(P*8, C) per stage] of
    ``sum(ct_feats * feats + ct_jac * jac + ct_hmix * hmix + ct_third *
    third)``; any cotangent may be None (zero)."""
    grads, coff = [], 0
    for grid, storage in stages:
        C = storage.shape[-1]
        sl = slice(coff, coff + C)
        coff += C
        f, s, corners = _cell(grid, pts)
        d = torch.zeros((storage.shape[0], C), dtype=torch.float32, device=pts.device)
        for k, (rows, valid) in enumerate(corners):
            w, dw, d2w, d3w = _corner_terms(f, s, k)
            coef = 0.0
            if ct_feats is not None:
                coef = coef + ct_feats[:, sl] * w[:, None]
            for a in range(3):
                if ct_jac is not None:
                    coef = coef + ct_jac[:, a, sl] * dw[a][:, None]
                if ct_hmix is not None:
                    coef = coef + ct_hmix[:, a, sl] * d2w[a][:, None]
            if ct_third is not None:
                coef = coef + ct_third[:, sl] * d3w
            if isinstance(coef, torch.Tensor):
                d.index_add_(0, rows, coef * valid[:, None].float())
        grads.append(d)
    return grads


def sparse_trilinear_multi_bwd(stages, pts, ct_feats=None, ct_jac=None,
                               ct_hmix=None, ct_third=None, counts=None):
    """K3b wrapper: one launch over up to 4 stages.  Same contract as
    ``sparse_trilinear_multi_bwd_plain``.  ``counts``, a zeroed (2,) int64
    CUDA tensor, receives the (point, corner, channel) scatters of nonzero
    cotangents and the atomics the kernel issued (the rest were merged in
    registers)."""
    pts = pts.detach()
    return sparse_trilinear_multi_bwd_plain(stages, pts, ct_feats, ct_jac,
                                            ct_hmix, ct_third)


class _StorageGrad(torch.autograd.Function):
    """K3b inside a backward that builds a graph (``create_graph``): the
    storage gradient is exact, and differentiating it once more raises
    (nothing in the training graph asks for it)."""

    @staticmethod
    def forward(ctx, stages, pts, ct_feats, ct_jac, ct_hmix, ct_third):
        return tuple(sparse_trilinear_multi_bwd(stages, pts, ct_feats, ct_jac,
                                                ct_hmix, ct_third))

    @staticmethod
    def backward(ctx, *_):
        raise NotImplementedError("sparse_trilinear: the derivative of the storage "
                                  "gradient is not implemented")


def _pts_grad(ct_feats, ct_jac, ct_hmix, jac, hmix, third):
    """d/dpts of sum(ct_feats * F + ct_jac * J + ct_hmix * H) inside a
    trilinear cell: J gives the first term, the mixed second derivatives
    the second (the pure ones vanish), d3/dxdydz the third (every other
    third derivative vanishes).  Differentiable through jac, hmix, third."""
    d = torch.zeros_like(jac[:, :, 0])
    if ct_feats is not None:
        d = d + torch.einsum("nc,nac->na", ct_feats, jac)
    if ct_jac is not None:
        hxy, hxz, hyz = hmix[:, 0], hmix[:, 1], hmix[:, 2]
        gx, gy, gz = ct_jac[:, 0], ct_jac[:, 1], ct_jac[:, 2]
        d = d + torch.stack([(gy * hxy + gz * hxz).sum(-1),
                             (gx * hxy + gz * hyz).sum(-1),
                             (gx * hxz + gy * hyz).sum(-1)], -1)
    if ct_hmix is not None:
        # d(H_xy)/dz = d(H_xz)/dy = d(H_yz)/dx = d3/dxdydz
        d = d + torch.stack([(ct_hmix[:, 2] * third).sum(-1),
                             (ct_hmix[:, 1] * third).sum(-1),
                             (ct_hmix[:, 0] * third).sum(-1)], -1)
    return d


class SparseTrilinear(torch.autograd.Function):
    """K3 as a function of (pts, storage_0..3): outputs (feats, occ) and,
    when ``pts`` requires grad, the derivative outputs jac and hmix (and
    third, when a storage requires grad as well), every one
    differentiable with respect to every storage (K3b) and to ``pts``
    (through the next derivative output), to any order the training graph
    asks for."""

    @staticmethod
    def forward(ctx, pts, grids, derivs, third, *storages):
        stages = list(zip(grids, storages))
        outs = sparse_trilinear_multi(stages, pts, derivs=derivs, third=third)
        ctx.mark_non_differentiable(outs[1])
        # outputs that no gradient reaches come to backward as None, not
        # zeros: their terms (and K3b's reads of them) are skipped
        ctx.set_materialize_grads(False)
        ctx.grids, ctx.derivs, ctx.third = grids, derivs, third
        keep = [o for o in outs if o is not None and o.dtype != torch.bool]
        ctx.save_for_backward(pts, *storages, *keep)
        return tuple(o for o in outs if o is not None)

    @staticmethod
    def backward(ctx, ct_feats, _ct_occ, *cts):
        saved = ctx.saved_tensors
        ns = len(ctx.grids)
        pts, storages, outs = saved[0], saved[1:1 + ns], saved[1 + ns:]
        stages = list(zip(ctx.grids, storages))
        ct_jac, ct_hmix, ct_third = (list(cts) + [None] * 3)[:3]
        d_pts = None
        if ctx.needs_input_grad[0]:
            _, jac, hmix = outs[:3]
            third = outs[3] if ctx.third else None
            if ct_hmix is not None and third is None:
                # no storage needs a gradient: d3/dxdydz is a constant here
                third = sparse_trilinear_multi([(g, s.detach()) for g, s in stages],
                                               pts, third=True)[4]
            d_pts = _pts_grad(ct_feats, ct_jac, ct_hmix, jac, hmix, third)
        d_st = [None] * ns
        if any(ctx.needs_input_grad[4:]) and any(
                c is not None for c in (ct_feats, ct_jac, ct_hmix, ct_third)):
            args = (stages, pts, ct_feats, ct_jac, ct_hmix, ct_third)
            d_st = _StorageGrad.apply(*args) if torch.is_grad_enabled() \
                else sparse_trilinear_multi_bwd(*args)
            d_st = [d if need else None
                    for d, need in zip(d_st, ctx.needs_input_grad[4:])]
        return (d_pts, None, None, None, *d_st)


def stage_features(stages, pts):
    """Concatenated stage features (n, sum C) and nearest occupancy (n,),
    differentiable with respect to ``pts`` (to third order) and to every
    storage when they require grad."""
    storages = [s for _, s in stages]
    derivs = torch.is_grad_enabled() and pts.requires_grad
    third = derivs and any(s.requires_grad for s in storages)
    outs = SparseTrilinear.apply(pts, tuple(g for g, _ in stages), derivs, third,
                                 *storages)
    return outs[0], outs[1]


def sparse_trilinear(grid: VoxelGrid, storage, pts):
    """Sparse trilinear interpolation of one stage at points (..., 3) ->
    (..., C): align_corners=True voxel centres, corners clamped to the
    border before the lookup, absent voxels read 0."""
    lead = pts.shape[:-1]
    feats, _, _, _ = sparse_trilinear_multi([(grid, storage)], pts.reshape(-1, 3))
    return feats.reshape(*lead, storage.shape[-1])


def occupancy_nearest(grid: VoxelGrid, pts, *, align_corners=False):
    """Nearest-voxel occupancy at world points (F.grid_sample nearest:
    floor(x + 0.5) of the unnormalized coordinate)."""
    res = grid.res
    if align_corners:
        coords = (pts + 1.0) * 0.5 * (res - 1)
    else:
        coords = ((pts + 1.0) * res - 1.0) * 0.5
    idx = torch.floor(coords + 0.5).long()
    inside = ((idx >= 0) & (idx < res)).all(-1)
    _, valid = lookup_rows(grid, idx.clamp(0, res - 1))
    return valid & inside


# ---------------------------------------------------------------------------
# cascade geometry
# ---------------------------------------------------------------------------

def scatter_to_dense(grid: VoxelGrid, values, *, background=None):
    """Per-child values (P*8, C) -> dense (res, res, res, C); invalid
    children dropped; ``background`` (updated in place) seeds the volume."""
    res = grid.res
    C = values.shape[-1]
    cc = grid.child_coords()[grid.cvalid]
    vol = torch.zeros((res, res, res, C), dtype=values.dtype,
                      device=values.device) if background is None else background
    vol[cc[:, 0], cc[:, 1], cc[:, 2]] = values.reshape(-1, C)[grid.cvalid].to(vol.dtype)
    return vol


def compact_parents(scores, pvalid, capacity: int):
    """Up to ``capacity`` parents by descending score, valid first; ties
    keep the lower index first (``lax.top_k``'s order), so on overflow the
    same parents as the reference are dropped.  Returns (sel_idx
    (capacity,) int64, sel_valid (capacity,) bool)."""
    s = torch.where(pvalid, scores, torch.full_like(scores, -float("inf")))
    k = min(capacity, s.shape[0])
    top, order = torch.sort(s, descending=True, stable=True)
    sel_idx, sel_valid = order[:k], top[:k] > -float("inf")
    if k < capacity:
        pad = capacity - k
        sel_idx = torch.cat([sel_idx, sel_idx.new_zeros(pad)])
        sel_valid = torch.cat([sel_valid, sel_valid.new_zeros(pad)])
    return sel_idx, sel_valid


def occupied_blocks_host(stages, grid_res: int, block: int):
    """Host map of which ``block``^3 tiles of a ``grid_res``^3 lattice over
    [-1,1]^3 any active voxel covers under ``occupancy_nearest`` (voxel v
    covers lattice i in [v(R-1)/res, (v+1)(R-1)/res]).  A tile no voxel
    covers is pinned to SDF +100 everywhere and can be skipped exactly.
    Returns (nb, nb, nb) bool."""
    R, B = int(grid_res), int(block)
    nb = -(-R // B)
    occ = np.zeros((nb, nb, nb), dtype=bool)
    for grid, _ in stages:
        res = grid.res
        cc = grid.child_coords()[grid.cvalid].cpu().numpy().astype(np.int64)
        if cc.size == 0:
            continue
        lo = np.clip((cc * (R - 1)) // res // B, 0, nb - 1)
        hi = np.clip(((cc + 1) * (R - 1)) // res // B, 0, nb - 1)
        span = int((hi - lo).max())
        for dx in range(span + 1):
            bx = np.minimum(lo[:, 0] + dx, hi[:, 0])
            for dy in range(span + 1):
                by = np.minimum(lo[:, 1] + dy, hi[:, 1])
                for dz in range(span + 1):
                    occ[bx, by, np.minimum(lo[:, 2] + dz, hi[:, 2])] = True
    return occ


def voxel_centers_world(coords, res: int):
    """Voxel integer coords -> world centres in [-1,1]^3 (voxel size
    2/(res-1))."""
    return coords.float() * (2.0 / (res - 1)) - 1.0
