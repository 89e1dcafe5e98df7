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
with respect to the point.  ``StageFeatures`` wraps it for autograd so
that ``grad(sdf)`` and ``grad(grad(sdf) . 1)`` (the SDF net's gradient and
H.1) flow through the kernel's own derivative outputs.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from .. import _build


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

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


def _stage_plain(grid, storage, pts, derivs):
    """One stage of the plain K3: (feats, occ, jac, hmix) with jac/hmix
    (n, 3, C) or None."""
    res = grid.res
    n = pts.shape[0]
    nc = ((pts + 1.0) * res - 1.0) * 0.5
    ni = torch.floor(nc + 0.5).long()
    inside = ((ni >= 0) & (ni < res)).all(-1)
    _, nvalid = lookup_rows(grid, ni.clamp(0, res - 1))
    occ = nvalid & inside

    coords = (pts + 1.0) * 0.5 * (res - 1)
    c0 = torch.floor(coords)
    f = coords - c0
    c0i = c0.long()
    fx, fy, fz = f[:, 0], f[:, 1], f[:, 2]
    gx, gy, gz = 1.0 - fx, 1.0 - fy, 1.0 - fz
    s = 0.5 * (res - 1)
    C = storage.shape[-1]
    val = torch.zeros((n, C), dtype=torch.float32, device=pts.device)
    jac = hmix = None
    if derivs:
        jac = torch.zeros((n, 3, C), dtype=torch.float32, device=pts.device)
        hmix = torch.zeros((n, 3, C), dtype=torch.float32, device=pts.device)
    off = child_offsets(pts.device)
    for k in range(8):
        ox, oy, oz = (k >> 2) & 1, (k >> 1) & 1, k & 1
        corner = (c0i + off[k]).clamp(0, res - 1)
        rows, valid = lookup_rows(grid, corner)
        vals = gather_feats(storage, rows, valid)
        wx, wy, wz = (fx if ox else gx), (fy if oy else gy), (fz if oz else gz)
        val = val + vals * (wx * wy * wz)[:, None]
        if derivs:
            sx, sy, sz = (s if ox else -s), (s if oy else -s), (s if oz else -s)
            jac[:, 0] += vals * (sx * wy * wz)[:, None]
            jac[:, 1] += vals * (wx * sy * wz)[:, None]
            jac[:, 2] += vals * (wx * wy * sz)[:, None]
            hmix[:, 0] += vals * (sx * sy * wz)[:, None]
            hmix[:, 1] += vals * (sx * wy * sz)[:, None]
            hmix[:, 2] += vals * (wx * sy * sz)[:, None]
    return val, occ, jac, hmix


def sparse_trilinear_multi_plain(stages, pts, *, derivs=False):
    """Plain version of K3.  stages: [(VoxelGrid, storage (P*8, C)), ...];
    pts (n, 3) in [-1, 1]^3.  Returns (feats (n, sum C), occ (n,) bool,
    jac (n, 3, sum C) | None, hmix (n, 3, sum C) | None); hmix holds
    d2/dxdy, d2/dxdz, d2/dydz."""
    outs = [_stage_plain(g, s, pts, derivs) for g, s in stages]
    feats = torch.cat([o[0] for o in outs], dim=-1)
    occ = outs[0][1]
    for o in outs[1:]:
        occ = occ | o[1]
    if not derivs:
        return feats, occ, None, None
    return (feats, occ, torch.cat([o[2] for o in outs], dim=-1),
            torch.cat([o[3] for o in outs], dim=-1))


def sparse_trilinear_multi(stages, pts, *, derivs=False):
    """K3 wrapper: one launch over up to 4 stages.  Same contract as
    ``sparse_trilinear_multi_plain``."""
    pts = pts.detach()
    if pts.device.type == "cpu":
        return sparse_trilinear_multi_plain(stages, pts, derivs=derivs)
    if not 1 <= len(stages) <= 4:
        raise ValueError("sparse_trilinear_multi: 1 to 4 stages")
    pts = pts.float().contiguous()
    tensors = [pts]
    for g, s in stages:
        if s.dtype != torch.float32 or g.parent_table.dtype != torch.int32 \
                or g.cvalid.dtype != torch.bool:
            raise ValueError("sparse_trilinear_multi: needs int32 tables, bool "
                             "cvalid and f32 storage")
        tensors += [g.parent_table, g.cvalid, s]
    _build.require_cuda("sparse_trilinear_multi", *tensors)
    n = pts.shape[0]
    Cs = [int(s.shape[-1]) for _, s in stages]
    ctot = sum(Cs)
    dev = pts.device
    feats = torch.empty((n, ctot), dtype=torch.float32, device=dev)
    occ = torch.empty((n,), dtype=torch.bool, device=dev)
    jac = hmix = None
    if derivs:
        jac = torch.empty((n, 3, ctot), dtype=torch.float32, device=dev)
        hmix = torch.empty((n, 3, ctot), dtype=torch.float32, device=dev)
    ns = len(stages)
    arr_l = ctypes.c_longlong * ns
    arr_i = ctypes.c_int * ns
    tables = arr_l(*[g.parent_table.data_ptr() for g, _ in stages])
    cvalids = arr_l(*[g.cvalid.data_ptr() for g, _ in stages])
    storages = arr_l(*[s.data_ptr() for _, s in stages])
    res = arr_i(*[g.res for g, _ in stages])
    cs = arr_i(*Cs)
    fn = _build.kernel_fn("sparse_trilinear", "sparse_trilinear_multi",
                          [_P, _L, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P])
    _build.check(fn(pts.data_ptr(), n, ns, ctypes.addressof(tables),
                    ctypes.addressof(cvalids), ctypes.addressof(storages),
                    ctypes.addressof(res), ctypes.addressof(cs),
                    feats.data_ptr(), occ.data_ptr(),
                    jac.data_ptr() if derivs else None,
                    hmix.data_ptr() if derivs else None,
                    _build.stream_of(pts)), "sparse_trilinear_multi")
    _build.launches["sparse_trilinear_multi"] += 1
    return feats, occ, jac, hmix


def _mixed_times(gg, g, hmix):
    """d/dpts of sum_a gg[a] * (g . J[a]) given the mixed second
    derivatives (the pure ones vanish inside a trilinear cell)."""
    S = torch.einsum("nc,nkc->nk", g, hmix)          # S_xy, S_xz, S_yz
    sxy, sxz, syz = S[:, 0], S[:, 1], S[:, 2]
    gx, gy, gz = gg[:, 0], gg[:, 1], gg[:, 2]
    return torch.stack([gy * sxy + gz * sxz,
                        gx * sxy + gz * syz,
                        gx * sxz + gy * syz], dim=-1)


class _JacobianT(torch.autograd.Function):
    """d_pts = J^T g, differentiable once more (through g and, via the
    mixed second derivatives, through pts)."""

    @staticmethod
    def forward(ctx, pts, g, jac, hmix):
        ctx.save_for_backward(g, jac, hmix)
        return torch.einsum("nc,nac->na", g, jac)

    @staticmethod
    def backward(ctx, gg):
        g, jac, hmix = ctx.saved_tensors
        d_g = torch.einsum("na,nac->nc", gg, jac)
        return _mixed_times(gg, g, hmix), d_g, None, None


class StageFeatures(torch.autograd.Function):
    """(feats, occ) = K3(stages, pts) with gradients w.r.t. ``pts`` only
    (twice differentiable)."""

    @staticmethod
    def forward(ctx, pts, stages):
        feats, occ, jac, hmix = sparse_trilinear_multi(
            stages, pts, derivs=pts.requires_grad)
        if jac is not None:
            ctx.save_for_backward(pts, jac, hmix)
        ctx.mark_non_differentiable(occ)
        return feats, occ

    @staticmethod
    def backward(ctx, g_feats, _g_occ):
        pts, jac, hmix = ctx.saved_tensors
        return _JacobianT.apply(pts, g_feats, jac, hmix), None


def stage_features(stages, pts):
    """Concatenated stage features (n, sum C) and nearest occupancy (n,),
    differentiable (twice) w.r.t. ``pts`` when it requires grad."""
    if pts.requires_grad and torch.is_grad_enabled():
        return StageFeatures.apply(pts, stages)
    feats, occ, _, _ = sparse_trilinear_multi(stages, pts)
    return feats, occ


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
