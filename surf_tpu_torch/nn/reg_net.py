"""Sparse 3D cost-regularization U-Net per cascade stage (torch counterpart
of surf_tpu/nn/reg_net.py): conv0 -> three stride-2 encoder levels ->
three transposed-conv decoder levels with additive skips -> bias-free
linear head.  Returns ``(out, mid)``: ``out[:, :1]`` feeds the matching
volume, ``out[:, 1:]`` is the stage's feature storage, ``mid`` seeds the
next stage.  Inference only (batch norm with running statistics).

* ``apply_dense`` (res <= 176): densify the active set and run
  ``F.conv3d`` with per-level activity masks — exactly submanifold.
* ``apply_hybrid`` (352^3, 704^3): the two finest levels run over the
  capacity-padded voxel lists with the hand-written gather-GEMM kernel K4
  (csrc/gather_conv.cu); levels at R/4 and below densify.  Each sparse
  conv variant is a (rows, 27) neighbour-index table built here from the
  VoxelGrid parent table (-1 = absent neighbour, reads zero).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from .core import (conv_init, conv3d_apply, conv3d_transpose_apply,
                   batch_norm_init, masked_batch_norm_apply, relu)
from .. import _build
from ..ops import sparse as sp

# tap t = (dx+1)*9 + (dy+1)*3 + (dz+1): the row-major order of a
# (3, 3, 3, Cin, Cout) kernel reshaped to (27, Cin, Cout)
_OFFSETS = [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)]
_OFFSETS_NP = np.array(_OFFSETS, np.int64)


def _tap_index(d):
    return (d[0] + 1) * 9 + (d[1] + 1) * 3 + (d[2] + 1)


def _build_subm_child_map():
    """(8, 27, 2): child slot k, tap t -> (parent-neighbourhood tap, slot')."""
    m = np.zeros((8, 27, 2), np.int64)
    for k in range(8):
        kb = [(k >> 2) & 1, (k >> 1) & 1, k & 1]
        for t, off in enumerate(_OFFSETS):
            d, s2 = [], 0
            for a in range(3):
                v = kb[a] + off[a]
                d.append((v - (v & 1)) // 2)
                s2 = (s2 << 1) | (v & 1)
            m[k, t] = (_tap_index(d), s2)
    return m


def _build_down_map():
    """(27, 2): child at 2p + off -> (parent-neighbourhood tap, slot)."""
    m = np.zeros((27, 2), np.int64)
    for t, off in enumerate(_OFFSETS):
        d, s2 = [], 0
        for v in off:
            d.append((v - (v & 1)) // 2)
            s2 = (s2 << 1) | (v & 1)
        m[t] = (_tap_index(d), s2)
    return m


def _build_up_map():
    """(8, 27): child slot k, tap t -> parent-neighbourhood tap of the
    transposed stride-2 conv's source (k - off even per axis), or -1."""
    m = np.full((8, 27), -1, np.int64)
    for k in range(8):
        kb = [(k >> 2) & 1, (k >> 1) & 1, k & 1]
        for t, off in enumerate(_OFFSETS):
            v = [kb[a] - off[a] for a in range(3)]
            if all((x & 1) == 0 for x in v):
                m[k, t] = _tap_index([x // 2 for x in v])
    return m


_SUBM_CHILD_MAP = _build_subm_child_map()
_DOWN_MAP = _build_down_map()
_UP_MAP = _build_up_map()


# ---------------------------------------------------------------------------
# K4: gather-GEMM
# ---------------------------------------------------------------------------

def gather_conv_plain(x, idx, w):
    """Plain version of K4: out[r] = sum_t x[idx[r, t]] @ w[t] (idx -1 ->
    zero).  x (M, Cin); idx (R, T); w (T, Cin, Cout) -> (R, Cout)."""
    M, Cin = x.shape
    T, _, Cout = w.shape
    xpad = torch.cat([x, x.new_zeros((1, Cin))])
    ii = torch.where(idx >= 0, idx.long(), torch.full_like(idx, M, dtype=torch.long))
    g = xpad[ii.reshape(-1)].reshape(idx.shape[0], T * Cin)
    return g @ w.reshape(T * Cin, Cout)


def gather_conv(x, idx, w):
    """K4 wrapper.  x (M, Cin) f32; idx (R, T) int; w (T, Cin, Cout) f32
    with T <= 27 and Cin, Cout <= 32 -> (R, Cout) f32."""
    if x.device.type == "cpu":
        return gather_conv_plain(x, idx, w)
    x = x.float().contiguous()
    idx = idx.to(torch.int32).contiguous()
    w = w.float().contiguous()
    _build.require_cuda("gather_conv", x, idx, w)
    R, T = idx.shape
    Cin, Cout = w.shape[1], w.shape[2]
    if T > 27 or Cin > 32 or Cout > 32 or x.shape[1] != Cin or w.shape[0] != T:
        raise ValueError("gather_conv: needs T <= 27, Cin, Cout <= 32 and "
                         "matching shapes")
    if x.shape[0] >= 2 ** 31:
        raise ValueError("gather_conv: int32 row indices")
    out = torch.empty((R, Cout), dtype=torch.float32, device=x.device)
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn = _build.kernel_fn("gather_conv", "gather_conv", [P, P, P, P, L, I, I, I, P])
    _build.check(fn(x.data_ptr(), idx.data_ptr(), w.data_ptr(), out.data_ptr(),
                    R, T, Cin, Cout, _build.stream_of(x)), "gather_conv")
    _build.launches["gather_conv"] += 1
    return out


def _w27(w):
    return w.reshape(27, w.shape[3], w.shape[4])


# ---------------------------------------------------------------------------
# neighbour-index tables (one per conv variant)
# ---------------------------------------------------------------------------

def _offsets(device):
    return torch.as_tensor(_OFFSETS_NP, device=device)


def parent_neighbor_rows(grid):
    """(P, 27) int64: row of each parent's 3^3 neighbourhood (-1 = none)."""
    half = grid.res // 2
    nb = grid.parents[:, None, :] + _offsets(grid.parents.device)
    inb = ((nb >= 0) & (nb < half)).all(-1)
    c = nb.clamp(0, half - 1)
    idx = (c[..., 0] * half + c[..., 1]) * half + c[..., 2]
    prow = grid.parent_table.reshape(-1)[idx].long()
    return torch.where(inb, prow, torch.full_like(prow, -1))


def _subm_child_index(nbr):
    """Children -> children, (P*8, 27)."""
    m = torch.as_tensor(_SUBM_CHILD_MAP, device=nbr.device)
    nk = nbr[:, m[..., 0]]                                  # (P, 8, 27)
    idx = torch.where(nk >= 0, nk * 8 + m[..., 1], torch.full_like(nk, -1))
    return idx.reshape(-1, 27)


def _down_child_index(nbr):
    """Children -> parents (stride 2), (P, 27)."""
    m = torch.as_tensor(_DOWN_MAP, device=nbr.device)
    nk = nbr[:, m[:, 0]]
    return torch.where(nk >= 0, nk * 8 + m[:, 1], torch.full_like(nk, -1))


def _up_child_index(nbr):
    """Parents -> children (transposed stride 2), (P*8, 27)."""
    m = torch.as_tensor(_UP_MAP, device=nbr.device)
    nk = nbr[:, m.clamp(min=0)]                             # (P, 8, 27)
    idx = torch.where(m >= 0, nk, torch.full_like(nk, -1))
    return idx.reshape(-1, 27)


def _parent_rows_at(grid, pcoords, pactive):
    """Parent rows at parent coords (..., 3), -1 where absent/inactive."""
    half = grid.res // 2
    inb = ((pcoords >= 0) & (pcoords < half)).all(-1)
    c = pcoords.clamp(0, half - 1)
    prow = grid.parent_table.reshape(-1)[(c[..., 0] * half + c[..., 1]) * half
                                         + c[..., 2]].long()
    valid = inb & (prow >= 0) & pactive[prow.clamp(min=0)]
    return torch.where(valid, prow, torch.full_like(prow, -1))


def _down_dense_index(grid, pactive):
    """Parents -> the R/4 cell of each parent (stride 2), (P, 27)."""
    cells = grid.parents >> 1
    src = cells[:, None, :] * 2 + _offsets(cells.device)
    return _parent_rows_at(grid, src, pactive)


def _up_dense_index(grid, n):
    """Dense R/4 cells (n^3 rows) -> parents (transposed stride 2), (P, 27)."""
    src2 = grid.parents[:, None, :] - _offsets(grid.parents.device)
    even = ((src2 & 1) == 0).all(-1)
    src = src2 >> 1
    inb = ((src >= 0) & (src < n)).all(-1) & even
    sc = src.clamp(0, n - 1)
    idx = (sc[..., 0] * n + sc[..., 1]) * n + sc[..., 2]
    return torch.where(inb, idx, torch.full_like(idx, -1))


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _block_init(gen, c_in, c_out, device):
    bn_p, bn_s = batch_norm_init(c_out, device)
    return {"conv": conv_init(gen, c_in, c_out, 3, 3, device), "bn": bn_p}, {"bn": bn_s}


def init(gen, d_in, d_out=8, d_base=8, device=None):
    specs = [("conv0", d_in, d_base),
             ("conv1", d_base, d_base * 2), ("conv2", d_base * 2, d_base * 2),
             ("conv3", d_base * 2, d_base * 4), ("conv4", d_base * 4, d_base * 4),
             ("conv5", d_base * 4, d_base * 8), ("conv6", d_base * 8, d_base * 8),
             ("conv7", d_base * 8, d_base * 4), ("conv9", d_base * 4, d_base * 2),
             ("conv11", d_base * 2, d_base)]
    params, state = {}, {}
    for name, ci, co in specs:
        params[name], state[name] = _block_init(gen, ci, co, device)
    params["out_lin"] = {"w": torch.randn((d_base, d_out), generator=gen,
                                          device=device) / d_base ** 0.5}
    return params, state


def init_list(gen, conf, device=None):
    ps, ss = [], []
    for di, do, db in zip(conf.get_list("d_in"), conf.get_list("d_out"),
                          conf.get_list("d_base")):
        p, s = init(gen, di, do, db, device)
        ps.append(p)
        ss.append(s)
    return ps, ss


# ---------------------------------------------------------------------------
# dense path
# ---------------------------------------------------------------------------

def _maxpool2(mask):
    """(X, Y, Z) bool -> (X/2, Y/2, Z/2) bool: any child active."""
    return F.max_pool3d(mask.float()[None, None], 2)[0, 0] > 0


def _dense_block(p, s, x, mask, *, stride, transposed=False):
    """x (1, X, Y, Z, C); mask of the OUTPUT level."""
    y = conv3d_transpose_apply(p["conv"], x) if transposed \
        else conv3d_apply(p["conv"], x, stride=stride)
    y = masked_batch_norm_apply(p["bn"], s["bn"], y, mask[None])
    return relu(y) * mask[None, ..., None]


def _dense_tail(params, state, c4, m2, m3):
    """Levels R/4 (conv4 output) -> R/8 -> back to R/4."""
    x = _dense_block(params["conv5"], state["conv5"], c4, m3, stride=2)
    x = _dense_block(params["conv6"], state["conv6"], x, m3, stride=1)
    up = _dense_block(params["conv7"], state["conv7"], x, m2, stride=2,
                      transposed=True)
    return c4 + up


def apply_dense(params, state, grid: sp.VoxelGrid, feats):
    """Dense-masked execution.  feats (P*8, C_in) -> (out, mid)."""
    x0 = sp.scatter_to_dense(grid, feats)[None]
    m0 = sp.scatter_to_dense(grid, grid.cvalid[:, None].float())[..., 0] > 0
    m1 = _maxpool2(m0)
    m2 = _maxpool2(m1)
    m3 = _maxpool2(m2)
    c0 = _dense_block(params["conv0"], state["conv0"], x0, m0, stride=1)
    del x0
    x = _dense_block(params["conv1"], state["conv1"], c0, m1, stride=2)
    c2 = _dense_block(params["conv2"], state["conv2"], x, m1, stride=1)
    x = _dense_block(params["conv3"], state["conv3"], c2, m2, stride=2)
    c4 = _dense_block(params["conv4"], state["conv4"], x, m2, stride=1)
    x = _dense_tail(params, state, c4, m2, m3)
    up = _dense_block(params["conv9"], state["conv9"], x, m1, stride=2,
                      transposed=True)
    x = c2 + up
    up = _dense_block(params["conv11"], state["conv11"], x, m0, stride=2,
                      transposed=True)
    x = (c0 + up)[0]
    cc = grid.child_coords().clamp(0, grid.res - 1)
    mid = x[cc[:, 0], cc[:, 1], cc[:, 2]] * grid.cvalid[:, None].float()
    return mid @ params["out_lin"]["w"], mid


# ---------------------------------------------------------------------------
# hybrid path (K4 at the two finest levels)
# ---------------------------------------------------------------------------

def _bn_relu_rows(p, s, x, mask):
    y = masked_batch_norm_apply(p["bn"], s["bn"], x, mask)
    return relu(y) * mask[:, None].to(y.dtype)


def _scatter_parent_occupancy(grid, pactive):
    half = grid.res // 2
    occ = torch.zeros((half, half, half), dtype=torch.bool,
                      device=grid.parents.device)
    p = grid.parents[pactive]
    occ[p[:, 0], p[:, 1], p[:, 2]] = True
    return occ


def apply_hybrid(params, state, grid: sp.VoxelGrid, feats):
    """L0 (children) and L1 (parents) sparse through K4, L2/L3 dense at R/4
    and R/8.  feats (P*8, C_in), zero at invalid children -> (out, mid)."""
    cval = grid.cvalid
    pactive = grid.pvalid & cval.reshape(-1, 8).any(1)
    r4 = grid.res // 4
    nbr = parent_neighbor_rows(grid)

    # L0
    x = gather_conv(feats, _subm_child_index(nbr),
                    _w27(params["conv0"]["conv"]["w"])) * cval[:, None]
    c0 = _bn_relu_rows(params["conv0"], state["conv0"], x, cval)
    # L0 -> L1
    x = gather_conv(c0, _down_child_index(nbr), _w27(params["conv1"]["conv"]["w"]))
    x = _bn_relu_rows(params["conv1"], state["conv1"], x, pactive)
    x = gather_conv(x, nbr, _w27(params["conv2"]["conv"]["w"])) * pactive[:, None]
    c2 = _bn_relu_rows(params["conv2"], state["conv2"], x, pactive)
    # L1 -> L2 (dense from here down)
    m2 = _maxpool2(_scatter_parent_occupancy(grid, pactive))
    m3 = _maxpool2(m2)
    vals = gather_conv(c2, _down_dense_index(grid, pactive),
                       _w27(params["conv3"]["conv"]["w"]))
    cells = (grid.parents >> 1)[pactive]
    x = torch.zeros((r4, r4, r4, vals.shape[-1]), dtype=vals.dtype,
                    device=vals.device)
    x[cells[:, 0], cells[:, 1], cells[:, 2]] = vals[pactive]
    x = masked_batch_norm_apply(params["conv3"]["bn"], state["conv3"]["bn"],
                                x[None], m2[None])
    x = relu(x) * m2[None, ..., None]
    c4 = _dense_block(params["conv4"], state["conv4"], x, m2, stride=1)
    x = _dense_tail(params, state, c4, m2, m3)[0]
    # L2 -> L1
    up = gather_conv(x.reshape(r4 ** 3, -1), _up_dense_index(grid, r4),
                     _w27(params["conv9"]["conv"]["w"]))
    up = _bn_relu_rows(params["conv9"], state["conv9"], up, pactive)
    x = c2 + up
    # L1 -> L0
    up = gather_conv(x, _up_child_index(nbr),
                     _w27(params["conv11"]["conv"]["w"])) * cval[:, None]
    up = _bn_relu_rows(params["conv11"], state["conv11"], up, cval)
    mid = c0 + up
    return mid @ params["out_lin"]["w"], mid


def apply(params, state, grid, feats, *, dense_max_res=176):
    if grid.res <= dense_max_res:
        return apply_dense(params, state, grid, feats)
    return apply_hybrid(params, state, grid, feats)
