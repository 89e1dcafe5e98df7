"""Sparse 3D cost-regularization U-Net per cascade stage (torch counterpart
of surf_tpu/nn/reg_net.py): conv0 -> three stride-2 encoder levels ->
three transposed-conv decoder levels with additive skips -> bias-free
linear head.  Returns ``(out, mid)``: ``out[:, :1]`` feeds the matching
volume, ``out[:, 1:]`` is the stage's feature storage, ``mid`` seeds the
next stage; with the new batch-norm state ``(out, mid, new_state)``.  In
training the batch norms use the batch statistics of the active set and
update the running ones.

* ``apply_dense`` (res <= 176): densify the active set and run
  ``F.conv3d`` with per-level activity masks — exactly submanifold.
* ``apply_hybrid`` (352^3, 704^3): the two finest levels run over the
  capacity-padded voxel lists with the hand-written gather-GEMM kernel K4
  (csrc/gather_conv.cu); levels at R/4 and below densify.  Each sparse
  conv variant is a (rows, 27) neighbour-index table built here from the
  VoxelGrid parent table (-1 = absent neighbour, reads zero).  In
  training each conv is a ``torch.autograd.Function``: the input gradient
  is K4 again on the transposed table (every table is one-to-one per tap),
  the weight gradient the kernel K4w (``gather_conv_dw``).
* The grid-form convs (``subm_conv_child``, ``subm_conv_parent``,
  ``down_conv_child_to_parent``, ``up_conv_parent_to_child``): the same
  four convolutions with their tables built from coordinates through the
  voxel and parent tables, and the JAX package's custom VJPs (dX by K4 on
  the paired conv's table, dW by K4w).  No path calls them.

In this frozen copy (the benchmark's reference) the gather convolution's
wrappers (K4 ``gather_conv``, K4w ``gather_conv_dw``) call their plain
versions on any device.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from .core import (conv_init, conv3d_apply, conv3d_transpose_apply,
                   batch_norm_init, masked_batch_norm_apply, relu)
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

def _live_table(idx, live):
    """``idx`` with the rows outside ``live`` (bool, one per row) set to -1."""
    return idx if live is None else torch.where(live[:, None], idx, torch.full_like(idx, -1))


def gather_conv_plain(x, idx, w, live=None):
    """Plain version of K4: out[r] = sum_t x[idx[r, t]] @ w[t] (idx -1 ->
    zero; a row outside ``live``, where given, reads nothing).  x (M, Cin);
    idx (R, T); w (T, Cin, Cout); live (R,) bool or None -> (R, Cout)."""
    M, Cin = x.shape
    T, _, Cout = w.shape
    idx = _live_table(idx, live)
    xpad = torch.cat([x, x.new_zeros((1, Cin))])
    ii = torch.where(idx >= 0, idx.long(), torch.full_like(idx, M, dtype=torch.long))
    g = xpad[ii.reshape(-1)].reshape(idx.shape[0], T * Cin)
    return g @ w.reshape(T * Cin, Cout)


def gather_conv(x, idx, w, live=None):
    """K4 wrapper.  x (M, Cin) f32; idx (R, T) int (int32 on the path);
    w (T, Cin, Cout) f32 with T <= 27 and Cin, Cout <= 32; live (R,) bool
    or None: the rows that may hold a present tap (the kernel reads no
    table entry of the others and writes them zero) -> (R, Cout) f32."""
    return gather_conv_plain(x, idx, w, live)


def gather_conv_dw_plain(x, idx, ct, live=None):
    """Plain version of K4w: dW[t] = sum_r x[idx[r, t]]^T ct[r] (idx -1,
    and every row outside ``live`` where given, skipped).  x (M, Cin);
    idx (R, T); ct (R, Cout); live (R,) bool or None -> (T, Cin, Cout)."""
    M, Cin = x.shape
    idx = _live_table(idx, live)
    xpad = torch.cat([x, x.new_zeros((1, Cin))])
    ii = torch.where(idx >= 0, idx.long(), torch.full_like(idx, M, dtype=torch.long))
    g = xpad[ii.reshape(-1)].reshape(idx.shape[0], idx.shape[1], Cin)
    return torch.einsum("rtc,ro->tco", g, ct)


def gather_conv_dw(x, idx, ct, live=None):
    """K4w wrapper.  x (M, Cin) f32; idx (R, T) int (int32 on the path);
    ct (R, Cout) f32 with Cin, Cout <= 32; live as for ``gather_conv`` ->
    (T, Cin, Cout) f32."""
    return gather_conv_dw_plain(x, idx, ct, live)


def transpose_index(idx, n_in):
    """The transposed int32 table of a conv's (R, T) index table over
    ``n_in`` input rows: idx_t[j, t] = r where idx[r, t] = j, else -1.
    Every variant's table is one-to-one per tap (a submanifold conv is its
    own transpose, the stride-2 down and up convs are each other's), so
    the input gradient sum_t ct[r(j, t)] @ w[t]^T is K4 on idx_t with W[t]
    transposed -- tap t keeps its index, no spatial flip needed."""
    R, T = idx.shape
    valid = idx >= 0
    taps = torch.arange(T, device=idx.device).expand(R, T)
    rows = torch.arange(R, dtype=torch.int32, device=idx.device)[:, None].expand(R, T)
    flat = torch.full((n_in * T + 1,), -1, dtype=torch.int32, device=idx.device)
    flat[torch.where(valid, idx.long() * T + taps, n_in * T)] = rows
    return flat[:n_in * T].reshape(n_in, T)


class _GatherConv(torch.autograd.Function):
    """K4 with its backward: dX by K4 on the transposed table (no live-row
    mask: its dead rows are not described by one), dW by K4w with the
    forward's mask."""

    @staticmethod
    def forward(ctx, x, w, idx, idx_t, live):
        ctx.save_for_backward(x, w, idx, idx_t, live)
        return gather_conv(x, idx, w, live)

    @staticmethod
    @once_differentiable
    def backward(ctx, ct):
        x, w, idx, idx_t, live = ctx.saved_tensors
        ct = ct.float().contiguous()
        dx = gather_conv(ct, idx_t, w.transpose(1, 2)) if ctx.needs_input_grad[0] else None
        dw = gather_conv_dw(x, idx, ct, live) if ctx.needs_input_grad[1] else None
        return dx, dw, None, None, None


def sparse_conv(x, idx, w, live=None):
    """out[r] = sum_t x[idx[r, t]] @ w[t] (K4), differentiable in x and w
    when they require grad.  ``live``: the rows of ``idx`` that may hold a
    present tap (every other row is all -1), or None."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _GatherConv.apply(x, w, idx, transpose_index(idx, x.shape[0]), live)
    return gather_conv(x, idx, w, live)


def _w27(w):
    return w.reshape(27, w.shape[3], w.shape[4])


# ---------------------------------------------------------------------------
# neighbour-index tables (one per conv variant)
# ---------------------------------------------------------------------------

def _offsets(device):
    return torch.as_tensor(_OFFSETS_NP, device=device)


def parent_neighbor_rows(grid):
    """(P, 27) int32: row of each parent's 3^3 neighbourhood (-1 = none)."""
    half = grid.res // 2
    nb = grid.parents[:, None, :] + _offsets(grid.parents.device)
    inb = ((nb >= 0) & (nb < half)).all(-1)
    c = nb.clamp(0, half - 1)
    idx = (c[..., 0] * half + c[..., 1]) * half + c[..., 2]
    prow = grid.parent_table.reshape(-1)[idx]
    return torch.where(inb, prow, torch.full_like(prow, -1))


def _subm_child_index(nbr):
    """Children -> children, (P*8, 27)."""
    m = torch.as_tensor(_SUBM_CHILD_MAP, dtype=torch.int32, device=nbr.device)
    nk = nbr[:, m[..., 0]]                                  # (P, 8, 27)
    idx = torch.where(nk >= 0, nk * 8 + m[..., 1], torch.full_like(nk, -1))
    return idx.reshape(-1, 27)


def _down_child_index(nbr):
    """Children -> parents (stride 2), (P, 27)."""
    m = torch.as_tensor(_DOWN_MAP, dtype=torch.int32, device=nbr.device)
    nk = nbr[:, m[:, 0]]
    return torch.where(nk >= 0, nk * 8 + m[:, 1], torch.full_like(nk, -1))


def _up_child_index(nbr):
    """Parents -> children (transposed stride 2), (P*8, 27)."""
    m = torch.as_tensor(_UP_MAP, dtype=torch.int32, device=nbr.device)
    nk = nbr[:, m.clamp(min=0)]                             # (P, 8, 27)
    idx = torch.where(m >= 0, nk, torch.full_like(nk, -1))
    return idx.reshape(-1, 27)


def _parent_rows_at(grid, pcoords, pactive):
    """Parent rows at parent coords (..., 3), -1 where absent/inactive."""
    half = grid.res // 2
    inb = ((pcoords >= 0) & (pcoords < half)).all(-1)
    c = pcoords.clamp(0, half - 1)
    prow = grid.parent_table.reshape(-1)[(c[..., 0] * half + c[..., 1]) * half
                                         + c[..., 2]]
    valid = inb & (prow >= 0) & pactive[prow.clamp(min=0)]
    return torch.where(valid, prow, torch.full_like(prow, -1))


def _canonical_parents(grid, pactive):
    """True for the lowest-slot active parent of each R/4 cell: one writer
    per written cell (its siblings compute the same value), so the
    parents -> cells table is one-to-one per tap."""
    half = grid.res // 2
    cell = grid.parents >> 1
    p = grid.parents
    slot = ((p[:, 0] & 1) << 2) | ((p[:, 1] & 1) << 1) | (p[:, 2] & 1)
    canon = pactive.clone()
    off = sp.child_offsets(p.device)
    for k in range(8):
        sib = cell * 2 + off[k]
        prow = _parent_rows_at(grid, sib, pactive)
        canon &= ~((k < slot) & (prow >= 0))
    return canon


def _down_dense_index(grid, pactive, canon):
    """Canonical parents -> their R/4 cell (stride 2), (P, 27); other
    parents' rows are -1."""
    cells = grid.parents >> 1
    src = cells[:, None, :] * 2 + _offsets(cells.device)
    idx = _parent_rows_at(grid, src, pactive)
    return torch.where(canon[:, None], idx, torch.full_like(idx, -1))


def _up_dense_index(grid, n):
    """Dense R/4 cells (n^3 rows) -> parents (transposed stride 2), (P, 27)."""
    src2 = grid.parents[:, None, :] - _offsets(grid.parents.device)
    even = ((src2 & 1) == 0).all(-1)
    src = src2 >> 1
    inb = ((src >= 0) & (src < n)).all(-1) & even
    sc = src.clamp(0, n - 1)
    idx = ((sc[..., 0] * n + sc[..., 1]) * n + sc[..., 2]).to(torch.int32)
    return torch.where(inb, idx, torch.full_like(idx, -1))


def _rows_where(idx, live):
    return torch.where(live[:, None], idx, torch.full_like(idx, -1))


def conv_tables(grid):
    """(pactive, canon, tables): the active parents, the canonical writer
    of each R/4 cell, and the six index tables of ``apply_hybrid`` in call
    order, each with the rows of its masked-out outputs set to -1 (those
    outputs are zeroed downstream anyway).  Live rows have distinct
    coordinates, so every table is one-to-one per tap and its
    ``transpose_index`` is exact."""
    cval = grid.cvalid
    pactive = grid.pvalid & cval.reshape(-1, 8).any(1)
    nbr = parent_neighbor_rows(grid)
    canon = _canonical_parents(grid, pactive)
    return pactive, canon, {
        "subm_child": _rows_where(_subm_child_index(nbr), cval),
        "down_c2p": _rows_where(_down_child_index(nbr), pactive),
        "subm_parent": _rows_where(nbr, pactive),
        "down_p2d": _down_dense_index(grid, pactive, canon),
        "up_d2p": _rows_where(_up_dense_index(grid, grid.res // 4), pactive),
        "up_p2c": _rows_where(_up_child_index(nbr), cval),
    }


def live_rows(grid, pactive, canon):
    """The live-row mask of each of ``conv_tables``' tables: the rows that
    ``_rows_where`` (or the canonical writer) kept, every other row being
    all -1.  K4 and K4w read no table entry of a row outside it."""
    cval = grid.cvalid
    return {"subm_child": cval, "down_c2p": pactive, "subm_parent": pactive,
            "down_p2d": canon, "up_d2p": pactive, "up_p2c": cval}


# ---------------------------------------------------------------------------
# grid-form convs: the same convolutions indexed through the voxel and
# parent tables by coordinate (surf_tpu/nn/reg_net.py:566-678, raw ops
# :918-1044).  No path of either package calls them; apply_hybrid uses
# the neighbour-row tables above.
# ---------------------------------------------------------------------------

def _child_rows_at(grid, coords):
    """Child rows at voxel coords (..., 3), -1 where absent (child
    existence includes cvalid), as ``_child_gather`` reads them."""
    rows, valid = sp.lookup_rows(grid, coords)
    rows = rows.to(torch.int32)
    return torch.where(valid, rows, torch.full_like(rows, -1))


def grid_child_table(grid):
    """Children -> children at coords + offset, (P*8, 27)."""
    return _child_rows_at(grid, grid.child_coords()[:, None, :]
                          + _offsets(grid.parents.device))


def grid_parent_table(grid, pactive):
    """Parents -> parents at coords + offset (active parents), (P, 27)."""
    return _parent_rows_at(grid, grid.parents[:, None, :] + _offsets(grid.parents.device),
                           pactive)


def grid_down_table(grid):
    """Children at 2 q + offset -> parent q, (P, 27), every parent row
    (capacity padding included)."""
    return _child_rows_at(grid, grid.parents[:, None, :] * 2
                          + _offsets(grid.parents.device))


def grid_up_table(grid, pactive):
    """Active parents at (c - offset) / 2 -> child c, where c - offset is
    even on every axis, (P*8, 27)."""
    src2 = grid.child_coords()[:, None, :] - _offsets(grid.parents.device)
    idx = _parent_rows_at(grid, src2 >> 1, pactive)
    return torch.where(((src2 & 1) == 0).all(-1), idx, torch.full_like(idx, -1))


class _GridConv(torch.autograd.Function):
    """K4 on a grid-form table, with the JAX package's custom VJP: the
    cotangent masked first, dX by K4 on the paired conv's own grid-form
    table with the weights transposed (and spatially flipped for the
    submanifold convs) and masked as that conv's output, dW by K4w on
    the forward table.  ``paired()`` gives (table, flip, dX mask) when the
    backward needs it.  The paired table, not ``transpose_index``: the
    down conv keeps every parent row, so its table is not one-to-one."""

    @staticmethod
    def forward(ctx, x, w27, idx, out_mask, ct_mask, paired):
        ctx.save_for_backward(x, w27, idx, ct_mask)
        ctx.paired = paired
        y = gather_conv(x, idx, w27)
        return y if out_mask is None else y * out_mask[:, None]

    @staticmethod
    @once_differentiable
    def backward(ctx, ct):
        x, w27, idx, ct_mask = ctx.saved_tensors
        ct = (ct * ct_mask[:, None]).float().contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            idx_b, flip, dx_mask = ctx.paired()
            w_b = (w27.flip(0) if flip else w27).transpose(1, 2)
            dx = gather_conv(ct, idx_b, w_b) * dx_mask[:, None]
        if ctx.needs_input_grad[1]:
            dw = gather_conv_dw(x, idx, ct)
        return dx, dw, None, None, None, None


def subm_conv_child(w, storage, grid):
    """Submanifold conv at child level: (P*8, Cin) -> (P*8, Cout), zero at
    invalid children.  w (3, 3, 3, Cin, Cout)."""
    idx = grid_child_table(grid)
    return _GridConv.apply(storage, _w27(w), idx, grid.cvalid, grid.cvalid,
                           lambda: (idx, True, grid.cvalid))


def subm_conv_parent(w, storage_p, grid, pactive):
    """Submanifold conv over the parents: (P, Cin) -> (P, Cout), zero at
    inactive parents."""
    idx = grid_parent_table(grid, pactive)
    return _GridConv.apply(storage_p, _w27(w), idx, pactive, pactive,
                           lambda: (idx, True, pactive))


def down_conv_child_to_parent(w, storage, grid, pactive):
    """Stride-2 conv children -> parents, out[q] = sum_off w[off] x[2q + off],
    unmasked; ``pactive`` gates the backward."""
    return _GridConv.apply(storage, _w27(w), grid_down_table(grid), None, pactive,
                           lambda: (grid_up_table(grid, pactive), False, grid.cvalid))


def up_conv_parent_to_child(w, storage_p, grid, pactive):
    """Transposed stride-2 conv parents -> children, zero at invalid
    children."""
    return _GridConv.apply(storage_p, _w27(w), grid_up_table(grid, pactive), grid.cvalid,
                           grid.cvalid, lambda: (grid_down_table(grid), False, pactive))


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


def _dense_block(p, s, x, mask, *, stride, training, transposed=False):
    """x (1, X, Y, Z, C); mask of the OUTPUT level.  Returns (y, state)."""
    y = conv3d_transpose_apply(p["conv"], x) if transposed \
        else conv3d_apply(p["conv"], x, stride=stride)
    y, bn_s = masked_batch_norm_apply(p["bn"], s["bn"], y, mask[None],
                                      training=training)
    return relu(y) * mask[None, ..., None], {"bn": bn_s}


def _dense_tail(params, state, c4, m2, m3, training, ns):
    """Levels R/4 (conv4 output) -> R/8 -> back to R/4."""
    x, ns["conv5"] = _dense_block(params["conv5"], state["conv5"], c4, m3, stride=2,
                                  training=training)
    x, ns["conv6"] = _dense_block(params["conv6"], state["conv6"], x, m3, stride=1,
                                  training=training)
    up, ns["conv7"] = _dense_block(params["conv7"], state["conv7"], x, m2, stride=2,
                                   training=training, transposed=True)
    return c4 + up


def apply_dense(params, state, grid: sp.VoxelGrid, feats, *, training=False):
    """Dense-masked execution.  feats (P*8, C_in) -> (out, mid, state)."""
    x0 = sp.scatter_to_dense(grid, feats)[None]
    m0 = sp.scatter_to_dense(grid, grid.cvalid[:, None].float())[..., 0] > 0
    m1 = _maxpool2(m0)
    m2 = _maxpool2(m1)
    m3 = _maxpool2(m2)
    ns = {}
    c0, ns["conv0"] = _dense_block(params["conv0"], state["conv0"], x0, m0, stride=1,
                                   training=training)
    del x0
    x, ns["conv1"] = _dense_block(params["conv1"], state["conv1"], c0, m1, stride=2,
                                  training=training)
    c2, ns["conv2"] = _dense_block(params["conv2"], state["conv2"], x, m1, stride=1,
                                   training=training)
    x, ns["conv3"] = _dense_block(params["conv3"], state["conv3"], c2, m2, stride=2,
                                  training=training)
    c4, ns["conv4"] = _dense_block(params["conv4"], state["conv4"], x, m2, stride=1,
                                   training=training)
    x = _dense_tail(params, state, c4, m2, m3, training, ns)
    up, ns["conv9"] = _dense_block(params["conv9"], state["conv9"], x, m1, stride=2,
                                   training=training, transposed=True)
    x = c2 + up
    up, ns["conv11"] = _dense_block(params["conv11"], state["conv11"], x, m0, stride=2,
                                    training=training, transposed=True)
    x = (c0 + up)[0]
    cc = grid.child_coords().clamp(0, grid.res - 1)
    mid = x[cc[:, 0], cc[:, 1], cc[:, 2]] * grid.cvalid[:, None].float()
    return mid @ params["out_lin"]["w"], mid, ns


# ---------------------------------------------------------------------------
# hybrid path (K4 at the two finest levels)
# ---------------------------------------------------------------------------

def _bn_relu_rows(p, s, x, mask, training):
    y, bn_s = masked_batch_norm_apply(p["bn"], s["bn"], x, mask, training=training)
    return relu(y) * mask[:, None].to(y.dtype), {"bn": bn_s}


def _scatter_parent_occupancy(grid, pactive):
    half = grid.res // 2
    occ = torch.zeros((half, half, half), dtype=torch.bool,
                      device=grid.parents.device)
    p = grid.parents[pactive]
    occ[p[:, 0], p[:, 1], p[:, 2]] = True
    return occ


def apply_hybrid(params, state, grid: sp.VoxelGrid, feats, *, training=False):
    """L0 (children) and L1 (parents) sparse through K4, L2/L3 dense at R/4
    and R/8.  feats (P*8, C_in), zero at invalid children -> (out, mid,
    state)."""
    cval = grid.cvalid
    pactive, canon, tab = conv_tables(grid)
    live = live_rows(grid, pactive, canon)
    r4 = grid.res // 4
    ns = {}

    # L0
    x = sparse_conv(feats, tab["subm_child"], _w27(params["conv0"]["conv"]["w"]),
                    live["subm_child"]) * cval[:, None]
    c0, ns["conv0"] = _bn_relu_rows(params["conv0"], state["conv0"], x, cval, training)
    # L0 -> L1
    x = sparse_conv(c0, tab["down_c2p"], _w27(params["conv1"]["conv"]["w"]),
                    live["down_c2p"])
    x, ns["conv1"] = _bn_relu_rows(params["conv1"], state["conv1"], x, pactive, training)
    x = sparse_conv(x, tab["subm_parent"], _w27(params["conv2"]["conv"]["w"]),
                    live["subm_parent"]) * pactive[:, None]
    c2, ns["conv2"] = _bn_relu_rows(params["conv2"], state["conv2"], x, pactive, training)
    # L1 -> L2 (dense from here down); one canonical parent writes each cell
    m2 = _maxpool2(_scatter_parent_occupancy(grid, pactive))
    m3 = _maxpool2(m2)
    vals = sparse_conv(c2, tab["down_p2d"], _w27(params["conv3"]["conv"]["w"]),
                       live["down_p2d"])
    cells = (grid.parents >> 1)[canon]
    x = torch.zeros((r4, r4, r4, vals.shape[-1]), dtype=vals.dtype,
                    device=vals.device)
    x = x.index_put((cells[:, 0], cells[:, 1], cells[:, 2]), vals[canon])
    x, bn_s = masked_batch_norm_apply(params["conv3"]["bn"], state["conv3"]["bn"],
                                      x[None], m2[None], training=training)
    ns["conv3"] = {"bn": bn_s}
    x = relu(x) * m2[None, ..., None]
    c4, ns["conv4"] = _dense_block(params["conv4"], state["conv4"], x, m2, stride=1,
                                   training=training)
    x = _dense_tail(params, state, c4, m2, m3, training, ns)[0]
    # L2 -> L1
    up = sparse_conv(x.reshape(r4 ** 3, -1), tab["up_d2p"],
                     _w27(params["conv9"]["conv"]["w"]), live["up_d2p"])
    up, ns["conv9"] = _bn_relu_rows(params["conv9"], state["conv9"], up, pactive, training)
    x = c2 + up
    # L1 -> L0
    up = sparse_conv(x, tab["up_p2c"], _w27(params["conv11"]["conv"]["w"]),
                     live["up_p2c"]) * cval[:, None]
    up, ns["conv11"] = _bn_relu_rows(params["conv11"], state["conv11"], up, cval, training)
    mid = c0 + up
    return mid @ params["out_lin"]["w"], mid, ns


def apply(params, state, grid, feats, *, training=False, dense_max_res=176):
    """(out, mid, new_state): dense below ``dense_max_res``, hybrid above."""
    if grid.res <= dense_max_res:
        return apply_dense(params, state, grid, feats, training=training)
    return apply_hybrid(params, state, grid, feats, training=training)
