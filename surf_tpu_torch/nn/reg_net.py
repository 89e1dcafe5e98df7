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
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

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


def gather_conv_dw_plain(x, idx, ct):
    """Plain version of K4w: dW[t] = sum_r x[idx[r, t]]^T ct[r] (idx -1
    skipped).  x (M, Cin); idx (R, T); ct (R, Cout) -> (T, Cin, Cout)."""
    M, Cin = x.shape
    xpad = torch.cat([x, x.new_zeros((1, Cin))])
    ii = torch.where(idx >= 0, idx.long(), torch.full_like(idx, M, dtype=torch.long))
    g = xpad[ii.reshape(-1)].reshape(idx.shape[0], idx.shape[1], Cin)
    return torch.einsum("rtc,ro->tco", g, ct)


def gather_conv_dw(x, idx, ct):
    """K4w wrapper.  x (M, Cin) f32; idx (R, T) int; ct (R, Cout) f32 with
    Cin, Cout <= 32 -> (T, Cin, Cout) f32."""
    if x.device.type == "cpu":
        return gather_conv_dw_plain(x, idx, ct)
    x = x.float().contiguous()
    idx = idx.to(torch.int32).contiguous()
    ct = ct.float().contiguous()
    _build.require_cuda("gather_conv_dw", x, idx, ct)
    R, T = idx.shape
    Cin, Cout = x.shape[1], ct.shape[1]
    if Cin > 32 or Cout > 32 or ct.shape[0] != R:
        raise ValueError("gather_conv_dw: needs Cin, Cout <= 32 and matching rows")
    dw = torch.zeros((T, Cin, Cout), dtype=torch.float32, device=x.device)
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn = _build.kernel_fn("gather_conv", "gather_conv_dw", [P, P, P, P, L, I, I, I, P])
    _build.check(fn(x.data_ptr(), idx.data_ptr(), ct.data_ptr(), dw.data_ptr(),
                    R, T, Cin, Cout, _build.stream_of(x)), "gather_conv_dw")
    _build.launches["gather_conv_dw"] += 1
    return dw


def transpose_index(idx, n_in):
    """The transposed table of a conv's (R, T) index table over ``n_in``
    input rows: idx_t[j, t] = r where idx[r, t] = j, else -1.  Every
    variant's table is one-to-one per tap (a submanifold conv is its own
    transpose, the stride-2 down and up convs are each other's), so the
    input gradient sum_t ct[r(j, t)] @ w[t]^T is K4 on idx_t with W[t]
    transposed -- tap t keeps its index, no spatial flip needed."""
    R, T = idx.shape
    idx = idx.long()
    valid = idx >= 0
    taps = torch.arange(T, device=idx.device).expand(R, T)
    rows = torch.arange(R, device=idx.device)[:, None].expand(R, T)
    flat = torch.full((n_in * T + 1,), -1, dtype=torch.long, device=idx.device)
    flat[torch.where(valid, idx * T + taps, torch.full_like(idx, n_in * T))] = rows
    return flat[:n_in * T].reshape(n_in, T)


class _GatherConv(torch.autograd.Function):
    """K4 with its backward: dX by K4 on the transposed table, dW by K4w."""

    @staticmethod
    def forward(ctx, x, w, idx, idx_t):
        ctx.save_for_backward(x, w, idx, idx_t)
        return gather_conv(x, idx, w)

    @staticmethod
    @once_differentiable
    def backward(ctx, ct):
        x, w, idx, idx_t = ctx.saved_tensors
        ct = ct.float().contiguous()
        dx = gather_conv(ct, idx_t, w.transpose(1, 2)) if ctx.needs_input_grad[0] else None
        dw = gather_conv_dw(x, idx, ct) if ctx.needs_input_grad[1] else None
        return dx, dw, None, None


def sparse_conv(x, idx, w):
    """out[r] = sum_t x[idx[r, t]] @ w[t] (K4), differentiable in x and w
    when they require grad."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _GatherConv.apply(x, w, idx, transpose_index(idx, x.shape[0]))
    return gather_conv(x, idx, w)


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
    idx = (sc[..., 0] * n + sc[..., 1]) * n + sc[..., 2]
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
    r4 = grid.res // 4
    ns = {}

    # L0
    x = sparse_conv(feats, tab["subm_child"],
                    _w27(params["conv0"]["conv"]["w"])) * cval[:, None]
    c0, ns["conv0"] = _bn_relu_rows(params["conv0"], state["conv0"], x, cval, training)
    # L0 -> L1
    x = sparse_conv(c0, tab["down_c2p"], _w27(params["conv1"]["conv"]["w"]))
    x, ns["conv1"] = _bn_relu_rows(params["conv1"], state["conv1"], x, pactive, training)
    x = sparse_conv(x, tab["subm_parent"], _w27(params["conv2"]["conv"]["w"])) \
        * pactive[:, None]
    c2, ns["conv2"] = _bn_relu_rows(params["conv2"], state["conv2"], x, pactive, training)
    # L1 -> L2 (dense from here down); one canonical parent writes each cell
    m2 = _maxpool2(_scatter_parent_occupancy(grid, pactive))
    m3 = _maxpool2(m2)
    vals = sparse_conv(c2, tab["down_p2d"], _w27(params["conv3"]["conv"]["w"]))
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
                     _w27(params["conv9"]["conv"]["w"]))
    up, ns["conv9"] = _bn_relu_rows(params["conv9"], state["conv9"], up, pactive, training)
    x = c2 + up
    # L1 -> L0
    up = sparse_conv(x, tab["up_p2c"], _w27(params["conv11"]["conv"]["w"])) * cval[:, None]
    up, ns["conv11"] = _bn_relu_rows(params["conv11"], state["conv11"], up, cval, training)
    mid = c0 + up
    return mid @ params["out_lin"]["w"], mid, ns


def apply(params, state, grid, feats, *, training=False, dense_max_res=176):
    """(out, mid, new_state): dense below ``dense_max_res``, hybrid above."""
    if grid.res <= dense_max_res:
        return apply_dense(params, state, grid, feats, training=training)
    return apply_hybrid(params, state, grid, feats, training=training)
