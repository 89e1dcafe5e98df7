"""The numbers a check compares: gaps between what the program made and
what the reference makes of the same inputs."""

from __future__ import annotations

import numpy as np
import torch


def rel_gap(got, ref):
    """max |got - ref| / max |ref| (the largest error against the scale of
    the reference's values); 0 for two empty tensors."""
    got, ref = torch.as_tensor(got), torch.as_tensor(ref).to(torch.as_tensor(got).device)
    if ref.numel() == 0 and got.numel() == 0:
        return 0.0
    if got.shape != ref.shape:
        return float("inf")
    scale = ref.abs().max().float().clamp(min=1e-30)
    return float((got.float() - ref.float()).abs().max() / scale)


def abs_gap(got, ref):
    """max |got - ref| (inf where the shapes differ)."""
    got, ref = np.asarray(got), np.asarray(ref)
    if got.shape != ref.shape:
        return float("inf")
    if got.size == 0:
        return 0.0
    d = np.abs(got.astype(np.float64) - ref.astype(np.float64))
    return float(np.nan_to_num(d, nan=np.inf).max())


def voxel_keys(grid):
    """Linear indices of a stage's active voxels, sorted, and their rows."""
    coords = grid.child_coords()
    rows = torch.nonzero(grid.cvalid).reshape(-1)
    c = coords[rows]
    res = grid.res
    keys = (c[:, 0] * res + c[:, 1]) * res + c[:, 2]
    order = torch.argsort(keys)
    return keys[order], rows[order]


def stage_gaps(got, ref):
    """(share of the reference's active voxels not active in both,
    rel_gap of the storage rows of the voxels active in both) of one
    stage; each a (VoxelGrid, storage)."""
    (g_got, s_got), (g_ref, s_ref) = got, ref
    k_got, r_got = voxel_keys(g_got)
    k_ref, r_ref = voxel_keys(g_ref)
    both = np.intersect1d(k_got.cpu().numpy(), k_ref.cpu().numpy())
    n_ref = max(int(k_ref.numel()), 1)
    share = (int(k_got.numel()) + int(k_ref.numel()) - 2 * len(both)) / n_ref
    both_t = torch.as_tensor(both, device=k_ref.device)
    i_got = torch.searchsorted(k_got, both_t)
    i_ref = torch.searchsorted(k_ref, both_t)
    return share, rel_gap(s_got[r_got[i_got]], s_ref[r_ref[i_ref]])


def finite(*arrays):
    return all(bool(np.isfinite(np.asarray(a)).all()) for a in arrays)
