"""The yardstick's byte and operation counts at shapes small enough to
count by hand."""

from __future__ import annotations

import pytest
import torch

from surfbench import counts
from surfbench.reference.ops import grid_sample as gs
from surfbench.reference.ops import sparse as sp
from surfbench.reference.nn import reg_net


def test_bound_is_the_longer_of_bytes_and_operations():
    assert counts.bound_s(3.35e12, 0) == pytest.approx(1.0)
    assert counts.bound_s(0, 67e12) == pytest.approx(1.0)
    assert counts.bound_s(3.35e12, 2 * 67e12) == pytest.approx(2.0)


def test_k1_counts_distinct_texels():
    img = torch.zeros((1, 4, 5, 2))
    co = torch.tensor([[[0.5, 0.5], [3.5, 2.5]]])       # pixel coordinates
    out = gs.bilinear_sample(img, co, normalized=False)
    b, f = counts.call_counts("K1", (img, co), {"normalized": False}, out)
    # coordinates 16 + output 16 + 8 distinct texels x 2 channels x 4
    assert (b, f) == (96, 1 * 2 * 2 * 12)


def test_k1b_counts_the_image_gradient_and_the_taps():
    img = torch.zeros((1, 4, 5, 2))
    co = torch.tensor([[[0.5, 0.5], [3.5, 2.5]]])
    ct = torch.ones((1, 2, 2))
    kw = {"normalized": False, "need_images": True, "need_coords": False}
    b, f = counts.call_counts("K1b", (img, co, ct), kw, None)
    assert (b, f) == (16 + 16 + 4 * 5 * 2 * 4, 1 * 2 * 2 * 4 * 2)
    kw["need_coords"] = True
    b2, f2 = counts.call_counts("K1b", (img, co, ct), kw, None)
    assert (b2, f2) == (b + 8 * 2 * 4 + 16, f * 2)


def test_k2_counts_distinct_voxels():
    vol = torch.zeros((4, 4, 4, 1))
    pts = torch.zeros((1, 3))            # align_corners: the centre of 8 voxels
    out = gs.trilinear_sample(vol, pts, align_corners=True)
    b, f = counts.call_counts("K2", (vol, pts), {"align_corners": True}, out)
    assert (b, f) == (12 + 4 + 8 * 4, 30)


def _dense_stage(res, c):
    grid = sp.dense_base_grid(res)
    return grid, torch.zeros((grid.capacity, c))


def test_k3_counts_table_entries_flags_and_rows():
    stages = [_dense_stage(4, 3)]
    pts = torch.zeros((1, 3))
    out = sp.sparse_trilinear_multi(stages, pts)
    b, f = counts.call_counts("K3", (stages, pts), {}, out)
    # points 12, feats 12 + occupancy 1; 8 parents x 4, 8 flags, 8 rows x 3 x 4
    assert (b, f) == (12 + 13 + 32 + 8 + 96, 1 * 3 * 1 * 8 * 2)


IDX = torch.tensor([[0, -1, 1], [1, 1, -1], [-1, -1, -1]], dtype=torch.int32)


def test_k4_counts_present_pairs():
    x, w = torch.zeros((5, 2)), torch.zeros((3, 2, 3))
    out = reg_net.gather_conv(x, IDX, w)
    # 2 rows with a present tap x 3 taps x 4, rows {0, 1} x 2 x 4, W 72, out 36
    assert counts.call_counts("K4", (x, IDX, w), {}, out) == (24 + 16 + 72 + 36, 2 * 4 * 2 * 3)
    live = torch.tensor([True, False, True])
    assert counts.call_counts("K4", (x, IDX, w, live), {}, out) == \
        (12 + 16 + 72 + 36, 2 * 2 * 2 * 3)


def test_k4w_counts_present_pairs():
    x, ct = torch.zeros((5, 2)), torch.zeros((3, 3))
    # 2 rows x (3 taps + 3 cotangent channels) x 4, rows {0, 1} x 2 x 4, dW 72
    assert counts.call_counts("K4w", (x, IDX, ct), {}, None) == \
        (2 * (12 + 12) + 16 + 72, 2 * 4 * 2 * 3)
