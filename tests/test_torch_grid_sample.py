"""Port parity: ops/grid_sample (K1 bilinear, K2 trilinear plain versions
and the functions built on them) against surf_tpu on the same numpy
inputs.  Tolerance 1e-5 absolute: the same f32 operations in the same
order, so only last-bit differences of the libraries' elementwise ops
remain."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from surf_tpu.ops import grid_sample as jgs
from surf_tpu_torch.ops import grid_sample as tgs

# one intra-op thread: the suite's xdist workers share the host's cores,
# and a thread a core in every worker oversubscribes them many times over
torch.set_num_threads(1)

RNG = np.random.RandomState(11)
ATOL = 1e-5


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("align_corners", [True, False])
def test_bilinear_plain_matches_jax_2d_and_packed(align_corners):
    V, H, W, C = 3, 13, 17, 5
    imgs = RNG.randn(V, H, W, C).astype(np.float32)
    # range beyond [-1, 1]: out-of-range taps must read zero
    coords = RNG.uniform(-1.3, 1.3, size=(V, 200, 2)).astype(np.float32)
    ours = tgs.bilinear_sample(_t(imgs), _t(coords), align_corners=align_corners)
    for v in range(V):
        ref = jgs.bilinear_sample_2d(jnp.asarray(imgs[v]), jnp.asarray(coords[v]),
                                     align_corners=align_corners)
        packed = jgs.pack_bilinear_corners(jnp.asarray(imgs[v]))
        ref_p = jgs.bilinear_sample_packed(packed, jnp.asarray(coords[v]), (H, W),
                                           align_corners=align_corners)
        np.testing.assert_allclose(ours[v].numpy(), np.asarray(ref), atol=ATOL)
        np.testing.assert_allclose(ours[v].numpy(), np.asarray(ref_p), atol=ATOL)


def _spread_and_pileup(rng, V, n_spread, n_pile):
    """Points over and beyond the image, then a pile-up: points that all
    fall inside one texel cell (the same 4 corners)."""
    spread = rng.uniform(-1.3, 1.3, (V, n_spread, 2))
    pile = np.array([0.137, -0.261]) + rng.uniform(0.0, 0.005, (V, n_pile, 2))
    return np.concatenate([spread, pile], 1).astype(np.float32)


@pytest.mark.parametrize("C", [1, 4, 19])
def test_bilinear_plain_matches_jax_channels_and_pileup(C):
    """K1's plain version at the channel counts its kernel specialises on
    the main path (1: depth maps, 4: FPN levels, 19: the fused pyramid)."""
    rng = np.random.RandomState(20 + C)
    V, H, W = 2, 13, 17
    imgs = rng.randn(V, H, W, C).astype(np.float32)
    coords = _spread_and_pileup(rng, V, 150, 50)
    for align in (True, False):
        ours = tgs.bilinear_sample(_t(imgs), _t(coords), align_corners=align)
        assert ours.shape == (V, 200, C)
        for v in range(V):
            ref = jgs.bilinear_sample_2d(jnp.asarray(imgs[v]), jnp.asarray(coords[v]),
                                         align_corners=align)
            np.testing.assert_allclose(ours[v].numpy(), np.asarray(ref), atol=ATOL)


def test_k1_layout_guard():
    """The CUDA wrappers' layout rule: coordinates off an 8-byte boundary
    are copied to one (same values), an image of 2^31 elements or more is
    refused (the kernels' offsets are 32-bit)."""
    co = torch.arange(2 * 5 * 2 + 1, dtype=torch.float32)[1:].view(2, 5, 2)
    img = torch.zeros(2, 3, 4, 1)
    assert co.data_ptr() % 8 == 4
    fixed = tgs._k1_layout("test", img, co)
    assert fixed.data_ptr() % 8 == 0 and torch.equal(fixed, co)
    ok = co.clone()
    assert tgs._k1_layout("test", img, ok) is ok
    huge = torch.zeros(1).expand(2, 2 ** 15, 2 ** 15, 1)
    with pytest.raises(ValueError, match="32-bit"):
        tgs._k1_layout("test", huge, ok)


def test_bilinear_pixel_coords_and_single_image():
    H, W, C = 9, 12, 3
    img = RNG.randn(H, W, C).astype(np.float32)
    xy = RNG.uniform(-2.0, 14.0, size=(7, 11, 2)).astype(np.float32)
    ours = tgs.bilinear_sample_2d(_t(img), _t(xy), normalized=False)
    ref = jgs.bilinear_sample_2d(jnp.asarray(img), jnp.asarray(xy), normalized=False)
    assert ours.shape == (7, 11, C)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("align_corners", [True, False])
def test_trilinear_plain_matches_jax_and_cm(align_corners):
    X, Y, Z, C = 9, 11, 7, 4
    vol = RNG.randn(X, Y, Z, C).astype(np.float32)
    pts = RNG.uniform(-1.25, 1.25, size=(300, 3)).astype(np.float32)
    ours = tgs.trilinear_sample(_t(vol), _t(pts), align_corners=align_corners)
    ref = jgs.trilinear_sample_3d(jnp.asarray(vol), jnp.asarray(pts),
                                  align_corners=align_corners)
    ref_cm = jgs.trilinear_sample_3d_cm(jnp.asarray(vol), jnp.asarray(pts),
                                        align_corners=align_corners)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=ATOL)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref_cm), atol=ATOL)


def test_trilinear_bf16_volume_widens_to_f32():
    # the matching volume is bf16 at the protocol; both sides multiply the
    # bf16 values by f32 weights and sum in f32
    vol = RNG.randn(6, 5, 7, 1).astype(np.float32)
    pts = RNG.uniform(-1.1, 1.1, size=(64, 3)).astype(np.float32)
    ours = tgs.trilinear_sample_3d(_t(vol).to(torch.bfloat16), _t(pts),
                                   align_corners=False)
    ref = jgs.trilinear_sample_3d(jnp.asarray(vol, jnp.bfloat16), jnp.asarray(pts),
                                  align_corners=False)
    assert ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref, np.float32), atol=ATOL)


@pytest.mark.parametrize("shape", [(12, 10, 8), (13, 9, 11)])
def test_trilinear_plain_bf16_c1_matches_jax_cm(shape):
    """K2's main-path case: a bf16 C = 1 volume, align_corners=False, points
    over and beyond the border, against surf_tpu's trilinear_sample_3d_cm,
    at an even and an odd z size."""
    rng = np.random.RandomState(30 + shape[2])
    vol = rng.randn(*shape, 1).astype(np.float32)
    pts = rng.uniform(-1.3, 1.3, size=(500, 3)).astype(np.float32)
    pts[:5] = [[-1.0, -1.0, -1.0], [1.0, 1.0, 1.0], [1.2, 0.3, -1.4], [0.0, 0.0, 1.0],
               [-1.05, 0.5, 1.05]]
    ours = tgs.trilinear_sample(_t(vol).to(torch.bfloat16), _t(pts), align_corners=False)
    ref = jgs.trilinear_sample_3d_cm(jnp.asarray(vol, jnp.bfloat16), jnp.asarray(pts),
                                     align_corners=False)
    assert ours.shape == (500, 1) and ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref, np.float32), atol=ATOL)


def test_k2_size_rule():
    """K2's 32-bit voxel offsets: a volume of 2^31 elements or more is
    refused; the path's 704^3 volume is not."""
    pts = torch.zeros(5, 3)
    tgs._k2_size_rule(torch.zeros(1).expand(704, 704, 704, 1), pts)
    with pytest.raises(ValueError, match="32-bit"):
        tgs._k2_size_rule(torch.zeros(1).expand(2 ** 11, 2 ** 10, 2 ** 10, 1), pts)


@pytest.mark.parametrize("align_corners", [True, False])
def test_resize_matches_jax(align_corners):
    img = RNG.randn(5, 7, 3).astype(np.float32)
    ours = tgs.resize_bilinear_2d(_t(img), (10, 14), align_corners=align_corners)
    ref = jgs.resize_bilinear_2d(jnp.asarray(img), (10, 14),
                                 align_corners=align_corners)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=ATOL)
    batched = tgs.resize_bilinear_2d(_t(np.stack([img, 2 * img])), (10, 14),
                                     align_corners=align_corners)
    np.testing.assert_allclose(batched[1].numpy(), 2 * np.asarray(ref), atol=2 * ATOL)


def test_upsample_and_nearest_match_jax():
    vol = RNG.randn(4, 5, 3, 2).astype(np.float32)
    np.testing.assert_allclose(tgs.upsample_trilinear_x2(_t(vol)).numpy(),
                               np.asarray(jgs.upsample_trilinear_x2(jnp.asarray(vol))),
                               atol=ATOL)
    pts = RNG.uniform(-1.2, 1.2, size=(50, 3)).astype(np.float32)
    np.testing.assert_allclose(
        tgs.nearest_sample_3d(_t(vol), _t(pts), align_corners=False).numpy(),
        np.asarray(jgs.nearest_sample_3d(jnp.asarray(vol), jnp.asarray(pts),
                                         align_corners=False)), atol=0)
    img = vol[..., 0]
    xy = RNG.uniform(-1.2, 1.2, size=(40, 2)).astype(np.float32)
    np.testing.assert_allclose(
        tgs.nearest_sample_2d(_t(img), _t(xy)).numpy(),
        np.asarray(jgs.nearest_sample_2d(jnp.asarray(img), jnp.asarray(xy))), atol=0)


def test_projection_and_feature_lookup_match_jax():
    from surf_tpu.ops import projection as jp, feature_lookup as jfl
    from surf_tpu_torch.ops import projection as tp, feature_lookup as tfl
    from surf_tpu.data.synthetic import SyntheticDataset
    from tiny_conf import tiny_conf
    rng = np.random.RandomState(12)
    b = SyntheticDataset(tiny_conf()["val_dataset"], "val")[0]
    nv, H, W, _ = b["imgs"].shape
    feats = [rng.randn(nv, H // 2 ** i, W // 2 ** i, 4).astype(np.float32)
             for i in range(2)]                                     # finest first
    pts = rng.uniform(-1.0, 1.0, size=(257, 3)).astype(np.float32)
    args_j = (jnp.asarray(pts), jnp.asarray(b["intrs"]), jnp.asarray(b["c2ws"]))
    args_t = (_t(pts), _t(b["intrs"]), _t(b["c2ws"]))
    (xy_j, d_j), (xy_t, d_t) = jp.project_points_all(*args_j), tp.project_points_all(*args_t)
    d_j = np.asarray(d_j)
    np.testing.assert_allclose(d_t.numpy(), d_j, rtol=1e-5, atol=1e-5)
    # the ref camera sits inside the [-1, 1]^3 box, so some points lie next
    # to its image plane, where xy = proj / depth amplifies the last bit of
    # the depth without bound: compare the homogeneous product there, and
    # xy itself at depth > 0.1
    np.testing.assert_allclose((xy_t * d_t[..., None]).numpy(),
                               np.asarray(xy_j) * d_j[..., None], rtol=1e-5, atol=1e-4)
    far = np.abs(d_j) > 0.1
    np.testing.assert_allclose(xy_t.numpy()[far], np.asarray(xy_j)[far],
                               rtol=1e-5, atol=1e-4)
    ref = jfl.lookup_feature(jnp.asarray(pts), jnp.asarray(b["imgs"]),
                             *args_j[1:], [jnp.asarray(f) for f in feats])
    got = tfl.lookup_feature(_t(pts), _t(b["imgs"]), *args_t[1:],
                             [_t(f) for f in feats])
    fused_j = jfl.fuse_pyramid(jnp.asarray(b["imgs"]), [jnp.asarray(f) for f in feats])
    fused_t = tfl.fuse_pyramid(_t(b["imgs"]), [_t(f) for f in feats])
    np.testing.assert_allclose(fused_t.numpy(), np.asarray(fused_j), atol=ATOL)
    hw = [f.shape[1:3] for f in feats]
    ref_f = jfl.lookup_feature_fused(jnp.asarray(pts), fused_j, *args_j[1:], hw)
    got_f = tfl.lookup_feature_fused(_t(pts), fused_t, *args_t[1:], hw)
    for r, g in list(zip(ref, got)) + list(zip(ref_f, got_f)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-4)
