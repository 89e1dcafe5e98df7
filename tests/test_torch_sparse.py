"""Port parity: ops/sparse (the K3 plain version and the cascade geometry)
against surf_tpu on the same numpy inputs, including the first and second
derivatives that the render takes through K3's autograd functions.

Tolerances: values 1e-5 absolute (same f32 operations in the same order);
grad and H.1 of a nonlinear head 1e-4 relative / 1e-4 absolute (autodiff
on the JAX side and the kernel's closed-form derivatives sum in a
different order)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from surf_tpu.ops import sparse as jsp
from surf_tpu_torch.ops import sparse as tsp

# one intra-op thread: the suite's xdist workers share the host's cores,
# and a thread a core in every worker oversubscribes them many times over
torch.set_num_threads(1)

RNG = np.random.RandomState(5)


def _grid_pair(res, p_keep, c_vals, rng=RNG):
    half = res // 2
    allp = np.stack(np.meshgrid(*([np.arange(half)] * 3), indexing="ij"),
                    -1).reshape(-1, 3)
    parents = allp[rng.rand(len(allp)) < p_keep].astype(np.int32)
    P = len(parents)
    # capacity padding: garbage rows with pvalid False
    pad = rng.randint(0, half, size=(5, 3)).astype(np.int32)
    parents = np.concatenate([parents, pad])
    pvalid = np.concatenate([np.ones(P, bool), np.zeros(5, bool)])
    cvalid = (rng.rand((P + 5) * 8) < 0.8) & np.repeat(pvalid, 8)
    storage = (rng.randn((P + 5) * 8, c_vals) * cvalid[:, None]).astype(np.float32)
    jg = jsp.make_grid(jnp.asarray(parents), jnp.asarray(pvalid),
                       jnp.asarray(cvalid), res)
    tg = tsp.make_grid(torch.from_numpy(parents), torch.from_numpy(pvalid),
                       torch.from_numpy(cvalid), res)
    return (jg, jnp.asarray(storage)), (tg, torch.from_numpy(storage))


@pytest.fixture(scope="module")
def stages():
    # fine-to-coarse, as the renderer passes them
    pairs = [_grid_pair(32, 0.3, 7), _grid_pair(16, 0.5, 7), _grid_pair(8, 0.7, 7)]
    return [p[0] for p in pairs], [p[1] for p in pairs]


def _pts(n, lo=-1.15, hi=1.15):
    return RNG.uniform(lo, hi, size=(n, 3)).astype(np.float32)


def test_parent_table_and_lookup_rows(stages):
    for (jg, _), (tg, _) in zip(*stages):
        np.testing.assert_array_equal(tg.parent_table.numpy(),
                                      np.asarray(jg.parent_table))
        coords = RNG.randint(-2, jg.res + 2, size=(500, 3)).astype(np.int32)
        jr, jv = jsp.lookup_rows(jg, jnp.asarray(coords))
        tr, tv = tsp.lookup_rows(tg, torch.from_numpy(coords).long())
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(tr.numpy()[tv.numpy()], np.asarray(jr)[np.asarray(jv)])


def test_k3_plain_values_and_occupancy_match_jax(stages):
    jst, tst = stages
    pts = _pts(2000)
    feats, occ, _, _ = tsp.sparse_trilinear_multi_plain(tst, torch.from_numpy(pts))
    ref = jnp.concatenate([jsp.sparse_trilinear(g, s, jnp.asarray(pts))
                           for g, s in jst], axis=-1)
    np.testing.assert_allclose(feats.numpy(), np.asarray(ref), atol=1e-5)
    ref_occ = np.zeros(len(pts), bool)
    for g, _ in jst:
        ref_occ |= np.asarray(jsp.occupancy_nearest(g, jnp.asarray(pts)))
    np.testing.assert_array_equal(occ.numpy(), ref_occ)
    assert 0 < occ.sum() < len(pts)
    # the single-stage wrapper and the plain occupancy agree too
    g0, s0 = tst[0]
    np.testing.assert_allclose(tsp.sparse_trilinear(g0, s0, torch.from_numpy(pts)).numpy(),
                               np.asarray(jsp.sparse_trilinear(*jst[0], jnp.asarray(pts))),
                               atol=1e-5)
    np.testing.assert_array_equal(
        tsp.occupancy_nearest(g0, torch.from_numpy(pts)).numpy(),
        np.asarray(jsp.occupancy_nearest(jst[0][0], jnp.asarray(pts))))


def test_k3_grad_and_hessian_row_sum_match_jax(stages):
    """grad and H.1 of a nonlinear head on the features: JAX by
    jax.grad/jax.jvp through sparse_trilinear, the port through
    SparseTrilinear (the kernel's J and mixed second derivatives)."""
    jst, tst = stages
    pts = _pts(600, -0.98, 0.98)
    W = RNG.randn(21, 4).astype(np.float32) * 0.5

    def f_j(p):
        f = jnp.concatenate([jsp.sparse_trilinear(g, s, p) for g, s in jst], -1)
        return jnp.sum(jnp.tanh(f @ jnp.asarray(W)) * jnp.sin(p[:, :1] * 3.0))

    g_ref, h_ref = jax.jvp(jax.grad(f_j), (jnp.asarray(pts),),
                           (jnp.ones_like(jnp.asarray(pts)),))

    p = torch.from_numpy(pts).requires_grad_(True)
    f, _ = tsp.stage_features(tst, p)
    val = (torch.tanh(f @ torch.from_numpy(W)) * torch.sin(p[:, :1] * 3.0)).sum()
    g, = torch.autograd.grad(val, p, create_graph=True)
    h, = torch.autograd.grad(g, p, torch.ones_like(g))
    np.testing.assert_allclose(g.detach().numpy(), np.asarray(g_ref), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_ref), rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def four_stages():
    # the main path's shape: 4 stages of 7 channels, fine to coarse
    rng = np.random.RandomState(55)
    pairs = [_grid_pair(res, keep, 7, rng) for res, keep in ((32, 0.3), (16, 0.5), (8, 0.7),
                                                             (4, 0.9))]
    return [p[0] for p in pairs], [p[1] for p in pairs]


def _edge_points(where, n, res, rng):
    """``faces``: every coordinate on a voxel centre of the finest stage
    (fraction 0, corners on the cell's faces) or on the box's faces -1 / 1;
    ``outside``: up to 0.4 beyond the box on some axes; ``mixed``: one
    coordinate on a face, the others anywhere in and around the box."""
    centres = np.arange(res, dtype=np.float32) * np.float32(2.0 / (res - 1)) - np.float32(1.0)
    on_face = rng.choice(np.concatenate([centres, [-1.0, 1.0]]), size=(n, 3))
    if where == "faces":
        return on_face.astype(np.float32)
    if where == "outside":
        pts = rng.uniform(-1.0, 1.0, size=(n, 3))
        out = rng.rand(n, 3) < 0.5
        pts[out] = np.sign(pts[out]) * rng.uniform(1.0, 1.4, size=out.sum())
        return pts.astype(np.float32)
    pts = rng.uniform(-1.2, 1.2, size=(n, 3))
    axis = rng.randint(0, 3, size=n)
    pts[np.arange(n), axis] = on_face[np.arange(n), axis]
    return pts.astype(np.float32)


@pytest.mark.parametrize("where", ["faces", "outside", "mixed"])
def test_k3_plain_four_stages_faces_and_outside_match_jax(four_stages, where):
    """K3's main-path shape (4 stages x 7 channels) at points on cell faces
    and outside the box: the plain version's features against surf_tpu's
    ``sparse_trilinear`` of each stage and its occupancy against the OR of
    ``occupancy_nearest``."""
    jst, tst = four_stages
    rng = np.random.RandomState({"faces": 1, "outside": 2, "mixed": 3}[where])
    pts = _edge_points(where, 1500, tst[0][0].res, rng)
    feats, occ, _, _ = tsp.sparse_trilinear_multi_plain(tst, torch.from_numpy(pts))
    assert feats.shape == (1500, 28)
    ref = jnp.concatenate([jsp.sparse_trilinear(g, s, jnp.asarray(pts)) for g, s in jst], -1)
    np.testing.assert_allclose(feats.numpy(), np.asarray(ref), atol=1e-5)
    ref_occ = np.zeros(len(pts), bool)
    for g, _ in jst:
        ref_occ |= np.asarray(jsp.occupancy_nearest(g, jnp.asarray(pts)))
    np.testing.assert_array_equal(occ.numpy(), ref_occ)
    assert 0 < occ.sum() < len(pts)


def test_k3_size_rule(stages):
    """K3's 32-bit index arithmetic: a table, validity array or storage of
    2^31 entries or more is refused; the path's largest (the 352^3 table,
    3,145,728 rows x 7) is not.  Nor are more than 256 channels in all."""
    _, tst = stages
    g, s = tst[0]
    big = torch.zeros(1, dtype=torch.int32).expand(352, 352, 352)
    tsp._k3_size_rule([(g._replace(parent_table=big), torch.zeros(1).expand(3145728, 7))],
                      557056)
    huge = torch.zeros(1).expand(2 ** 28, 8)
    with pytest.raises(ValueError, match="32-bit"):
        tsp._k3_size_rule([(g, huge)], 10)
    with pytest.raises(ValueError, match="32-bit"):
        tsp._k3_size_rule([(g._replace(cvalid=torch.zeros(1, dtype=torch.bool)
                                       .expand(2 ** 31)), s)], 10)
    tsp._k3_size_rule([(g, torch.zeros(1).expand(8, 256))], 10)
    with pytest.raises(ValueError, match="256 channels"):
        tsp._k3_size_rule([(g, torch.zeros(1).expand(8, 250)), (g, s)], 10)


def test_scatter_compact_and_blocks_match_jax(stages):
    (jg, js), (tg, ts) = stages[0][1], stages[1][1]
    bg = RNG.randn(16, 16, 16, 1).astype(np.float32)
    ref = jsp.scatter_to_dense(jg, js[:, :1], background=jnp.asarray(bg))
    got = tsp.scatter_to_dense(tg, ts[:, :1], background=torch.from_numpy(bg.copy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=0)

    # integer scores with many ties and an overflowing capacity: the same
    # parents survive, in the same order
    scores = RNG.randint(0, 5, size=300).astype(np.float32)
    pvalid = RNG.rand(300) < 0.7
    for cap in (50, 400):
        ji, jv = jsp.compact_parents(jnp.asarray(scores), jnp.asarray(pvalid), cap)
        ti, tv = tsp.compact_parents(torch.from_numpy(scores), torch.from_numpy(pvalid), cap)
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(ti.numpy()[tv.numpy()], np.asarray(ji)[np.asarray(jv)])

    for R, B in ((40, 16), (64, 8)):
        np.testing.assert_array_equal(
            tsp.occupied_blocks_host(stages[1], R, B),
            jsp.occupied_blocks_host(stages[0], R, B))
    base_j = jsp.dense_base_grid(8)
    base_t = tsp.dense_base_grid(8)
    np.testing.assert_array_equal(base_t.child_coords().numpy(),
                                  np.asarray(base_j.child_coords()))
    np.testing.assert_allclose(
        tsp.voxel_centers_world(base_t.child_coords(), 8).numpy(),
        np.asarray(jsp.voxel_centers_world(base_j.child_coords(), 8)), atol=0)
