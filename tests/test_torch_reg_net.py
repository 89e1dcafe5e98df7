"""Port parity: nn/reg_net — the hybrid U-Net with the K4 gather-GEMM plain
version, and the dense path — against surf_tpu on the same grid, features
and parameters (JAX init, carried over by convert).

Tolerance 2e-4 absolute / 1e-4 relative: the same sums in another order
(gathered matmuls vs XLA convolutions), through ten layers with batch
norm."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from surf_tpu.nn import core as jcore, reg_net as jrn
from surf_tpu.ops import sparse as jsp
from surf_tpu_torch.convert import _tree_to_torch
from surf_tpu_torch.nn import core as tcore, reg_net as trn
from surf_tpu_torch.ops import sparse as tsp

RNG = np.random.RandomState(3)


def _setup(res, p_keep, c_in, d_base, seed):
    half = res // 2
    allp = np.stack(np.meshgrid(*([np.arange(half)] * 3), indexing="ij"),
                    -1).reshape(-1, 3)
    parents = allp[RNG.rand(len(allp)) < p_keep].astype(np.int32)
    parents = np.concatenate([parents, np.zeros((3, 3), np.int32)])
    pvalid = np.arange(len(parents)) < len(parents) - 3
    cvalid = (RNG.rand(len(parents) * 8) < 0.85) & np.repeat(pvalid, 8)
    feats = (RNG.randn(len(parents) * 8, c_in) * cvalid[:, None]).astype(np.float32)
    jg = jsp.make_grid(jnp.asarray(parents), jnp.asarray(pvalid), jnp.asarray(cvalid), res)
    tg = tsp.make_grid(torch.from_numpy(parents), torch.from_numpy(pvalid),
                       torch.from_numpy(cvalid), res)
    params, state = jrn.init(jax.random.PRNGKey(seed), d_in=c_in, d_out=8, d_base=d_base)
    # non-trivial running statistics and affine terms for eval-mode BN
    state = jax.tree.map(lambda x: x + jnp.asarray(RNG.rand(*x.shape) * 0.3, x.dtype), state)
    params = jax.tree.map(lambda x: x + jnp.asarray(RNG.randn(*x.shape) * 0.05, x.dtype),
                          params)
    tp = _tree_to_torch(jax.tree.map(np.asarray, params), None)
    ts = _tree_to_torch(jax.tree.map(np.asarray, state), None)
    return (jg, params, state, jnp.asarray(feats)), (tg, tp, ts, torch.from_numpy(feats))


@pytest.mark.parametrize("path", ["hybrid", "dense"])
def test_reg_net_matches_jax(path):
    (jg, jp, js, jf), (tg, tp, ts, tf) = _setup(16, 0.4, 8, 8, 0)
    if path == "hybrid":
        out_j, mid_j, _ = jrn.apply_hybrid(jp, js, jg, jf, training=False)
        out_t, mid_t = trn.apply_hybrid(tp, ts, tg, tf)
    else:
        out_j, mid_j, _ = jrn.apply_dense(jp, js, jg, jf, training=False)
        out_t, mid_t = trn.apply_dense(tp, ts, tg, tf)
    live = np.asarray(jg.cvalid)
    np.testing.assert_allclose(mid_t.numpy()[live], np.asarray(mid_j)[live],
                               atol=2e-4, rtol=1e-4)
    np.testing.assert_allclose(out_t.numpy()[live], np.asarray(out_j)[live],
                               atol=2e-4, rtol=1e-4)
    np.testing.assert_array_equal(mid_t.numpy()[~live], 0.0)


def test_gather_conv_plain_matches_each_jax_conv():
    """Every sparse conv variant: the port's index table + K4 plain version
    against the JAX neighbour-table custom-VJP function."""
    (jg, _, _, jf), (tg, _, _, tf) = _setup(16, 0.5, 6, 4, 1)
    w = RNG.randn(3, 3, 3, 6, 5).astype(np.float32)
    wt = torch.from_numpy(w).reshape(27, 6, 5)
    cval = jg.cvalid
    pactive = jg.pvalid & jnp.any(cval.reshape(-1, 8), axis=1)
    tpact = torch.from_numpy(np.array(pactive))
    nbr_j = jrn.parent_neighbor_rows(jg)
    nbr_t = trn.parent_neighbor_rows(tg)
    np.testing.assert_array_equal(nbr_t.numpy(), np.asarray(nbr_j))
    xp = RNG.randn(jg.parents.shape[0], 6).astype(np.float32) * np.asarray(pactive)[:, None]
    r4 = jg.res // 4
    dense = RNG.randn(r4, r4, r4, 6).astype(np.float32)
    cases = [
        (jrn.subm_conv_child_nbr(jnp.asarray(w), jf, nbr_j, cval),
         trn.gather_conv(tf, trn._subm_child_index(nbr_t), wt)
         * tg.cvalid[:, None]),
        (jrn.down_conv_c2p_nbr(jnp.asarray(w), jf, nbr_j, pactive, cval),
         trn.gather_conv(tf, trn._down_child_index(nbr_t), wt)),
        (jrn.subm_conv_parent_nbr(jnp.asarray(w), jnp.asarray(xp), nbr_j, pactive),
         trn.gather_conv(torch.from_numpy(xp), nbr_t, wt) * tpact[:, None]),
        (jrn.up_conv_p2c_nbr(jnp.asarray(w), jnp.asarray(xp), nbr_j, cval, pactive),
         trn.gather_conv(torch.from_numpy(xp), trn._up_child_index(nbr_t), wt)
         * tg.cvalid[:, None]),
        (jrn.up_conv_dense_to_parent(jnp.asarray(w), jnp.asarray(dense), jg, pactive),
         trn.gather_conv(torch.from_numpy(dense).reshape(-1, 6),
                         trn._up_dense_index(tg, r4), wt)),
    ]
    for ref, got in cases:
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-5)
    # parents -> dense: compare at the written (active) cells
    ref = np.asarray(jrn.down_conv_parent_to_dense(jnp.asarray(w), jnp.asarray(xp),
                                                   jg, pactive, r4))
    vals = trn.gather_conv(torch.from_numpy(xp), trn._down_dense_index(tg, tpact), wt)
    cells = (tg.parents >> 1)[tpact].numpy()
    np.testing.assert_allclose(vals[tpact].numpy(),
                               ref[cells[:, 0], cells[:, 1], cells[:, 2]],
                               atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("shape", [(1, 3, 4, 5, 6, 7), (2, 5, 5, 5, 16, 8)])
def test_conv3d_transpose_matches_jax(shape):
    """The port's stride-2 transposed conv (one forward conv at the input's
    resolution, one output channel group per parity, then an interleave)
    against the JAX lhs-dilated conv.  Tolerance 1e-5 absolute and
    relative: the same products summed in another order."""
    N, X, Y, Z, ci, co = shape
    x = RNG.randn(N, X, Y, Z, ci).astype(np.float32)
    w = RNG.randn(3, 3, 3, ci, co).astype(np.float32)
    ref = jcore.conv3d_transpose_apply({"w": jnp.asarray(w)}, jnp.asarray(x))
    got = tcore.conv3d_transpose_apply({"w": torch.from_numpy(w)}, torch.from_numpy(x))
    assert got.shape == (N, 2 * X, 2 * Y, 2 * Z, co)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)
