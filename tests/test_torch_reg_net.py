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
from surf_tpu_torch.utils import to_torch_tree
from surf_tpu_torch.nn import core as tcore, reg_net as trn
from surf_tpu_torch.ops import sparse as tsp

# one intra-op thread: the suite's xdist workers share the host's cores,
# and a thread a core in every worker oversubscribes them many times over
torch.set_num_threads(1)

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
    tp = to_torch_tree(jax.tree.map(np.asarray, params))
    ts = to_torch_tree(jax.tree.map(np.asarray, state))
    return (jg, params, state, jnp.asarray(feats)), (tg, tp, ts, torch.from_numpy(feats))


@pytest.mark.parametrize("path", ["hybrid", "dense"])
def test_reg_net_matches_jax(path):
    (jg, jp, js, jf), (tg, tp, ts, tf) = _setup(16, 0.4, 8, 8, 0)
    if path == "hybrid":
        out_j, mid_j, _ = jrn.apply_hybrid(jp, js, jg, jf, training=False)
        out_t, mid_t, _ = trn.apply_hybrid(tp, ts, tg, tf)
    else:
        out_j, mid_j, _ = jrn.apply_dense(jp, js, jg, jf, training=False)
        out_t, mid_t, _ = trn.apply_dense(tp, ts, tg, tf)
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
    # parents -> dense: compare at the written (active) cells, each written
    # by its canonical parent
    ref = np.asarray(jrn.down_conv_parent_to_dense(jnp.asarray(w), jnp.asarray(xp),
                                                   jg, pactive, r4))
    canon = trn._canonical_parents(tg, tpact)
    np.testing.assert_array_equal(canon.numpy(),
                                  np.asarray(jrn._canonical_parent_mask(jg, pactive)))
    vals = trn.gather_conv(torch.from_numpy(xp), trn._down_dense_index(tg, tpact, canon),
                           wt)
    cells = (tg.parents >> 1)[canon].numpy()
    np.testing.assert_allclose(vals[canon].numpy(),
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


# ---------------------------------------------------------------------------
# the index tables: int32, equal to an int64 reference built here from the
# coordinates alone, and the live-row masks that describe their dead rows
# ---------------------------------------------------------------------------

_OFF27 = np.array([(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1)
                   for dz in (-1, 0, 1)], np.int64)
_OFF8 = np.array([((k >> 2) & 1, (k >> 1) & 1, k & 1) for k in range(8)], np.int64)


def _np_tables(tg):
    """Every table of ``conv_tables`` and the four grid-form builders, in
    int64, from the grid's coordinates by direct lookup."""
    parents = tg.parents.numpy().astype(np.int64)
    pvalid, cval = tg.pvalid.numpy(), tg.cvalid.numpy()
    res, P = tg.res, len(parents)
    half, n4 = res // 2, res // 4
    ptab = {tuple(p): i for i, p in enumerate(parents) if pvalid[i]}
    pactive = pvalid & cval.reshape(-1, 8).any(1)
    cc = (parents[:, None, :] * 2 + _OFF8).reshape(-1, 3)

    def prow(c, active_only=False):
        if (c < 0).any() or (c >= half).any():
            return -1
        r = ptab.get(tuple(c), -1)
        return -1 if r < 0 or (active_only and not pactive[r]) else r

    def crow(c, need_cvalid=False):
        if (c < 0).any() or (c >= res).any():
            return -1
        p = prow(c >> 1)
        if p < 0:
            return -1
        r = p * 8 + int((c[0] & 1) * 4 + (c[1] & 1) * 2 + (c[2] & 1))
        return -1 if need_cvalid and not cval[r] else r

    def up_src(c, off):
        s2 = c - off
        return None if (s2 & 1).any() else s2 >> 1

    slot = (parents[:, 0] & 1) * 4 + (parents[:, 1] & 1) * 2 + (parents[:, 2] & 1)
    canon = np.array([pactive[q] and not any(
        prow((parents[q] >> 1) * 2 + _OFF8[k], True) >= 0 for k in range(slot[q]))
        for q in range(P)])
    t = {name: np.full((n, 27), -1, np.int64) for name, n in (
        ("subm_child", P * 8), ("down_c2p", P), ("subm_parent", P), ("down_p2d", P),
        ("up_d2p", P), ("up_p2c", P * 8), ("grid_child", P * 8), ("grid_parent", P),
        ("grid_down", P), ("grid_up", P * 8))}
    for k, off in enumerate(_OFF27):
        for r in range(P * 8):
            if cval[r]:
                t["subm_child"][r, k] = crow(cc[r] + off)
                s = up_src(cc[r], off)
                t["up_p2c"][r, k] = -1 if s is None else prow(s)
            t["grid_child"][r, k] = crow(cc[r] + off, True)
            s = up_src(cc[r], off)
            t["grid_up"][r, k] = -1 if s is None else prow(s, True)
        for q in range(P):
            p = parents[q]
            t["grid_parent"][q, k] = prow(p + off, True)
            t["grid_down"][q, k] = crow(2 * p + off, True)
            if pactive[q]:
                t["down_c2p"][q, k] = crow(2 * p + off)
                t["subm_parent"][q, k] = prow(p + off)
                s = up_src(p, off)
                if s is not None and (s >= 0).all() and (s < n4).all():
                    t["up_d2p"][q, k] = (s[0] * n4 + s[1]) * n4 + s[2]
            if canon[q]:
                t["down_p2d"][q, k] = prow((p >> 1) * 2 + off, True)
    return t, pactive, canon


TABLES = ("subm_child", "down_c2p", "subm_parent", "down_p2d", "up_d2p", "up_p2c")
GRID_TABLES = ("grid_child", "grid_parent", "grid_down", "grid_up")


@pytest.fixture(scope="module")
def tables():
    (_, _, _, _), (tg, _, _, tf) = _setup(16, 0.4, 8, 8, 5)
    pactive, canon, tab = trn.conv_tables(tg)
    tab = dict(tab, grid_child=trn.grid_child_table(tg),
               grid_parent=trn.grid_parent_table(tg, pactive),
               grid_down=trn.grid_down_table(tg), grid_up=trn.grid_up_table(tg, pactive))
    ref, ref_pactive, ref_canon = _np_tables(tg)
    return tg, tf, pactive, canon, tab, ref, ref_pactive, ref_canon


@pytest.mark.parametrize("name", TABLES + GRID_TABLES)
def test_tables_are_int32_and_equal_the_int64_reference(tables, name):
    """Each table is built in int32 and equals, element for element, the
    int64 table built from the coordinates by direct lookup; each conv
    table's ``transpose_index`` is int32 and inverts it per tap."""
    tg, _, pactive, canon, tab, ref, ref_pactive, ref_canon = tables
    np.testing.assert_array_equal(pactive.numpy(), ref_pactive)
    np.testing.assert_array_equal(canon.numpy(), ref_canon)
    assert tab[name].dtype == torch.int32
    np.testing.assert_array_equal(tab[name].numpy().astype(np.int64), ref[name])
    assert (ref[name] >= 0).any()
    if name in TABLES:
        n_in = {"down_c2p": tg.capacity, "subm_child": tg.capacity,
                "up_d2p": (tg.res // 4) ** 3}.get(name, tg.parents.shape[0])
        idx_t = trn.transpose_index(tab[name], n_in)
        assert idx_t.dtype == torch.int32
        want = np.full((n_in, 27), -1, np.int64)
        r, k = np.nonzero(ref[name] >= 0)
        want[ref[name][r, k], k] = r
        np.testing.assert_array_equal(idx_t.numpy().astype(np.int64), want)


@pytest.mark.parametrize("name", TABLES)
def test_plain_versions_with_live_rows_equal_them_without(tables, name):
    """``live_rows`` describes each conv table: every row outside it is all
    -1, so K4's and K4w's plain versions give the same values, bit for
    bit, with the mask and without; and a row the mask leaves out reads
    nothing, whatever its table entries."""
    tg, tf, pactive, canon, tab, _, _, _ = tables
    idx = tab[name]
    live = trn.live_rows(tg, pactive, canon)[name]
    assert live.dtype == torch.bool and live.shape == (idx.shape[0],)
    assert (idx[~live] == -1).all() and (idx[live] >= 0).any()
    rng = np.random.RandomState(6)
    n_in = int(idx.max()) + 1
    x = torch.from_numpy(rng.randn(n_in, 5).astype(np.float32))
    w = torch.from_numpy(rng.randn(27, 5, 3).astype(np.float32))
    ct = torch.from_numpy(rng.randn(idx.shape[0], 3).astype(np.float32))
    assert torch.equal(trn.gather_conv_plain(x, idx, w, live),
                       trn.gather_conv_plain(x, idx, w))
    assert torch.equal(trn.gather_conv_dw_plain(x, idx, ct, live),
                       trn.gather_conv_dw_plain(x, idx, ct))
    # rows outside the mask read nothing, even where the table has taps
    full = torch.zeros_like(idx)
    drop = torch.zeros_like(live)
    drop[::2] = True
    got = trn.gather_conv_plain(x, full, w, ~drop)
    assert (got[drop] == 0).all()
    assert torch.equal(got[~drop], trn.gather_conv_plain(x, full[~drop], w))
    # (the same sums over fewer rows: another summation order)
    torch.testing.assert_close(trn.gather_conv_dw_plain(x, full, ct, ~drop),
                               trn.gather_conv_dw_plain(x, full[~drop], ct[~drop]),
                               rtol=1e-5, atol=1e-4)
