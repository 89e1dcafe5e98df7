"""Port parity of the backward kernels' plain versions against ``jax.vjp``
of the JAX package's functions, on the same seeded numpy inputs:

* K1b: ``_bilinear_core`` (``bilinear_sample_2d``) and ``_bsp_core``
  (``bilinear_sample_packed`` of ``pack_bilinear_corners(image)``, the
  gradient taken with respect to the unpacked image), d_image and
  d_coords, every coordinate convention;
* K2b: ``_trilinear_core_cm`` (``trilinear_sample_3d_cm``), d_volume and
  d_coords, in f32 and on a bf16 C = 1 volume with ray-ordered pile-ups;
  its form rule and brick map against a numpy model;
* K3b: the storage gradient of ``sparse_trilinear`` over three stages,
  with cotangents on the features, the Jacobian, the mixed second and the
  third derivatives, and with each subset of them the training and
  finetune steps send; and the point gradient of the same four outputs
  (the derivative tower the training graph climbs);
* K4: dX (K4 on the transposed table) and dW (K4w) of all six
  neighbour-row sparse convolutions of the hybrid U-Net, through the
  port's autograd function.

Tolerance rtol 1e-5 / atol 1e-6 times max(1, the largest reference
entry): the same f32 products, summed in another order, cancel to
entries smaller than the largest.  K4's dW is held to 1e-4 of its largest
entry: its f32 sums over thousands of rows run in another order.  K4's dX is compared on
the input rows that can hold a value in the model (the others are masked
on both sides of every conv)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from surf_tpu.ops import grid_sample as jgs, sparse as jsp
from surf_tpu.nn import reg_net as jrn
from surf_tpu_torch.ops import grid_sample as tgs, sparse as tsp
from surf_tpu_torch.nn import reg_net as trn

RTOL, ATOL = 1e-5, 1e-6


def _close(got, ref, rtol=RTOL, atol=ATOL, err_msg=""):
    """atol is taken relative to the largest entry where that exceeds 1:
    sums of products of that size cancel to smaller entries."""
    ref = np.asarray(ref)
    scale = max(1.0, float(np.abs(ref).max()) if ref.size else 1.0)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=rtol, atol=atol * scale,
                               err_msg=err_msg)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


@pytest.mark.parametrize("normalized,align", [(True, True), (True, False), (False, True)])
def test_k1b_bilinear_core_vjp(normalized, align):
    rng = np.random.RandomState(11)
    img = rng.randn(13, 17, 5).astype(np.float32)
    if normalized:
        co = rng.uniform(-1.25, 1.25, (301, 2)).astype(np.float32)
    else:
        co = rng.uniform(-2.0, 19.0, (301, 2)).astype(np.float32)
    ct = rng.randn(301, 5).astype(np.float32)
    _, vjp = jax.vjp(lambda i, c: jgs.bilinear_sample_2d(
        i, c, normalized=normalized, align_corners=align), jnp.asarray(img), jnp.asarray(co))
    d_img_j, d_co_j = vjp(jnp.asarray(ct))
    d_img, d_co = tgs.bilinear_sample_bwd_plain(
        _t(img)[None], _t(co)[None], _t(ct)[None], normalized=normalized,
        align_corners=align)
    _close(d_img[0].numpy(), d_img_j, err_msg="d_image")
    _close(d_co[0].numpy(), d_co_j, err_msg="d_coords")


@pytest.mark.parametrize("C", [1, 4, 19])
def test_k1b_vjp_zero_rows_and_pileup(C):
    """K1b's plain version against ``jax.vjp`` over a view batch at the
    main path's channel counts, with the cotangent zero on every third
    row and on the whole first view (rows the kernel does not scatter)
    and a pile-up of points inside one texel cell (many sums into the
    same 4 texels)."""
    rng = np.random.RandomState(30 + C)
    V, H, W = 2, 11, 14
    img = rng.randn(V, H, W, C).astype(np.float32)
    spread = rng.uniform(-1.2, 1.2, (V, 120, 2))
    pile = np.array([0.137, -0.261]) + rng.uniform(0.0, 0.005, (V, 40, 2))
    co = np.concatenate([spread, pile], 1).astype(np.float32)
    ct = rng.randn(V, 160, C).astype(np.float32)
    ct[:, ::3] = 0.0
    ct[0] = 0.0
    for align in (True, False):
        _, vjp = jax.vjp(lambda i, c: jax.vmap(lambda im, cc: jgs.bilinear_sample_2d(
            im, cc, align_corners=align))(i, c), jnp.asarray(img), jnp.asarray(co))
        d_img_j, d_co_j = vjp(jnp.asarray(ct))
        d_img, d_co = tgs.bilinear_sample_bwd_plain(_t(img), _t(co), _t(ct),
                                                    align_corners=align)
        _close(d_img.numpy(), d_img_j, err_msg="d_image")
        _close(d_co.numpy(), d_co_j, err_msg="d_coords")
        assert not np.asarray(d_img_j)[0].any() and not d_img[0].any()
        assert not d_co[0].any()


@pytest.mark.parametrize("align", [True, False])
def test_k1b_packed_form_vjp(align):
    """The corner-packed TPU form: its d_packed, unpacked by autodiff of
    the pack, is the same d_image."""
    rng = np.random.RandomState(12)
    img = rng.randn(3, 11, 14, 4).astype(np.float32)
    co = rng.uniform(-1.2, 1.2, (3, 257, 2)).astype(np.float32)
    ct = rng.randn(3, 257, 4).astype(np.float32)
    H, W = img.shape[1:3]

    def f(i, c):
        return jax.vmap(lambda im, cc: jgs.bilinear_sample_packed(
            jgs.pack_bilinear_corners(im), cc, (H, W), align_corners=align))(i, c)
    _, vjp = jax.vjp(f, jnp.asarray(img), jnp.asarray(co))
    d_img_j, d_co_j = vjp(jnp.asarray(ct))
    d_img, d_co = tgs.bilinear_sample_bwd_plain(_t(img), _t(co), _t(ct),
                                                align_corners=align)
    _close(d_img.numpy(), d_img_j, err_msg="d_image")
    _close(d_co.numpy(), d_co_j, err_msg="d_coords")


@pytest.mark.parametrize("align", [False, True])
def test_k2b_trilinear_cm_vjp(align):
    rng = np.random.RandomState(13)
    vol = rng.randn(9, 7, 11, 2).astype(np.float32)
    co = rng.uniform(-1.2, 1.2, (401, 3)).astype(np.float32)
    ct = rng.randn(401, 2).astype(np.float32)
    _, vjp = jax.vjp(lambda v, c: jgs.trilinear_sample_3d_cm(v, c, align_corners=align),
                     jnp.asarray(vol), jnp.asarray(co))
    d_vol_j, d_co_j = vjp(jnp.asarray(ct))
    d_vol, d_co = tgs.trilinear_sample_bwd_plain(_t(vol), _t(co), _t(ct),
                                                 align_corners=align)
    _close(d_vol.numpy(), d_vol_j, err_msg="d_volume")
    _close(d_co.numpy(), d_co_j, err_msg="d_coords")


def _ray_samples(rng, n_rays, n_samples, lo, hi, step):
    """Ray-ordered samples, as ``depth_render`` lays them out: rays
    starting in [lo, hi)^3, each walking ``n_samples`` points less than
    ``step`` apart, so neighbouring samples pile onto a few voxels."""
    o = rng.uniform(lo, hi, (n_rays, 1, 3))
    d = rng.uniform(-step, step, (n_rays, 1, 3))
    return (o + np.arange(n_samples)[None, :, None] * d).reshape(-1, 3)


@pytest.mark.parametrize("align", [False, True])
def test_k2b_bf16_pileup_vjp(align):
    """K2b's plain version on a bf16 C = 1 volume (the matching volume's
    form) with ray-ordered samples piling onto a few voxels, samples on
    the volume's faces and corners and outside it, and zero cotangent
    rows.  The JAX package's bf16 VJP adds in bf16 (its scatter target is
    the volume's dtype), so at a pile-up it rounds after every add; the
    port sums in f32 and rounds once.  So d_volume is held to JAX's VJP on
    the f32 widening of the same bf16 values, rounded once to bf16, within
    one bf16 step (2^-8 relative); d_coords (f32 in both) to JAX's bf16
    VJP within RTOL."""
    rng = np.random.RandomState(21)
    vol = jnp.asarray(rng.randn(12, 10, 16, 1).astype(np.float32)).astype(jnp.bfloat16)
    faces = np.array([[-1, -1, -1], [1, 1, 1], [1, -1, 0.3], [1.05, 0.2, 0.1],
                      [-1.2, 0, 0], [0.3, 1.3, -0.2], [0.0, -1.0, 1.0]])
    co = np.concatenate([_ray_samples(rng, 40, 32, -0.8, 0.6, 0.002), faces,
                         rng.uniform(-1.2, 1.2, (100, 3))]).astype(np.float32)
    ct = rng.randn(len(co), 1).astype(np.float32)
    ct[::7] = 0.0

    def f(v, c):
        return jgs.trilinear_sample_3d_cm(v, c, align_corners=align)
    _, vjp = jax.vjp(f, vol, jnp.asarray(co))
    _, d_co_j = vjp(jnp.asarray(ct))
    _, vjp32 = jax.vjp(f, vol.astype(jnp.float32), jnp.asarray(co))
    d_vol_j = np.asarray(vjp32(jnp.asarray(ct))[0].astype(jnp.bfloat16).astype(jnp.float32))
    tvol = torch.from_numpy(np.array(vol.astype(jnp.float32))).bfloat16()
    d_vol, d_co = tgs.trilinear_sample_bwd_plain(tvol, _t(co), _t(ct), align_corners=align)
    assert d_vol.dtype == torch.bfloat16
    _close(d_vol.float().numpy(), d_vol_j, rtol=2.0 ** -8, err_msg="d_volume")
    _close(d_co.numpy(), d_co_j, err_msg="d_coords")
    # a real pile-up: many samples share one cell
    cells = np.stack([np.floor(tgs._unnormalize(co[:1280, a], n, align))
                      for a, n in enumerate((12, 10, 16))], -1)
    assert np.unique(cells, axis=0, return_counts=True)[1].max() >= 16


def test_k2b_form_rule_and_brick_map():
    """K2b's host-side choices against a numpy model: the brick map's
    shape (ceil of each side over 8) and the form rule (bricked for a bf16
    volume whose full f32 buffer, 8 bytes an element, outweighs 16 bytes a
    sample), at the training step's four call sites (``depth_render`` of
    views 0 and src: 19,200 rays x 128 samples at 88^3; 76,800 x 64 x 2 at
    176^3; 76,800 x 32 x 2 at 352^3; 307,200 x 16 x 2 at 704^3) and on
    ragged shapes."""
    for shape in ((88, 88, 88, 1), (13, 9, 11, 3), (1, 8, 17, 1), (704, 704, 704, 1)):
        assert tgs.k2b_bricks(shape) == tuple(int(np.ceil(n / 8)) for n in shape[:3])
    sites = {88: 19200 * 128, 176: 76800 * 64 * 2, 352: 76800 * 32 * 2, 704: 307200 * 16 * 2}
    forms = {}
    for res, n in sites.items():
        vol = torch.empty((res, res, res, 1), dtype=torch.bfloat16, device="meta")
        forms[res] = tgs.k2b_bricked(vol, n)
        assert forms[res] == (res ** 3 * 8 > n * 16)
        assert not tgs.k2b_bricked(vol.float(), n)
    assert forms == {88: False, 176: False, 352: True, 704: True}


# ---------------------------------------------------------------------------
# K3b
# ---------------------------------------------------------------------------

def _grid_pair(rng, res, p_keep, C):
    half = res // 2
    allp = np.stack(np.meshgrid(*([np.arange(half)] * 3), indexing="ij"), -1).reshape(-1, 3)
    parents = allp[rng.rand(len(allp)) < p_keep].astype(np.int32)
    pad = rng.randint(0, half, size=(3, 3)).astype(np.int32)
    parents = np.concatenate([parents, pad])
    pvalid = np.arange(len(parents)) < len(parents) - 3
    cvalid = (rng.rand(len(parents) * 8) < 0.8) & np.repeat(pvalid, 8)
    storage = (rng.randn(len(parents) * 8, C) * cvalid[:, None]).astype(np.float32)
    jg = jsp.make_grid(jnp.asarray(parents), jnp.asarray(pvalid), jnp.asarray(cvalid), res)
    tg = tsp.make_grid(torch.from_numpy(parents), torch.from_numpy(pvalid),
                       torch.from_numpy(cvalid), res)
    return jg, tg, storage


def _k3_setup():
    rng = np.random.RandomState(14)
    grids = [_grid_pair(rng, r, k, 4) for r, k in ((16, 0.4), (8, 0.6), (4, 0.9))]
    pts = rng.uniform(-1.1, 1.1, (500, 3)).astype(np.float32)
    n, C = len(pts), 12
    cts = (rng.randn(n, C), rng.randn(n, 3, C), rng.randn(n, 3, C), rng.randn(n, C))
    return grids, pts, [c.astype(np.float32) for c in cts]


def _jax_tower(jgrids, storages, pts):
    """(feats, jac, hmix, third) of the JAX sparse_trilinear by nested jvp
    (points are independent, so a batch tangent gives per-point
    derivatives)."""
    def f(p):
        return jnp.concatenate([jsp.sparse_trilinear(g, s, p)
                                for g, s in zip(jgrids, storages)], -1)
    e = [jnp.zeros_like(pts).at[:, a].set(1.0) for a in range(3)]

    def d(fn, a):
        return lambda p: jax.jvp(fn, (p,), (e[a],))[1]
    jac = jnp.stack([d(f, a)(pts) for a in range(3)], 1)
    hmix = jnp.stack([d(d(f, a), b)(pts) for a, b in ((0, 1), (0, 2), (1, 2))], 1)
    third = d(d(d(f, 0), 1), 2)(pts)
    return f(pts), jac, hmix, third


def test_k3b_storage_gradient_vjp():
    grids, pts, cts = _k3_setup()
    jgrids = [g[0] for g in grids]
    _, vjp = jax.vjp(lambda *st: _jax_tower(jgrids, st, jnp.asarray(pts)),
                     *[jnp.asarray(g[2]) for g in grids])
    ref = vjp(tuple(jnp.asarray(c) for c in cts))
    got = tsp.sparse_trilinear_multi_bwd_plain(
        [(g[1], _t(g[2])) for g in grids], _t(pts), *[_t(c) for c in cts])
    for i, (a, b) in enumerate(zip(got, ref)):
        _close(a.numpy(), b, err_msg=f"stage {i}")


@pytest.mark.parametrize("subset", ["feats", "feats+jac", "feats+jac+hmix",
                                    "feats+jac+hmix+third"])
def test_k3b_cotangent_subsets_vjp(subset):
    """K3b's plain version for each subset of cotangents that the training
    and finetune steps send (the others None), on ray-ordered points whose
    neighbours share corner rows, against ``jax.vjp`` of the JAX tower with
    the absent cotangents zero."""
    rng = np.random.RandomState(40 + len(subset))
    grids = [_grid_pair(rng, r, k, c) for r, k, c in ((16, 0.5, 7), (8, 0.7, 7), (4, 1.0, 7))]
    pts = np.concatenate([_ray_samples(rng, 6, 40, -0.7, 0.7, 0.01),
                          rng.uniform(-1.1, 1.1, (60, 3))]).astype(np.float32)
    n, C = len(pts), 21
    on = [name in subset.split("+") for name in ("feats", "jac", "hmix", "third")]
    cts = [rng.randn(*sh).astype(np.float32) if o else None
           for sh, o in zip(((n, C), (n, 3, C), (n, 3, C), (n, C)), on)]
    jgrids = [g[0] for g in grids]
    _, vjp = jax.vjp(lambda *st: _jax_tower(jgrids, st, jnp.asarray(pts)),
                     *[jnp.asarray(g[2]) for g in grids])
    ref = vjp(tuple(jnp.asarray(c) if c is not None else jnp.zeros(sh, jnp.float32)
                    for c, sh in zip(cts, ((n, C), (n, 3, C), (n, 3, C), (n, C)))))
    got = tsp.sparse_trilinear_multi_bwd_plain(
        [(g[1], _t(g[2])) for g in grids], _t(pts), *[None if c is None else _t(c)
                                                      for c in cts])
    for i, (a, b) in enumerate(zip(got, ref)):
        _close(a.numpy(), b, err_msg=f"stage {i}")


def test_k3_point_gradient_of_the_derivative_tower():
    """d/dpts of the four outputs through the autograd function: the
    first, mixed second and d3/dxdydz terms, as the third-order backward
    of the eikonal and smoothness losses asks for them."""
    grids, pts, cts = _k3_setup()
    jgrids = [g[0] for g in grids]
    _, vjp = jax.vjp(lambda p: _jax_tower(jgrids, [jnp.asarray(g[2]) for g in grids], p),
                     jnp.asarray(pts))
    ref, = vjp(tuple(jnp.asarray(c) for c in cts))
    p = _t(pts).requires_grad_(True)
    storages = [_t(g[2]).requires_grad_(True) for g in grids]
    outs = tsp.SparseTrilinear.apply(p, tuple(g[1] for g in grids), True, True, *storages)
    feats, _, jac, hmix, third = outs
    total = sum((o * _t(c)).sum() for o, c in zip((feats, jac, hmix, third), cts))
    got, = torch.autograd.grad(total, p)
    _close(got.numpy(), ref, err_msg="d_pts")
    # value outputs match the JAX tower too
    for name, a, b in zip(("feats", "jac", "hmix", "third"), (feats, jac, hmix, third),
                          _jax_tower(jgrids, [jnp.asarray(g[2]) for g in grids],
                                     jnp.asarray(pts))):
        _close(a.detach().numpy(), b, err_msg=name)


# ---------------------------------------------------------------------------
# K4: dX and dW of the six neighbour-row convs
# ---------------------------------------------------------------------------

def _conv_setup():
    rng = np.random.RandomState(15)
    res, half = 16, 8
    allp = np.stack(np.meshgrid(*([np.arange(half)] * 3), indexing="ij"), -1).reshape(-1, 3)
    parents = allp[rng.rand(len(allp)) < 0.45].astype(np.int32)
    parents = np.concatenate([parents, np.zeros((3, 3), np.int32)])
    pvalid = np.arange(len(parents)) < len(parents) - 3
    cvalid = (rng.rand(len(parents) * 8) < 0.85) & np.repeat(pvalid, 8)
    jg = jsp.make_grid(jnp.asarray(parents), jnp.asarray(pvalid), jnp.asarray(cvalid), res)
    tg = tsp.make_grid(torch.from_numpy(parents), torch.from_numpy(pvalid),
                       torch.from_numpy(cvalid), res)
    return rng, jg, tg


VARIANTS = ["subm_child", "down_c2p", "subm_parent", "up_p2c", "down_p2d", "up_d2p"]


@pytest.mark.parametrize("variant", VARIANTS)
def test_k4_dx_dw_match_jax_vjp(variant):
    rng, jg, tg = _conv_setup()
    Cin, Cout = 6, 5
    w = rng.randn(3, 3, 3, Cin, Cout).astype(np.float32)
    cval = np.asarray(jg.cvalid)
    pact = np.asarray(jg.pvalid & jnp.any(jg.cvalid.reshape(-1, 8), axis=1))
    P, r4 = len(pact), jg.res // 4
    nbr_j = jrn.parent_neighbor_rows(jg)
    tpact, canon, tables = trn.conv_tables(tg)
    np.testing.assert_array_equal(tpact.numpy(), pact)
    idx = tables[variant]
    cells = np.asarray(jg.parents) >> 1
    m2 = np.zeros((r4,) * 3, bool)
    m2[cells[pact, 0], cells[pact, 1], cells[pact, 2]] = True
    # per variant: JAX function of (w, x); port index table; live input
    # rows; mask of the output (the model's masking of the cotangent)
    if variant == "subm_child":
        x_live, out_mask = cval, cval
        jf = lambda w_, x_: jrn.subm_conv_child_nbr(w_, x_, nbr_j, jg.cvalid)
    elif variant == "down_c2p":
        x_live, out_mask = cval, pact
        jf = lambda w_, x_: jrn.down_conv_c2p_nbr(w_, x_, nbr_j, jnp.asarray(pact), jg.cvalid)
    elif variant == "subm_parent":
        x_live, out_mask = pact, pact
        jf = lambda w_, x_: jrn.subm_conv_parent_nbr(w_, x_, nbr_j, jnp.asarray(pact))
    elif variant == "up_p2c":
        x_live, out_mask = pact, cval
        jf = lambda w_, x_: jrn.up_conv_p2c_nbr(w_, x_, nbr_j, jg.cvalid, jnp.asarray(pact))
    elif variant == "down_p2d":
        x_live, out_mask = pact, m2.reshape(-1)
        jf = lambda w_, x_: jrn.down_conv_parent_to_dense(w_, x_, jg, jnp.asarray(pact), r4)
    else:
        x_live, out_mask = m2.reshape(-1), pact
        jf = lambda w_, x_: jrn.up_conv_dense_to_parent(
            w_, x_.reshape(r4, r4, r4, -1), jg, jnp.asarray(pact))
    n_in = len(x_live)
    x = (rng.randn(n_in, Cin) * x_live[:, None]).astype(np.float32)
    ct = (rng.randn(len(out_mask), Cout) * out_mask[:, None]).astype(np.float32)

    y_j, vjp = jax.vjp(jf, jnp.asarray(w), jnp.asarray(x))
    ct_j = ct.reshape(np.asarray(y_j).shape)
    dw_j, dx_j = vjp(jnp.asarray(ct_j))

    xt = _t(x).requires_grad_(True)
    wt = _t(w).requires_grad_(True)
    vals = trn.sparse_conv(xt, idx, wt.reshape(27, Cin, Cout))
    if variant == "down_p2d":
        cc = torch.from_numpy(cells)[canon]
        y = torch.zeros((r4, r4, r4, Cout)).index_put(
            (cc[:, 0], cc[:, 1], cc[:, 2]), vals[canon]).reshape(-1, Cout)
    else:
        y = vals
    dx, dw = torch.autograd.grad((y * _t(ct)).sum(), (xt, wt))
    scale = np.abs(np.asarray(dw_j)).max()
    _close(dw.numpy(), dw_j, rtol=0, atol=1e-4 * scale, err_msg="dW")
    _close(dx.numpy()[x_live], np.asarray(dx_j).reshape(n_in, Cin)[x_live], err_msg="dX")


def test_k4_transposed_table_is_one_to_one():
    """Each conv table (live rows only) is one-to-one per tap, so its
    transpose loses nothing: transposing back gives the table again."""
    _, _, tg = _conv_setup()
    _, _, tables = trn.conv_tables(tg)
    n_in = {"subm_child": tg.capacity, "down_c2p": tg.capacity,
            "subm_parent": tg.parents.shape[0], "down_p2d": tg.parents.shape[0],
            "up_d2p": (tg.res // 4) ** 3, "up_p2c": tg.parents.shape[0]}
    assert sorted(tables) == sorted(VARIANTS)
    for name, idx in tables.items():
        idx_t = trn.transpose_index(idx, n_in[name])
        back = trn.transpose_index(idx_t, idx.shape[0])
        assert torch.equal(back, torch.where(idx >= 0, idx.long(), -1)), name



# ---------------------------------------------------------------------------
# the grid-form convs (row 7): K4 / K4w on tables built from coordinates
# ---------------------------------------------------------------------------

GRID_OPS = {
    # op: (input lives on children, cotangent mask: "cvalid" / "pactive" /
    # None, neighbour-row table of the same conv, its output mask)
    "subm_conv_child": (True, "cvalid", "subm_child", "cvalid"),
    "subm_conv_parent": (False, "pactive", "subm_parent", "pactive"),
    "down_conv_child_to_parent": (True, "pactive", "down_c2p", "pactive"),
    "up_conv_parent_to_child": (False, None, "up_p2c", "cvalid"),
}


@pytest.mark.parametrize("op", sorted(GRID_OPS))
def test_grid_form_conv_matches_jax_vjp(op):
    """Values, dW and dX of the port's grid-form conv against ``jax.vjp`` of
    the JAX package's ``custom_vjp`` (inputs and cotangents as
    tests/test_reg_net.py builds them, on a grid with capacity-padding
    parents at (0, 0, 0)), rtol 1e-4 / atol 1e-5 as there; and the value
    equal to the neighbour-row conv (``conv_tables`` + K4) on live rows."""
    rng, jg, tg = _conv_setup()
    on_children, ct_mask, nbr_name, live_name = GRID_OPS[op]
    Cin, Cout = 6, 5
    cval = np.asarray(jg.cvalid)
    pact_j = jg.pvalid & jnp.any(jg.cvalid.reshape(-1, 8), axis=1)
    masks = {"cvalid": cval, "pactive": np.asarray(pact_j)}
    P = len(masks["pactive"])
    x = rng.randn(P * 8 if on_children else P, Cin).astype(np.float32)
    x = x * masks["cvalid" if on_children else "pactive"][:, None]
    w = (rng.randn(3, 3, 3, Cin, Cout) * 0.2).astype(np.float32)
    n_out = P * 8 if live_name == "cvalid" else P
    ct = rng.randn(n_out, Cout).astype(np.float32)
    if ct_mask is not None:
        ct = ct * masks[ct_mask][:, None]

    extra_j = () if op == "subm_conv_child" else (pact_j,)
    y_j, vjp = jax.vjp(lambda w_, x_: getattr(jrn, op)(w_, x_, jg, *extra_j),
                       jnp.asarray(w), jnp.asarray(x))
    dw_j, dx_j = vjp(jnp.asarray(ct))

    tpact, _, tables = trn.conv_tables(tg)
    np.testing.assert_array_equal(tpact.numpy(), masks["pactive"])
    extra_t = () if op == "subm_conv_child" else (tpact,)
    xt, wt = _t(x).requires_grad_(True), _t(w).requires_grad_(True)
    y = getattr(trn, op)(wt, xt, tg, *extra_t)
    dx, dw = torch.autograd.grad((y * _t(ct)).sum(), (xt, wt))
    for name, got, ref in (("value", y.detach(), y_j), ("dW", dw, dw_j), ("dX", dx, dx_j)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-5,
                                   err_msg=f"{op} {name}")

    live = masks[live_name]
    nbr = trn.gather_conv(_t(x), tables[nbr_name], _t(w).reshape(27, Cin, Cout))
    np.testing.assert_allclose(y.detach().numpy()[live], nbr.numpy()[live], rtol=1e-5,
                               atol=1e-6, err_msg=f"{op} against {nbr_name}")
