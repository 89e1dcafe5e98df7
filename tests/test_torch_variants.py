"""Port parity of the variants the JAX package keeps beside its main path
(nothing in either package's confs calls them), against ``surf_tpu`` on
the same seeded numpy inputs, and the second order of K1 / K2:

* the legacy 3-scale FPN (``apply_legacy``) and the MNASNet FPN at 1e-4
  (XLA and PyTorch sum the convolutions in another order), the parameters
  in the JAX ``init``'s tree (the port's ``init`` gives the same shapes)
  filled from a numpy seed and carried over by ``convert.from_jax``;
  ``convert_feature_network_old`` against the JAX converter, exactly;
* ``rendering_net`` in its three modes, ``lookup_volume`` in its three
  modes on a list of volumes, the alt grids (values and first
  derivatives; away from the poles, where the arcsin's derivative is not
  finite in either package) and the projection helpers at 1e-5;
* ``sample_pdf`` at 1e-6: its inverse-CDF step on JAX's own uniform
  levels (the random mode cannot match JAX's key) and the deterministic
  mode end to end;
* ``geocheck_depths`` and ``depth_consistency_geocheck``: on the scenes of
  tests/test_layers.py exactly (the masks decide as JAX's do), on a random
  3-view scene at 1e-5 (depths) and exactly (counts);
* ``compute_consistency_loss`` at 1e-5 and its gradients in both depth
  maps (K1b's d_image and d_coords) at 1e-4 of the largest entry;
* ``utils.tools`` against the JAX package's, with a stub writer;
* the second order: the double backward through ``bilinear_sample_2d``
  and ``trilinear_sample_3d`` no longer raises (it did while their
  backward was first order only); its derivatives in the image / volume,
  the coordinates and the first cotangent against ``jax.grad`` of
  ``jax.vjp`` at 1e-4 of the largest entry, in f32 and on a bf16 volume
  (JAX on its f32 copy; the port's bf16 volume gradient is an f32 sum
  rounded once to bf16, so it is held at one bf16 rounding, 2^-8); each
  new kernel's plain version (K1g, K1s, K2g, K2s) against
  ``torch.autograd`` of K1b's / K2b's plain version."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from surf_tpu.config import ConfigFactory as JConf
from surf_tpu.ops import grid_sample as jgs
from surf_tpu_torch.config import ConfigFactory as TConf
from surf_tpu_torch.convert import from_jax
from surf_tpu_torch.ops import grid_sample as tgs


def _close(got, ref, rtol=1e-5, atol=1e-5, err_msg=""):
    """atol relative to max(1, the largest reference entry)."""
    got = got.detach().float().numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref, np.float32)
    scale = max(1.0, float(np.abs(ref).max()) if ref.size else 1.0)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol * scale, err_msg=err_msg)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _jax_tree(init, conf, seed):
    """The parameter tree of a JAX ``init(key, conf)`` (its shapes, by
    ``jax.eval_shape``: compiling the init's random draws takes some 10 s
    on the CPU), filled from a numpy seed: each weight normal with std
    1/sqrt(fan-in), each vector normal with std 0.1."""
    rng = np.random.RandomState(seed)

    def fill(s):
        if len(s.shape) < 2:
            return rng.normal(0, 0.1, s.shape).astype(np.float32)
        return (rng.randn(*s.shape) / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)
    return jax.tree.map(fill, jax.eval_shape(lambda key: init(key, conf),
                                             jax.random.PRNGKey(seed)))


def _params(jparams):
    return from_jax(jax.tree.map(np.asarray, jparams), {})[0]


# ---------------------------------------------------------------------------
# feature networks and the converter
# ---------------------------------------------------------------------------

def test_apply_legacy_matches_jax():
    from surf_tpu.nn import feature_net as jfn
    from surf_tpu_torch.nn import feature_net as tfn
    conf = "net { d_base = 8, d_out = 4 }"
    jp = _jax_tree(jfn.init_legacy, JConf.parse_string(conf)["net"], 3)
    tp = tfn.init_legacy(torch.Generator().manual_seed(3), TConf.parse_string(conf)["net"])
    assert jax.tree.map(np.shape, jp) == jax.tree.map(lambda t: tuple(t.shape), tp)
    imgs = np.random.RandomState(4).rand(2, 36, 44, 3).astype(np.float32)
    ref = jax.jit(jfn.apply_legacy)(jax.tree.map(jnp.asarray, jp), jnp.asarray(imgs))
    got = tfn.apply_legacy(_params(jp), _t(imgs))
    assert [tuple(g.shape) for g in got] == [(2, 9, 11, 4), (2, 18, 22, 4), (2, 36, 44, 4)]
    for g, r in zip(got, ref):
        _close(g, r, 1e-4, 1e-4)


def _bn_random(tree, rng):
    """Random inference statistics in every batch norm of a numpy tree."""
    if isinstance(tree, dict):
        if set(tree) == {"scale", "bias", "mean", "var"}:
            c = tree["scale"].shape
            return {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
                    "bias": rng.normal(0, 0.1, c).astype(np.float32),
                    "mean": rng.normal(0, 0.1, c).astype(np.float32),
                    "var": rng.uniform(0.5, 1.5, c).astype(np.float32)}
        return {k: _bn_random(v, rng) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_bn_random(v, rng) for v in tree]
    return tree


def test_mnasnet_fpn_matches_jax():
    """The 5 levels, fine to coarse, on 2 x 64 x 96 (tests/test_networks.py's
    shape), with random batch-norm statistics."""
    from surf_tpu.nn import feature_net_mnasnet as jfm
    from surf_tpu_torch.nn import feature_net_mnasnet as tfm
    conf = "net { d_out = [4, 4, 4, 4, 4] }"
    jp = _jax_tree(jfm.init, JConf.parse_string(conf)["net"], 0)
    tp = tfm.init(torch.Generator().manual_seed(0), TConf.parse_string(conf)["net"])
    assert jax.tree.map(np.shape, jp) == jax.tree.map(lambda t: tuple(t.shape), tp)
    p = _bn_random(jp, np.random.RandomState(5))
    imgs = np.random.RandomState(6).rand(2, 64, 96, 3).astype(np.float32)
    ref = jax.jit(jfm.apply)(jax.tree.map(jnp.asarray, p), jnp.asarray(imgs))
    got = tfm.apply(from_jax(p, {})[0], _t(imgs))
    hw = [(64, 96), (32, 48), (16, 24), (8, 12), (4, 6)]
    assert [tuple(g.shape) for g in got] == [(2, h, w, 4) for h, w in hw]
    for g, r in zip(got, ref):
        _close(g, r, 1e-4, 1e-4)


def test_convert_feature_network_old_matches_jax():
    from surf_tpu.convert.torch_converter import convert_feature_network_old as jconv
    from surf_tpu_torch.convert import convert_feature_network_old as tconv
    rng = np.random.RandomState(8)
    d = 8
    shapes = {"conv0.0.conv": (d, 3, 3), "conv0.1.conv": (d, d, 3),
              "conv1.0.conv": (2 * d, d, 5), "conv1.1.conv": (2 * d, 2 * d, 3),
              "conv1.2.conv": (2 * d, 2 * d, 3), "conv2.0.conv": (4 * d, 2 * d, 5),
              "conv2.1.conv": (4 * d, 4 * d, 3), "conv2.2.conv": (4 * d, 4 * d, 3),
              "out2": (4, 4 * d, 3), "out1": (4, 4 * d, 3), "out0": (4, 4 * d, 3),
              "inner1": (4 * d, 2 * d, 3), "inner0": (4 * d, d, 3)}
    sd = {f"fn.{k}.weight": rng.randn(o, i, k_, k_).astype(np.float32)
          for k, (o, i, k_) in shapes.items()}
    ref, got = jconv(sd, "fn"), tconv(sd, "fn")
    assert jax.tree.structure(ref) == jax.tree.structure(got)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(ref)):
        np.testing.assert_array_equal(a, b)
    # the converted tree runs the legacy FPN
    from surf_tpu_torch.nn.feature_net import apply_legacy
    outs = apply_legacy(from_jax(got, {})[0], torch.rand(1, 16, 20, 3))
    assert [tuple(o.shape) for o in outs] == [(1, 4, 5, 4), (1, 8, 10, 4), (1, 16, 20, 4)]


# ---------------------------------------------------------------------------
# rendering net
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode,mrv", [("idr", 4), ("no_view_dir", 0), ("no_normal", 0)])
def test_rendering_net_matches_jax(mode, mrv):
    from surf_tpu.nn import rendering_net as jrn
    from surf_tpu_torch.nn import rendering_net as trn
    conf = (f"net {{ d_feature = 16, mode = {mode}, d_in = {9 if mode == 'idr' else 6}, "
            f"d_out = 3, d_hidden = 64, n_layers = 3, skip_in = [2], "
            f"multires_view = {mrv}, squeeze_out = True }}")
    static = {}

    def init(key, c):
        p, static["s"] = jrn.init(key, c)
        return p
    jp = _jax_tree(init, JConf.parse_string(conf)["net"], 0)
    js = static["s"]
    tp, ts = trn.init(torch.Generator().manual_seed(0), TConf.parse_string(conf)["net"])
    assert ts == js
    assert jax.tree.map(np.shape, jp) == jax.tree.map(lambda t: tuple(t.shape), tp)
    rng = np.random.RandomState(9)
    ins = [rng.randn(37, c).astype(np.float32) for c in (3, 3, 3, 16)]
    ref = jax.jit(lambda p, *a: jrn.apply(p, js, *a))(jax.tree.map(jnp.asarray, jp),
                                                      *map(jnp.asarray, ins))
    _close(trn.apply(_params(jp), ts, *map(_t, ins)), ref)


# ---------------------------------------------------------------------------
# ops: lookup_volume, the alt grids, sample_pdf, projection
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["bilinear", "nearest", "grad"])
def test_lookup_volume_matches_jax(mode):
    rng = np.random.RandomState(10)
    vols = [rng.randn(5, 6, 7, 2).astype(np.float32), rng.randn(5, 6, 7, 3).astype(np.float32)]
    pts = rng.uniform(-1.2, 1.2, (4, 50, 3)).astype(np.float32)
    for align in (None, True, False):
        ref = jgs.lookup_volume(jnp.asarray(pts), [jnp.asarray(v) for v in vols], mode=mode,
                                align_corners=align)
        got = tgs.lookup_volume(_t(pts), [_t(v) for v in vols], mode=mode,
                                align_corners=align)
        assert tuple(got.shape) == (4, 50, 5)
        _close(got, ref)
        one = tgs.lookup_volume(_t(pts), _t(vols[0]), mode=mode, align_corners=align)
        _close(one, ref[..., :2])


def test_alt_grids_match_jax():
    """Values and first derivatives (in the points and the grids) of the
    spherical and triplane lookups; the points stay off the poles."""
    from surf_tpu.ops import alt_grids as jag
    from surf_tpu_torch.ops import alt_grids as tag
    rng = np.random.RandomState(12)
    pts = rng.uniform(-2, 2, (64, 3)).astype(np.float32)
    assert np.abs(pts[:, 2] / np.linalg.norm(pts, axis=1)).max() < 0.999
    vol = rng.rand(8, 9, 10, 2).astype(np.float32)
    tri = [{k: rng.rand(9, 8, 4).astype(np.float32) for k in ("xy", "xz", "yz")},
           {k: rng.rand(5, 6, 4).astype(np.float32) for k in ("xy", "xz", "yz")}]
    ct_s, ct_t = rng.randn(64, 2).astype(np.float32), rng.randn(64, 8).astype(np.float32)
    _close(tag.equirect2sphere(_t(pts)), jax.jit(jag.equirect2sphere)(jnp.asarray(pts)))
    pc = np.clip(pts, -0.9, 0.9)
    jt = jax.tree.map(jnp.asarray, tri)
    for align in (False, True):
        def jsphe(p, v):
            out = jag.lookup_sphe_volume(jag.equirect2sphere(p), v, align_corners=align)
            return jnp.sum(out * ct_s), out

        def jtri(p, t):
            out = jag.lookup_triplane(p, t, align_corners=align)
            return jnp.sum(out * ct_t), out
        p, v = _t(pts).requires_grad_(), _t(vol).requires_grad_()
        out = tag.lookup_sphe_volume(tag.equirect2sphere(p), v, align_corners=align)
        (_, ref), grads = jax.jit(jax.value_and_grad(jsphe, (0, 1), has_aux=True))(
            jnp.asarray(pts), jnp.asarray(vol))
        _close(out, ref)
        for g, r in zip(torch.autograd.grad((out * _t(ct_s)).sum(), (p, v)), grads):
            _close(g, r)
        p = _t(pc).requires_grad_()
        tt = [{k: _t(a).requires_grad_() for k, a in d.items()} for d in tri]
        out = tag.lookup_triplane(p, tt, align_corners=align)
        (_, ref), (gp, gt) = jax.jit(jax.value_and_grad(jtri, (0, 1), has_aux=True))(
            jnp.asarray(pc), jt)
        _close(out, ref)
        grads = torch.autograd.grad((out * _t(ct_t)).sum(),
                                    [p] + [d[k] for d in tt for k in ("xy", "xz", "yz")])
        refs = [gp] + [d[k] for d in gt for k in ("xy", "xz", "yz")]
        for g, r in zip(grads, refs):
            _close(g, r)


def test_sample_pdf_matches_jax():
    from surf_tpu.ops.sampling import sample_pdf as jsample
    from surf_tpu_torch.ops import sampling as tsm
    rng = np.random.RandomState(7)
    bins = np.sort(rng.rand(40, 16).astype(np.float32), axis=1)
    weights = rng.rand(40, 16).astype(np.float32)
    weights[3] = 0.0                     # a ray with no weight: zero-width bins
    weights[5, :8] = 0.0
    key = jax.random.PRNGKey(3)
    ref = jsample(key, jnp.asarray(bins), jnp.asarray(weights), 24, det=False)
    u = jax.random.uniform(key, (40, 24))
    got = tsm._invert_cdf(tsm._cdf(_t(weights)), _t(bins), _t(u))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)
    ref = jsample(key, jnp.asarray(bins), jnp.asarray(weights), 24, det=True)
    np.testing.assert_allclose(tsm.sample_pdf(_t(bins), _t(weights), 24, det=True).numpy(),
                               np.asarray(ref), atol=1e-6)
    out = tsm.sample_pdf(_t(bins), _t(weights), 24, generator=torch.Generator().manual_seed(0))
    assert out.shape == (40, 24) and (out >= bins.min()).all() and (out <= bins.max()).all()


def test_projection_helpers_match_jax():
    from surf_tpu.ops import projection as jpr
    from surf_tpu_torch.ops import projection as tpr
    rng = np.random.RandomState(13)
    pts = rng.randn(3, 17, 3).astype(np.float32) + np.array([0, 0, 4], np.float32)
    c2w = _pose(rng, 0.3)
    intr = np.eye(4, dtype=np.float32)
    intr[:3, :3] = [[50.0, 0.5, 20.0], [0.0, 45.0, 15.0], [0.0, 0.0, 1.0]]
    _close(tpr.world_to_cam(_t(pts), _t(c2w)), jpr.world_to_cam(jnp.asarray(pts), c2w))
    cam = jpr.world_to_cam(jnp.asarray(pts), c2w)
    for got, ref in ((tpr.cam_to_pixel(_t(cam), _t(intr)), jpr.cam_to_pixel(cam, intr)),
                     (tpr.project_points(_t(pts), _t(intr), _t(c2w)),
                      jpr.project_points(jnp.asarray(pts), intr, c2w))):
        for g, r in zip(got, ref):
            _close(g, r)
    _close(tpr.to_homo(_t(pts)), jpr.to_homo(jnp.asarray(pts)))


# ---------------------------------------------------------------------------
# the geometric-consistency filter and loss
# ---------------------------------------------------------------------------

def _pose(rng, angle):
    """A camera-to-world pose: a small rotation about a random axis, a small
    translation."""
    axis = rng.randn(3)
    axis /= np.linalg.norm(axis)
    k = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    R = np.eye(3) + np.sin(angle) * k + (1 - np.cos(angle)) * k @ k
    c2w = np.eye(4)
    c2w[:3, :3], c2w[:3, 3] = R, rng.uniform(-0.1, 0.1, 3)
    return c2w.astype(np.float32)


def _layers_scene():
    """tests/test_layers.py's geocheck scene: 3 views of a fronto-parallel
    plane at z = 2, the last one corrupted in ``bad``."""
    H, W, nv = 24, 32, 3
    K = np.eye(4, dtype=np.float32)
    K[0, 0] = K[1, 1] = 40.0
    K[0, 2], K[1, 2] = W / 2, H / 2
    intrs = np.stack([K] * nv)
    c2ws = np.stack([np.eye(4, dtype=np.float32) for _ in range(nv)])
    c2ws[1][0, 3], c2ws[2][0, 3] = 0.05, -0.05
    depths = np.full((nv, H, W), 2.0, np.float32)
    bad = depths.copy()
    bad[2] = 7.0
    return intrs, c2ws, depths, bad


def _random_scene(rng, nv=3, H=30, W=40):
    """nv views of a tilted plane with depth noise, a block of one view
    corrupted: the masks hold both decisions."""
    K = np.eye(4, dtype=np.float32)
    K[0, 0], K[1, 1], K[0, 2], K[1, 2] = 42.0, 40.0, W / 2 - 0.3, H / 2 + 0.2
    intrs = np.stack([K] * nv)
    c2ws = np.stack([_pose(rng, 0.03 * i) for i in range(nv)])
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
    depths = np.stack([2.0 + 0.01 * xs + 0.005 * ys + rng.normal(0, 0.01, (H, W))
                       for _ in range(nv)]).astype(np.float32)
    depths[1, 5:15, 10:25] *= 2.5
    return intrs, c2ws, depths


def test_geocheck_matches_jax_on_the_layers_scenes():
    from surf_tpu.nn import volume as jvol
    from surf_tpu_torch.nn import volume as tvol
    intrs, c2ws, depths, bad = _layers_scene()
    for d in (depths, bad):
        ref = jax.jit(jvol.geocheck_depths)(jnp.asarray(d), jnp.asarray(intrs),
                                            jnp.asarray(c2ws))
        got = tvol.geocheck_depths(_t(d), _t(intrs), _t(c2ws))
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    pts = np.array([[0.0, 0.0, 2.0], [0.0, 0.0, 5.0], [0.1, -0.05, 2.02]], np.float32)
    valid = np.array([True, True, False])
    ref = jax.jit(jvol.depth_consistency_geocheck)(
        jnp.asarray(pts), jnp.asarray(valid), jnp.asarray(bad), jnp.asarray(intrs),
        jnp.asarray(c2ws), 0.3)
    got = tvol.depth_consistency_geocheck(_t(pts), torch.from_numpy(valid), _t(bad),
                                          _t(intrs), _t(c2ws), 0.3)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    assert got[1].tolist() == [True, False, False]


def test_geocheck_matches_jax_on_a_random_scene():
    from surf_tpu.nn import volume as jvol
    from surf_tpu_torch.nn import volume as tvol
    rng = np.random.RandomState(14)
    intrs, c2ws, depths = _random_scene(rng)
    ref = np.asarray(jax.jit(jvol.geocheck_depths)(jnp.asarray(depths), jnp.asarray(intrs),
                                                   jnp.asarray(c2ws)))
    got = tvol.geocheck_depths(_t(depths), _t(intrs), _t(c2ws)).numpy()
    kept = ref != 0
    assert 0.05 < kept.mean() < 0.95             # both decisions are taken
    np.testing.assert_array_equal(got != 0, kept)
    _close(got, ref)
    pts = (rng.uniform(-0.6, 0.6, (400, 3)) * [1.0, 1.0, 0.5] + [0, 0, 2.2]).astype(np.float32)
    valid = rng.rand(400) < 0.9
    ref = jax.jit(jvol.depth_consistency_geocheck)(
        jnp.asarray(pts), jnp.asarray(valid), jnp.asarray(depths), jnp.asarray(intrs),
        jnp.asarray(c2ws), 0.1)
    got = tvol.depth_consistency_geocheck(_t(pts), torch.from_numpy(valid), _t(depths),
                                          _t(intrs), _t(c2ws), 0.1)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    assert 0 < got[1].sum() < 400


@pytest.mark.parametrize("parent_cap", [160, 100])
def test_upsample_and_filter_matches_jax(parent_cap):
    """A dense 8^3 stage subdivided to 16^3 against 3 views of the plane
    z = 0 (one view corrupted in a block): the new grid's fields and the
    children's broadcast features exactly, with the cap above the
    surviving parents' count and below it (overflow drops the same ones)."""
    from surf_tpu.nn import volume as jvol
    from surf_tpu.ops import sparse as jsp
    from surf_tpu_torch.nn import volume as tvol
    from surf_tpu_torch.ops import sparse as tsp
    rng = np.random.RandomState(16)
    H, W, nv = 24, 32, 3
    K = np.eye(4, dtype=np.float32)
    K[0, 0] = K[1, 1] = 20.0
    K[0, 2], K[1, 2] = W / 2, H / 2
    intrs = np.stack([K] * nv)
    c2ws = np.stack([np.eye(4, dtype=np.float32) for _ in range(nv)])
    c2ws[:, 0, 3], c2ws[:, 2, 3] = [0.0, 0.1, -0.1], -2.5
    depths = (2.5 + rng.normal(0, 0.01, (nv, H, W))).astype(np.float32)
    depths[2, 4:14, 6:20] = 4.0
    prev_mid = rng.normal(0, 1, (512, 5)).astype(np.float32)
    jgrid, jup = jvol.upsample_and_filter(
        jsp.dense_base_grid(8), jnp.asarray(prev_mid), jnp.asarray(depths),
        jnp.asarray(intrs), jnp.asarray(c2ws), 0.15, parent_cap)
    tgrid, tup = tvol.upsample_and_filter(
        tsp.dense_base_grid(8), _t(prev_mid), _t(depths), _t(intrs), _t(c2ws), 0.15,
        parent_cap)
    assert tgrid.res == jgrid.res == 16
    for f in ("parents", "pvalid", "cvalid", "parent_table"):
        np.testing.assert_array_equal(getattr(tgrid, f).numpy(),
                                      np.asarray(getattr(jgrid, f)), err_msg=f)
    np.testing.assert_array_equal(tup.numpy(), np.asarray(jup))
    # both decisions taken, and the cap binds in the second case
    assert 0 < int(tgrid.cvalid.sum()) < tgrid.cvalid.numel()
    assert int(tgrid.pvalid.sum()) == min(parent_cap, 128)


def test_consistency_loss_and_gradients_match_jax():
    """The loss at 1e-5 and its gradients in the reference depth (through
    K1's coordinates, K1b's d_coords) and the source depth (K1b's d_image)
    at 1e-4 of the largest entry."""
    from surf_tpu.losses.consistency import compute_consistency_loss as jloss
    from surf_tpu_torch.losses import compute_consistency_loss as tloss
    rng = np.random.RandomState(15)
    intrs, c2ws, depths = _random_scene(rng, nv=2, H=20, W=28)
    ref_d = depths[0]
    src_d = (depths[0] * (1 + rng.normal(0, 0.002, depths[0].shape))).astype(np.float32)
    mask = np.zeros(ref_d.shape, np.float32)
    mask[3:-3, 3:-3] = 1.0

    def f(a, b):
        return jloss(a, b, jnp.asarray(intrs), jnp.asarray(c2ws), 1, jnp.asarray(mask),
                     jnp.asarray(mask))
    ref, refg = jax.jit(jax.value_and_grad(f, (0, 1)))(jnp.asarray(ref_d),
                                                       jnp.asarray(src_d))
    ra, rb = _t(ref_d).requires_grad_(), _t(src_d).requires_grad_()
    got = tloss(ra, rb, _t(intrs), _t(c2ws), 1, _t(mask), _t(mask))
    assert float(ref) > 0
    _close(got, ref)
    for g, r in zip(torch.autograd.grad(got, (ra, rb)), refg):
        assert np.abs(np.asarray(r)).max() > 0
        _close(g, r, 1e-4, 1e-4)


# ---------------------------------------------------------------------------
# utils/tools
# ---------------------------------------------------------------------------

class _StubWriter:
    def __init__(self):
        self.calls = []

    def add_scalar(self, tag, value, step):
        self.calls.append((tag, value, step))


def test_tools_match_jax():
    from surf_tpu.utils import tools as jt
    from surf_tpu_torch.utils import tools as tt
    data = {"a": np.arange(6, dtype=np.float32).reshape(2, 3), "b": [np.int64(3), 2.5],
            "c": ("name", {"d": 7}), "e": torch.ones(2)}
    ref, got = jt.to_device({k: v for k, v in data.items() if k != "e"}), tt.to_device(data,
                                                                                     "cpu")
    for path in (("a",), ("b", 0), ("b", 1), ("c", 1, "d")):
        r, g = ref, got
        for k in path:
            r, g = r[k], g[k]
        # the values JAX's; the dtype numpy's (JAX narrows 64-bit types
        # unless x64 is on)
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    assert got["a"].dtype == torch.float32 and got["b"][0].dtype == torch.int64
    assert got["c"][0] == "name" and isinstance(got["c"], tuple) and got["e"].device.type == "cpu"
    scal = {"loss": torch.tensor(0.25), "psnr": np.float32(31.5), "name": "x", "n": 4}
    assert tt.tensor2float(scal) == jt.tensor2float({**scal, "loss": 0.25})
    rows = [{"loss": 1.0, "psnr": 30.0, "tag": "a"}, {"loss": 3.0, "n": 2}, {"loss": 2.0}]
    ws = (_StubWriter(), _StubWriter())
    mj, mt = jt.DictAverageMeter(), tt.DictAverageMeter()
    for i, row in enumerate(rows):
        jt.save_scalars(ws[0], "train", row, i)
        tt.save_scalars(ws[1], "train", row, i)
        mj.update(row)
        mt.update(row)
    assert ws[0].calls == ws[1].calls and len(ws[1].calls) == 5
    assert (mt.avg_data, mt.sum_data, mt.count) == (mj.avg_data, mj.sum_data, mj.count)
    jt.setup_seed(21)
    a = np.random.rand(3)
    gen = tt.setup_seed(21)
    np.testing.assert_array_equal(np.random.rand(3), a)
    assert torch.equal(torch.rand(4, generator=gen),
                       torch.rand(4, generator=torch.Generator().manual_seed(21)))


# ---------------------------------------------------------------------------
# the second order of K1 / K2
# ---------------------------------------------------------------------------

def test_double_backward_no_longer_raises():
    """The eikonal case: the gradient of |dy/dx|^2 through a volume lookup
    and through an image lookup, in the points and the grid.  (While K1's
    and K2's backward was first order only this raised.)  A third order
    still raises (a known difference from JAX)."""
    g = torch.Generator().manual_seed(0)
    vol = torch.randn(6, 7, 8, 1, generator=g, requires_grad=True)
    img = torch.randn(9, 10, 2, generator=g, requires_grad=True)
    for fn, grid, n in ((lambda p: tgs.lookup_volume(p, vol, mode="grad"), vol, 3),
                        (lambda p: tgs.bilinear_sample_2d(img, p).sum(-1, keepdim=True),
                         img, 2)):
        pts = (torch.rand(50, n, generator=g) * 1.8 - 0.9).requires_grad_()
        d, = torch.autograd.grad(fn(pts).sum(), pts, create_graph=True)
        eik = (d ** 2).sum()
        gp, gv = torch.autograd.grad(eik, (pts, grid), create_graph=True)
        assert torch.isfinite(gp).all() and torch.isfinite(gv).all() and gv.abs().max() > 0
        with pytest.raises(RuntimeError):
            torch.autograd.grad(gv.sum() + gp.sum(), grid)


def _jax_second(sample, V, x, ct, G, h):
    """d/d(V, x, ct) of <dV, G> + <dx, h>, (dV, dx) = vjp(sample)(ct)."""
    def f(V, x, ct):
        dV, dx = jax.vjp(sample, V, x)[1](ct)
        return jnp.sum(dV * G) + jnp.sum(dx * h)
    return jax.jit(jax.grad(f, (0, 1, 2)))(V, x, ct)


def _port_second(sample, V, x, ct, G, h):
    V, x, ct = (t.clone().requires_grad_() for t in (V, x, ct))
    dV, dx = torch.autograd.grad(sample(V, x), (V, x), ct, create_graph=True)
    return torch.autograd.grad((dV.float() * G).sum() + (dx * h).sum(), (V, x, ct))


@pytest.mark.parametrize("align", [True, False])
@pytest.mark.parametrize("case", ["bilinear_sample_2d", "lookup_volume grad f32",
                                  "lookup_volume grad bf16"])
def test_second_order_matches_jax(case, align):
    rng = np.random.RandomState(16 + align)
    if case == "bilinear_sample_2d":
        V = rng.randn(9, 11, 3).astype(np.float32)
        x = rng.uniform(-1.2, 1.2, (60, 2)).astype(np.float32)
        jfn = lambda V, x: jgs.bilinear_sample_2d(V, x, align_corners=align)   # noqa: E731
        tfn = lambda V, x: tgs.bilinear_sample_2d(V, x, align_corners=align)   # noqa: E731
    else:
        V = rng.randn(6, 7, 8, 2).astype(np.float32)
        x = rng.uniform(-1.2, 1.2, (60, 3)).astype(np.float32)
        jfn = lambda V, x: jgs.lookup_volume(x, V, mode="grad", align_corners=align)  # noqa
        tfn = lambda V, x: tgs.lookup_volume(x, V, mode="grad", align_corners=align)  # noqa
    bf16 = case.endswith("bf16")
    Vt = _t(V).bfloat16() if bf16 else _t(V)
    V = Vt.float().numpy()                       # JAX on the bf16 values' f32 copy
    ct = rng.randn(60, V.shape[-1]).astype(np.float32)
    G = _t(rng.randn(*V.shape)).bfloat16().float().numpy()
    h = rng.randn(*x.shape).astype(np.float32)
    ref = _jax_second(jfn, *map(jnp.asarray, (V, x, ct, G, h)))
    got = _port_second(tfn, Vt, _t(x), _t(ct), _t(G), _t(h))
    assert got[0].dtype == Vt.dtype
    for g, r, what in zip(got, ref, ("d volume", "d coords", "d cotangent")):
        assert np.abs(np.asarray(r)).max() > 0
        rtol = 2.0 ** -8 if (bf16 and what == "d volume") else 1e-4
        _close(g, r, rtol, 1e-4, err_msg=what)


@pytest.mark.parametrize("align", [True, False])
@pytest.mark.parametrize("kernel", ["K1g", "K1s", "K2g", "K2s"])
def test_second_order_plain_versions_match_autograd(kernel, align):
    """Each new kernel's plain version against ``torch.autograd`` of K1b's
    / K2b's plain version (d/d ct, d/d coords and d/d image-or-volume of
    <d_coords, h>), 1e-5 of the largest entry."""
    rng = np.random.RandomState(17)
    if kernel.startswith("K1"):
        V = _t(rng.randn(2, 7, 9, 3))
        x = _t(rng.uniform(-1.3, 1.3, (2, 40, 2)))
        bwd, gather, scatter = (tgs.bilinear_sample_bwd_plain,
                                tgs.bilinear_sample_bwd2_gather_plain,
                                tgs.bilinear_sample_bwd2_scatter_plain)
    else:
        V = _t(rng.randn(5, 6, 7, 3))
        x = _t(rng.uniform(-1.3, 1.3, (40, 3)))
        bwd, gather, scatter = (tgs.trilinear_sample_bwd_plain,
                                tgs.trilinear_sample_bwd2_gather_plain,
                                tgs.trilinear_sample_bwd2_scatter_plain)
    ct = _t(rng.randn(*x.shape[:-1], 3))
    h = _t(rng.randn(*x.shape))
    Vr, xr, ctr = (t.clone().requires_grad_() for t in (V, x, ct))
    dx = bwd(Vr, xr, ctr, align_corners=align)[1]
    gV, gx, gct = torch.autograd.grad((dx * h).sum(), (Vr, xr, ctr))
    if kernel.endswith("g"):
        d, hess = gather(V, x, h, ct, align_corners=align)
        _close(d, gct.numpy())
        _close(hess, gx.numpy())
        assert gather(V, x, h, need_hess=False, align_corners=align)[1] is None
        assert gather(V, x, h, ct, need_dir=False, align_corners=align)[0] is None
    else:
        _close(scatter(V, x, h, ct, align_corners=align), gV.numpy())
