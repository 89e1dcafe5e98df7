"""Port parity for the slice as a whole: a tiny validation (feature net ->
2-stage cascade -> render -> mesh lattice) through surf_tpu_torch against
surf_tpu on the same synthetic scene and the same parameters (JAX init,
carried over by ``convert.from_jax``), all f32, no perturbation.

Active voxel sets are compared keyed by voxel coordinate, never row by
row.  Tolerance 1e-4 relative with a 1e-4 absolute floor for every
composite output (FPN features, stage features, depths, render keys, SDF
lattice): each convolution and product sums f32 terms in another order,
through 8 (FPN) to ~20 (cascade + SDF MLP) layers.  Zero-crossing depths
are compared only where both sides find a gated crossing."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tiny_conf import tiny_conf
from surf_tpu.data.synthetic import SyntheticDataset as JDataset
from surf_tpu.nn import surf as jsurf, feature_net as jfn, implicit_surface as jis
from surf_tpu.nn import sdf_net as jsdf
from surf_tpu.geometry.extract import extract_geometry as j_extract
from surf_tpu.nn.core import materialize_weight_norm as j_fold

from surf_tpu_torch.config import ConfigFactory
from surf_tpu_torch.data import SyntheticDataset as TDataset
from surf_tpu_torch.convert import from_jax
from surf_tpu_torch.nn import implicit_surface as tis
from surf_tpu_torch.validate import Validator, to_device

# one intra-op thread: the suite's xdist workers share the host's cores,
# and a thread a core in every worker oversubscribes them many times over
torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-4
N_RAYS = 96
MESH_RES, MESH_BLOCK = 24, 16


def _close(a, b, rtol=RTOL, atol=ATOL, **kw):
    np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b, np.float32),
                               rtol=rtol, atol=atol, **kw)


@pytest.fixture(scope="module")
def run():
    conf = tiny_conf()
    batch = JDataset(conf["val_dataset"], "val")[0]
    ipts_j = {k: jnp.asarray(v) for k, v in batch.items() if not isinstance(v, str)}
    params, state, static = jsurf.init(jax.random.PRNGKey(0), conf["model"])
    feats_j = jax.jit(jfn.apply)(params["feature_network"], ipts_j["imgs"])
    outs_j, stages_j, mv_j, _ = jsurf.build_volumes(
        jax.random.PRNGKey(1), params, state, static, ipts_j, feats_j,
        perturb=False, training=False, jit_stages=True)
    st_is = dict(static["implicit_surface"], perturb=0.0)
    ff_j = feats_j[::-1]
    sl = slice(0, N_RAYS)
    render_j = jax.jit(
        lambda key, p, ro, rd, mv, stages, ff: jis.render(
            key, p, st_is, ro, rd, ipts_j["near"], ipts_j["far"], mv, stages, ff,
            ff, ipts_j["imgs"], ipts_j["intrs"], ipts_j["c2ws"], 1.0, None))(
        jax.random.PRNGKey(2), params["implicit_surface"], ipts_j["rays_o"][sl],
        ipts_j["rays_d"][sl], mv_j, stages_j[::-1], ff_j)
    sdf_p = j_fold(params["implicit_surface"])

    def sdf_chunk(p, stages, occ, pts):
        m = jis.occupancy_mask([g for g, _ in stages], pts)
        s = jsdf.sdf_only(p["sdf_network"], st_is["sdf"], pts, stages)
        return jnp.where(m[:, None], s, 100.0)[:, 0]

    verts_j, tris_j, u_j = j_extract(jax.jit(sdf_chunk), sdf_p, stages_j[::-1],
                                     MESH_RES, block=MESH_BLOCK)

    # the port, from the same numpy parameters
    tconf = ConfigFactory.parse_string(__import__("tiny_conf").TINY)
    tp, ts = from_jax(jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, state))
    v = Validator(tconf, device="cpu", mesh_resolution=MESH_RES, params=tp, state=ts)
    tbatch = TDataset(tconf["val_dataset"], "val")[0]
    ipts_t = to_device(tbatch, "cpu")
    outs_t, stages_t, mv_t, feats_t = v.build(ipts_t)
    ff_t = feats_t[::-1]
    st_t = dict(v.static["implicit_surface"], perturb=0.0)
    render_t = tis.render(
        tp["implicit_surface"], st_t, ipts_t["rays_o"][sl], ipts_t["rays_d"][sl],
        ipts_t["near"], ipts_t["far"], mv_t, stages_t[::-1], ff_t, ipts_t["imgs"],
        ipts_t["intrs"], ipts_t["c2ws"], 1.0)
    verts_t, tris_t, u_t = v.extract_geometry(stages_t[::-1], MESH_RES, block=MESH_BLOCK)
    return dict(batch=batch, tbatch=tbatch, feats=(feats_j, feats_t),
                outs=(outs_j, outs_t), stages=(stages_j, stages_t), mv=(mv_j, mv_t),
                render=(render_j, render_t), mesh=((verts_j, tris_j, u_j),
                                                   (verts_t, tris_t, u_t)),
                static=(static, v.static))


def test_host_copies_and_static(run):
    for k, a in run["batch"].items():
        b = run["tbatch"][k]
        if isinstance(a, str):
            assert a == b
        else:
            np.testing.assert_array_equal(np.asarray(b), np.asarray(a), err_msg=k)
    js, ts = run["static"]
    for k in ("range_ratios", "num_stage", "base_dim", "parent_caps",
              "dense_unet_max_res", "matching_dtype", "matching_field"):
        assert js[k] == ts[k], k
    assert js["implicit_surface"]["sdf"] == ts["implicit_surface"]["sdf"]


def test_feature_net(run):
    fj, ft = run["feats"]
    assert len(fj) == len(ft)
    for a, b in zip(fj, ft):
        _close(b.numpy(), a, rtol=1e-4, atol=1e-4)


def _by_coord(grid, storage, res):
    cc = np.asarray(grid.child_coords())
    valid = np.asarray(grid.cvalid)
    lin = (cc[valid, 0] * res + cc[valid, 1]) * res + cc[valid, 2]
    order = np.argsort(lin)
    return lin[order], np.asarray(storage)[valid][order]


def test_cascade_active_sets_features_and_depths(run):
    sj, st = run["stages"]
    assert len(sj) == len(st) == 2
    for (gj, fj), (gt, ft) in zip(sj, st):
        assert gj.res == gt.res
        kj, vj = _by_coord(gj, fj, gj.res)
        kt, vt = _by_coord(gt, ft.numpy(), gt.res)
        np.testing.assert_array_equal(kt, kj)
        assert len(kj) > 0
        _close(vt, vj)
    oj, ot = run["outs"]
    for s in range(2):
        for k in (f"depth_stage{s}", f"depth_src_stage{s}", f"occ_reg_stage{s}"):
            _close(ot[k].numpy(), oj[k], err_msg=k)
    mj, mt = run["mv"]
    _close(mt.numpy(), mj)


def test_render_core_keys(run):
    rj, rt = run["render"]
    for k in ("color_fine", "render_depth", "weights", "gradients", "normal",
              "inside_sphere", "mid_z_vals", "weight_sum", "weight_max",
              "gradient_error", "smooth_error", "s_val", "valid_mask"):
        _close(rt[k].numpy(), rj[k], err_msg=k)
    # the random-probe part of sparse_sdf draws its own points
    _close(rt["sparse_sdf"][1024:].numpy(), np.asarray(rj["sparse_sdf"])[1024:])
    both = (rt["mid_inside_sphere"].numpy() > 0) & (np.asarray(rj["mid_inside_sphere"]) > 0)
    agree = (rt["mid_inside_sphere"].numpy() > 0) == (np.asarray(rj["mid_inside_sphere"]) > 0)
    assert agree.mean() > 0.95 and both.sum() > 0
    _close(rt["sdf_depth"].numpy()[both], np.asarray(rj["sdf_depth"])[both])
    assert set(rj) - set(rt) == {"ref_gray_val", "sampled_gray_val"}


def test_mesh_lattice_and_mesh(run):
    (vj, tj, uj), (vt, tt, ut) = run["mesh"]
    _close(ut, uj)
    assert (uj < 100).any() and len(tj) > 0
    assert vt.shape == vj.shape and tt.shape == tj.shape
    _close(vt, vj, atol=1e-4)
    np.testing.assert_array_equal(tt, tj)
