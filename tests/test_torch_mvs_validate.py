"""Port parity for this slice as a whole: the tiny model (tests/tiny_conf.py)
validating a 7-view ETH3D-layout scene (``data.mvs_scene.write_mvs_scene``:
the procedural scene as JPEGs, views 19-25 of scan ``facade``, the
reference 22 and sources 19-21, 23-25 as confs/surf_eth3d.conf names them,
read at a 2:1 ``img_hw`` as that conf reads 4141x6212 into 1200x2400)
through surf_tpu_torch against surf_tpu, with the same parameters (JAX
init, carried over by ``convert.from_jax``), all f32, no perturbation.
It shows that the port handles V = 7 (the view attention of
``back_project``, the blending net over 6 source views, the depth maps of
7 views) as the JAX package does.

Tanks and ETH3D items carry an all-zero ``depth_ref`` and all-one masks
(surf_tpu/data/mvs_generic.py:143-144): the validate's depth losses are 0
as ``Runner.validate``'s formula (surf_tpu/runner.py:679-690) gives them,
and ``--clean_mesh`` keeps the faces the JAX ``clean_mesh`` keeps.

The loaders' items are equal exactly; the composite outputs (FPN features,
stage features keyed by voxel coordinate, depths, render keys, SDF
lattice) are held at tests/test_torch_validate.py's tolerances, 1e-4
relative with a 1e-4 absolute floor, and for the same reason: each
convolution and product sums f32 terms in another order."""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_validate import _by_coord, _close
from tiny_conf import TINY
from surf_tpu.config import ConfigFactory as JConfig
from surf_tpu.data.mvs_generic import ETH3DDataset as JETH3D
from surf_tpu.geometry.clean_mesh import clean_mesh as j_clean_mesh
from surf_tpu.geometry.extract import extract_geometry as j_extract
from surf_tpu.geometry.mesh import Mesh as JMesh
from surf_tpu.nn import surf as jsurf, feature_net as jfn, implicit_surface as jis
from surf_tpu.nn import sdf_net as jsdf
from surf_tpu.nn.core import materialize_weight_norm as j_fold

from surf_tpu_torch.config import ConfigFactory
from surf_tpu_torch.convert import from_jax
from surf_tpu_torch.data.mvs_scene import write_mvs_scene
from surf_tpu_torch.geometry import Mesh, clean_mesh
from surf_tpu_torch.nn import implicit_surface as tis
from surf_tpu_torch.validate import Validator, to_device

# one intra-op thread: the suite's xdist workers share the host's cores,
# and a thread a core in every worker oversubscribes them many times over
torch.set_num_threads(1)

VIEWS = [19, 20, 21, 22, 23, 24, 25]
N_RAYS = 96
MESH_RES, MESH_BLOCK = 24, 16


def eth3d_conf(root):
    return re.sub(r"val_dataset \{[^}]*\}\n", (
        "val_dataset {\n dataset_name = ETH3DDataset\n"
        f" data_dir = {root}\n scene = [facade]\n ref_view = [22]\n"
        " src_views = [19, 20, 21, 23, 24, 25]\n num_src_view = 6\n val_res_level = 4\n"
        " factor = 0.8\n interval_scale = 1\n num_interval = 180\n img_hw = [48, 96]\n}\n"),
        TINY, count=1)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = write_mvs_scene(str(tmp_path_factory.mktemp("eth3d")), "ETH3DDataset", "facade",
                           VIEWS, image_hw=(64, 96))
    text = eth3d_conf(root)
    conf = JConfig.parse_string(text)
    batch = JETH3D(conf["val_dataset"], "val")[0]
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

    tp, ts = from_jax(jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, state))
    v = Validator(ConfigFactory.parse_string(text), device="cpu", mesh_resolution=MESH_RES,
                  params=tp, state=ts, base_exp_dir=str(tmp_path_factory.mktemp("out")))
    tbatch = v.dataset[0]
    ipts_t = to_device(tbatch, "cpu")
    outs_t, stages_t, mv_t, feats_t = v.build(ipts_t)
    st_t = dict(v.static["implicit_surface"], perturb=0.0)
    render_t = tis.render(
        tp["implicit_surface"], st_t, ipts_t["rays_o"][sl], ipts_t["rays_d"][sl],
        ipts_t["near"], ipts_t["far"], mv_t, stages_t[::-1], feats_t[::-1], ipts_t["imgs"],
        ipts_t["intrs"], ipts_t["c2ws"], 1.0)
    verts_t, tris_t, u_t = v.extract_geometry(stages_t[::-1], MESH_RES, block=MESH_BLOCK)
    return dict(validator=v, batch=batch, tbatch=tbatch, feats=(feats_j, feats_t),
                outs=(outs_j, outs_t), stages=(stages_j, stages_t), mv=(mv_j, mv_t),
                render=(render_j, render_t), mesh=((verts_j, tris_j, u_j),
                                                   (verts_t, tris_t, u_t)))


def test_seven_view_item_equal(run):
    b, t = run["batch"], run["tbatch"]
    assert sorted(b) == sorted(t)
    assert t["imgs"].shape == (7, 48, 96, 3) and t["view_ids"].tolist() == [22, 19, 20, 21,
                                                                             23, 24, 25]
    for k, a in b.items():
        if isinstance(a, str):
            assert t[k] == a
        else:
            np.testing.assert_array_equal(np.asarray(t[k]), np.asarray(a), err_msg=k)


def test_seven_view_features(run):
    fj, ft = run["feats"]
    assert len(fj) == len(ft) and ft[0].shape[0] == 7
    for a, b in zip(fj, ft):
        _close(b.numpy(), a)


def test_seven_view_cascade(run):
    sj, st = run["stages"]
    assert len(sj) == len(st) == 2
    for (gj, fj), (gt, ft) in zip(sj, st):
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


def test_seven_view_render(run):
    rj, rt = run["render"]
    for k in ("color_fine", "render_depth", "weights", "gradients", "normal",
              "inside_sphere", "mid_z_vals", "weight_sum", "weight_max", "valid_mask"):
        _close(rt[k].numpy(), rj[k], err_msg=k)
    both = (rt["mid_inside_sphere"].numpy() > 0) & (np.asarray(rj["mid_inside_sphere"]) > 0)
    assert both.sum() > 0
    _close(rt["sdf_depth"].numpy()[both], np.asarray(rj["sdf_depth"])[both])


def test_seven_view_mesh(run):
    (vj, tj, uj), (vt, tt, ut) = run["mesh"]
    _close(ut, uj)
    assert (uj < 100).any() and len(tj) > 0
    assert vt.shape == vj.shape and tt.shape == tj.shape
    _close(vt, vj, atol=1e-4)
    np.testing.assert_array_equal(tt, tj)


def test_seven_view_validate_metrics_and_clean_mesh(run):
    """The whole validate with ``clean_mesh`` on: depth losses 0 against the
    all-zero ``depth_ref``; the cleaning of the uncleaned mesh against the
    all-one masks of 7 views keeps the JAX ``clean_mesh``'s faces."""
    v, item = run["validator"], run["tbatch"]
    (vt, tt, _) = run["mesh"][1]
    masks, intrs, c2ws = item["masks"], item["intrs"], item["c2ws"]
    assert masks.shape == (7, 48, 96) and masks.all() and not item["depth_ref"].any()
    got = clean_mesh(Mesh(vt, tt), masks, intrs, c2ws)
    ref = j_clean_mesh(JMesh(vt, tt), masks, intrs, c2ws)
    np.testing.assert_array_equal(got.faces, ref.faces)
    np.testing.assert_array_equal(got.vertices, ref.vertices)
    v.clean_mesh = True
    (m,) = v.validate()
    assert m["finite"] and m["render_depth_loss"] == 0.0 and m["sdf_depth_loss"] == 0.0
    assert 0 < m["mesh_faces"] <= m["mesh_faces_before_clean"]
    for sub, ext in (("val_img", "png"), ("val_normal", "png"), ("val_sdf_depth", "npy"),
                     ("val_render_depth", "png"), ("val_auxi_depth", "npy")):
        assert os.path.exists(os.path.join(v.base_exp_dir, sub, f"facade_view22_epoch0.{ext}"))
