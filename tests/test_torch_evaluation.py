"""Port parity of the offline evaluation (``surf_tpu_torch.evaluation``)
against the JAX package's scripts, evaluation/clean_mesh.py,
evaluation/dtu_eval.py, tools/train_synthetic.py and
tools/eval_finetune_meshes.py, loaded as tests/test_evaluation.py loads
them, on fixtures written here:

* ``to_luma`` of ``read_png`` equals Pillow's ``convert("L")`` bit for
  bit on PIL-written L, LA, RGB and RGBA PNGs;
* ``sample_mesh_points`` and ``radius_downsample`` on a sphere sampled
  to about 10^5 points, ``clean_points_by_mask_official`` on points that
  include the one-pixel border: equal bit for bit;
* ``eval_scan`` on the plane-versus-plane fixture (Chamfer 2.0) within
  1e-12 of the JAX one, and ``main``'s ``results.json``;
* ``load_views`` and ``clean_mesh.main`` on a ``DTU_TEST``-layout scan
  (a sphere plus an out-of-mask cube; masks written by
  ``write_dtu_test_scan`` and by PIL, as RGB, L, 1-bit and palette PNGs
  for ``load_views``): the same masks, the same faces;
* ``chamfer_vs_sphere`` within 1e-12 of the tools copy, and the
  synthetic ``main``'s scores within 1e-12 of tools/eval_finetune_meshes.py's
  steps on the JAX modules (with ``scale_mat`` inverted whole).
"""

import importlib.util
import json
import os
import shutil
import sys

import numpy as np
import pytest
from PIL import Image
from scipy.io import savemat

from tiny_conf import TINY
from surf_tpu_torch.data.dtu_scene import write_dtu_test_scan
from surf_tpu_torch.evaluation import clean_mesh as t_clean, dtu_eval as t_eval, \
    synthetic as t_syn
from surf_tpu_torch.geometry import Mesh
from surf_tpu_torch.io import read_png, to_luma, write_ply

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_script(*parts):
    path = os.path.join(ROOT, *parts)
    spec = importlib.util.spec_from_file_location("jax_" + "_".join(parts)[:-3], path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


j_eval = _load_script("evaluation", "dtu_eval.py")
j_clean = _load_script("evaluation", "clean_mesh.py")
j_train_syn = _load_script("tools", "train_synthetic.py")


def _uv_sphere(radius, center, n_lat=30, n_lon=60):
    lat = np.linspace(0, np.pi, n_lat + 1)[1:-1]
    lon = np.linspace(0, 2 * np.pi, n_lon, endpoint=False)
    la, lo = np.meshgrid(lat, lon, indexing="ij")
    ring = np.stack([np.sin(la) * np.cos(lo), np.sin(la) * np.sin(lo), np.cos(la)],
                    -1).reshape(-1, 3)
    verts = np.concatenate([[[0, 0, 1]], ring, [[0, 0, -1]]]) * radius + center
    idx = lambda i, j: 1 + i * n_lon + (j % n_lon)
    bot = len(verts) - 1
    faces = []
    for j in range(n_lon):
        faces += [[0, idx(0, j), idx(0, j + 1)], [bot, idx(n_lat - 2, j + 1), idx(n_lat - 2, j)]]
    for i in range(n_lat - 2):
        for j in range(n_lon):
            a, b, c, d = idx(i, j), idx(i, j + 1), idx(i + 1, j), idx(i + 1, j + 1)
            faces += [[a, c, b], [b, c, d]]
    return verts.astype(np.float32), np.asarray(faces, np.int64)


def _cube(size, center):
    s = size / 2
    v = np.array([[x, y, z] for x in (-s, s) for y in (-s, s) for z in (-s, s)],
                 np.float32) + center
    f = np.array([[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5], [0, 4, 5], [0, 5, 1],
                  [2, 3, 7], [2, 7, 6], [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3]])
    return v, f


# -- to_luma -----------------------------------------------------------------

@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA"])
def test_to_luma_equals_pillow_convert_l(mode, tmp_path):
    rng = np.random.default_rng(len(mode))
    shape = (37, 53) if mode == "L" else (37, 53, len(mode))
    a = rng.integers(0, 256, shape, dtype=np.uint8)
    a[0, :8] = 0
    a[1, :8] = 255
    path = str(tmp_path / f"{mode}.png")
    Image.fromarray(a, mode).save(path)
    got = to_luma(read_png(path))
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, np.array(Image.open(path).convert("L")))


def test_to_luma_refuses_other_pixels():
    with pytest.raises(ValueError):
        to_luma(np.zeros((4, 4), np.float32))
    with pytest.raises(ValueError):
        to_luma(np.zeros((4, 4, 5), np.uint8))


# -- sampling, downsampling, the official mask test ---------------------------

def test_sample_and_radius_downsample_equal_the_jax_scripts():
    v, f = _uv_sphere(18.0, np.array([3.0, -2.0, 40.0]), n_lat=40, n_lon=80)
    v = v.astype(np.float64)
    pts = t_eval.sample_mesh_points(v, f, 0.2)
    ref = j_eval.sample_mesh_points(v, f, 0.2)
    assert 80_000 < len(pts) < 200_000
    np.testing.assert_array_equal(pts, ref)
    down = t_eval.radius_downsample(pts, 0.2)
    np.testing.assert_array_equal(down, j_eval.radius_downsample(pts, 0.2))
    assert 0 < len(down) < len(pts)


@pytest.mark.parametrize("minimal_vis", [0, 1])
def test_clean_points_by_mask_official_equals_the_jax_script(minimal_vis):
    rng = np.random.default_rng(3)
    h, w, nv = 30, 40, 3
    masks = (rng.random((nv, h, w)) < 0.5).astype(np.float32)
    projs = []
    for _ in range(nv):
        K = np.array([[35.0, 0, w / 2], [0, 35.0, h / 2], [0, 0, 1]])
        t = np.array([[rng.uniform(-0.2, 0.2)], [rng.uniform(-0.2, 0.2)], [0.0]])
        projs.append(K @ np.concatenate([np.eye(3), t], 1))
    # random points, then points on and one pixel beyond each image border
    pts = np.concatenate([rng.uniform(-0.8, 0.8, (2000, 2)), np.ones((2000, 1))], 1)
    u = np.concatenate([np.full(40, -1.0), np.full(40, -0.6), np.full(40, w - 0.5),
                        np.full(40, float(w)), np.arange(40.0)])
    vv = np.concatenate([np.arange(40.0) % h] * 4 + [np.full(40, -1.0)])
    K = np.array([[35.0, 0, w / 2], [0, 35.0, h / 2], [0, 0, 1]])
    border = np.linalg.solve(K, np.stack([u, vv, np.ones_like(u)]))
    pts = np.concatenate([pts, border.T * rng.uniform(1, 3, (len(u), 1))])
    got = t_clean.clean_points_by_mask_official(pts, masks, projs, minimal_vis)
    ref = j_clean.clean_points_by_mask_official(pts, masks, projs, minimal_vis)
    np.testing.assert_array_equal(got, ref)
    assert 0 < got.sum() < len(pts)


# -- eval_scan: plane against plane, Chamfer 2.0 ------------------------------

def _write_plane_scan(dataset_dir, out_dir, scan):
    """Mesh: the plane z = 0 over [10, 50]^2; STL: the plane z = 2 (as
    tests/test_evaluation.py writes them)."""
    os.makedirs(os.path.join(out_dir, "meshes", "final"), exist_ok=True)
    for sub in ("ObsMask", os.path.join("Points", "stl")):
        os.makedirs(os.path.join(dataset_dir, sub), exist_ok=True)
    g = np.linspace(10, 50, 5)
    xx, yy = np.meshgrid(g, g, indexing="ij")
    verts = np.stack([xx.ravel(), yy.ravel(), np.zeros(xx.size)], -1)
    faces = []
    for i in range(4):
        for j in range(4):
            a = i * 5 + j
            faces += [[a, a + 5, a + 1], [a + 1, a + 5, a + 6]]
    write_ply(os.path.join(out_dir, "meshes", "final", f"scan{scan}.ply"),
              verts.astype(np.float32), np.asarray(faces, np.int32))
    gs = np.arange(10, 50.01, 0.5)
    sx, sy = np.meshgrid(gs, gs, indexing="ij")
    stl = np.stack([sx.ravel(), sy.ravel(), np.full(sx.size, 2.0)], -1)
    write_ply(os.path.join(dataset_dir, "Points", "stl", f"stl{scan:03}_total.ply"),
              stl.astype(np.float32))
    BB = np.array([[0.0, 0.0, -5.0], [60.0, 60.0, 5.0]])
    savemat(os.path.join(dataset_dir, "ObsMask", f"ObsMask{scan}_10.mat"),
            {"ObsMask": np.ones((61, 61, 11), np.uint8), "BB": BB, "Res": np.array([[1.0]])})
    savemat(os.path.join(dataset_dir, "ObsMask", f"Plane{scan}.mat"),
            {"P": np.array([[0.0], [0.0], [1.0], [1.0]])})


@pytest.fixture(scope="module")
def plane_scans(tmp_path_factory):
    root = tmp_path_factory.mktemp("dtu_eval")
    out_dir, dataset_dir = str(root / "outputs"), str(root / "evaluation")
    for scan in (24, 37):
        _write_plane_scan(dataset_dir, out_dir, scan)
    return out_dir, dataset_dir


def test_eval_scan_equals_the_jax_script_on_planes(plane_scans):
    out_dir, dataset_dir = plane_scans
    got = t_eval.eval_scan(24, out_dir, dataset_dir)
    ref = j_eval.eval_scan(24, out_dir, dataset_dir)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)
    d2s, s2d, overall = got
    # the bounds of tests/test_evaluation.py: the STL grid's 0.5 pitch
    # adds at most sqrt(2^2 + 0.35^2) - 2 to data->STL
    assert abs(d2s - 2.0) < 0.05 and abs(s2d - 2.0) < 0.02 and abs(overall - 2.0) < 0.04


def test_dtu_eval_main_writes_the_jax_results(plane_scans, monkeypatch):
    out_dir, dataset_dir = plane_scans
    results = {}
    for name, mod in (("port", t_eval), ("jax", j_eval)):
        monkeypatch.setattr(mod, "SCANS", [24, 37])
        monkeypatch.setattr(sys, "argv", ["dtu_eval.py", "--out_dir", out_dir,
                                          "--dataset_dir", dataset_dir])
        mod.main()
        with open(os.path.join(out_dir, "results.json")) as f:
            results[name] = json.load(f)
    assert list(results["port"]) == list(results["jax"]) == ["scan24", "scan37", "mean"]
    for k in ("scan24", "scan37"):
        assert list(results["port"][k]) == ["mean_d2s", "mean_s2d", "overall"]
        np.testing.assert_allclose(list(results["port"][k].values()),
                                   list(results["jax"][k].values()), rtol=0, atol=1e-12)
    assert abs(results["port"]["mean"] - results["jax"]["mean"]) < 1e-12


# -- the official cleaning on a DTU_TEST-layout scan --------------------------

MASK_HW = (240, 320)       # DTU's 1200x1600 cut 5x: the casts' count is the cost
VIEWS = t_clean.VIEW_LIST_SET1[:3]


def _pil_masks(src, dst, mode):
    """The same scan with its masks saved again by PIL as ``mode``."""
    shutil.copytree(src, dst)
    for vid in VIEWS:
        p = os.path.join(dst, "scan24", "mask", f"{vid:03d}.png")
        Image.fromarray(read_png(p)).convert(mode).save(p)
    return dst


@pytest.fixture(scope="module")
def dtu_test(tmp_path_factory):
    root = tmp_path_factory.mktemp("dtu_test")
    port = write_dtu_test_scan(str(root / "port"), scan=24, view_ids=VIEWS, n_ring=5,
                               mask_hw=MASK_HW)
    return {"write_dtu_test_scan": port,
            "pil_rgb": _pil_masks(port, str(root / "pil_rgb"), "RGB"),
            "pil_l": _pil_masks(port, str(root / "pil_l"), "L"),
            "pil_1": _pil_masks(port, str(root / "pil_1"), "1"),
            "pil_p": _pil_masks(port, str(root / "pil_p"), "P")}


def test_dtu_test_fixture_layout(dtu_test):
    root = dtu_test["write_dtu_test_scan"]
    for vid in VIEWS:
        img = read_png(os.path.join(root, "scan24", "mask", f"{vid:03d}.png"))
        assert img.shape == MASK_HW + (3,) and set(np.unique(img)) == {0, 255}
        assert os.path.exists(os.path.join(root, "scan24", "cams", f"{vid:08d}_cam.txt"))


@pytest.mark.parametrize("writer", ["write_dtu_test_scan", "pil_rgb", "pil_l", "pil_1",
                                    "pil_p"])
def test_load_views_equals_the_jax_script(dtu_test, writer):
    got = t_clean.load_views(dtu_test[writer], 24, VIEWS)
    ref = j_clean.load_views(dtu_test[writer], 24, VIEWS)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype
        np.testing.assert_array_equal(g, r)
    assert 0.3 < got[0].mean() < 0.6          # the sphere's silhouette


@pytest.mark.parametrize("writer", ["write_dtu_test_scan", "pil_rgb"])
def test_clean_mesh_main_gives_the_jax_faces(dtu_test, writer, tmp_path, monkeypatch):
    # the scene's sphere (radius 1 at the origin) and a cube below it that
    # every view sees outside its mask
    sv, sf = _uv_sphere(1.0, np.zeros(3))
    cv, cf = _cube(0.2, np.array([0.0, 0.0, -1.6]))
    meshes = {}
    for name, mod in (("port", t_clean), ("jax", j_clean)):
        out = tmp_path / name
        out.mkdir()
        write_ply(str(out / "scan24_epoch0.ply"), np.concatenate([sv, cv]),
                  np.concatenate([sf, cf + len(sv)]).astype(np.int32))
        monkeypatch.setattr(sys, "argv", [
            "clean_mesh.py", "--root_dir", dtu_test[writer], "--out_dir", str(out),
            "--n_view", "3", "--set", "1", "--mask_kernel_size", "11"])
        mod.main()
        meshes[name] = Mesh.load(str(out / "final" / "scan24.ply"))
    np.testing.assert_array_equal(meshes["port"].faces, meshes["jax"].faces)
    np.testing.assert_array_equal(meshes["port"].vertices, meshes["jax"].vertices)
    r = np.linalg.norm(meshes["port"].vertices, axis=-1)
    assert len(meshes["port"].faces) >= 500                    # the sphere is kept
    assert np.abs(r - 1.0).max() < 0.01                        # and the cube gone


# -- the synthetic score ------------------------------------------------------

def test_chamfer_vs_sphere_equals_the_tools_copy():
    rng = np.random.default_rng(5)
    v = rng.normal(size=(3000, 3))
    v = v / np.linalg.norm(v, axis=1, keepdims=True) * rng.uniform(0.9, 1.4, (3000, 1))
    scale_mat = np.diag([1.3, 1.3, 1.3, 1.0])
    scale_mat[:3, 3] = [0.1, -0.2, 0.05]
    for radius in (1.0, 1.3):
        got = t_syn.chamfer_vs_sphere(v.astype(np.float32), scale_mat, radius)
        ref = j_train_syn.chamfer_vs_sphere(v.astype(np.float32), scale_mat, radius)
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)
    # nothing within max_dist: each mean is the bound
    far = t_syn.chamfer_vs_sphere(v * 10.0, np.eye(4), 1.0)
    assert far == (0.2, 0.2, 0.2)


FT_CONF = TINY.replace("./exp/tiny", "./exp/tiny_eval") + """
finetune_dataset {
    dataset_name = SyntheticDatasetFinetune
    scene = syn0
    ref_view = 0
    num_src_view = 2
    img_hw = [64, 80]
    n_rays = 64
    val_res_level = 8
    n_views_total = 6
}
"""


def test_synthetic_main_scores_as_the_jax_modules_do(tmp_path):
    """The synthetic ``main`` against tools/eval_finetune_meshes.py's steps
    on the JAX package's modules (its scene, ``clean_mesh`` and the tools'
    ``chamfer_vs_sphere``), with the scene's ``scale_mat`` inverted whole:
    the tool's ``(v - t) / scale_mat[0, 0]`` is no inverse of this
    scene's rotated ``scale_mat`` (surf_tpu_torch/evaluation/synthetic.py)."""
    from surf_tpu.config import ConfigFactory as JConfigFactory
    from surf_tpu.data.synthetic import SyntheticDataset as JSynthetic
    from surf_tpu.geometry import Mesh as JMesh
    from surf_tpu.geometry.clean_mesh import clean_mesh as j_clean_mesh
    conf = tmp_path / "ft.conf"
    conf.write_text(FT_CONF)
    ds = JSynthetic(JConfigFactory.parse_file(str(conf))["finetune_dataset"], "val")
    scene = ds._build(0)
    S = np.asarray(scene["scale_mat"], np.float64)
    assert abs(S[0, 0]) < 0.5 * abs(np.linalg.det(S[:3, :3])) ** (1 / 3)   # rotated
    (tmp_path / "meshes").mkdir()
    ref = []
    for step, radius in ((-1, 1.08), (4, 1.02), (9, 1.0)):
        v, f = _uv_sphere(radius * ds.radius_world, np.zeros(3), n_lat=24, n_lon=48)
        # the world sphere as validate_finetune writes it: scale_mat applied
        # to normalized vertices
        norm = (v - S[:3, 3]) @ np.linalg.inv(S[:3, :3]).T
        write_ply(str(tmp_path / "meshes" / f"syn0_step{step}.ply"),
                  norm @ S[:3, :3].T + S[:3, 3], f.astype(np.int32))
        m = JMesh.load(str(tmp_path / "meshes" / f"syn0_step{step}.ply"))
        inv = np.linalg.inv(S)
        cleaned = j_clean_mesh(JMesh(m.vertices @ inv[:3, :3].T + inv[:3, 3], m.faces),
                               scene["masks"], scene["intrs"], scene["c2ws"])
        vc = np.asarray(cleaned.vertices, np.float32)
        d2s, s2d, ch = j_train_syn.chamfer_vs_sphere(vc, S, ds.radius_world)
        ref.append((step, ch, d2s, s2d, len(vc)))
    rows = t_syn.main([str(tmp_path), "--conf", str(conf)])
    assert [r[0] for r in rows] == [r[0] for r in ref] == [-1, 4, 9]
    assert [r[4] for r in rows] == [r[4] for r in ref] and min(r[4] for r in rows) > 100
    np.testing.assert_allclose([r[1:4] for r in rows], [r[1:4] for r in ref],
                               rtol=0, atol=1e-12)
    assert rows[0][1] > rows[1][1] > rows[2][1]          # nearer the sphere, lower
