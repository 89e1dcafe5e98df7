"""The port's host loaders (surf_tpu_torch/data: ``DTUDataset``,
``DTUDatasetFinetune``, ``DTUDatasetFinetuneNeuS`` and the JPEG sets
``BMVSDataset``, ``TanksDataset``, ``ETH3DDataset``) against the JAX
package's on the same miniature on-disk scenes (the DTU, NeuS and BMVS
layouts of tests/test_datasets.py, copied here and extended to the Tanks
and ETH3D layouts, written by PIL and cv2; the DTU one again with
Adam7-interlaced images and 16-bit and palette masks; and the procedural
scene that ``data.mvs_scene.write_mvs_scene`` writes, with baseline and
with progressive JPEGs) and the same seed.  Every key
of every item must be equal exactly: images, masks and depths are the
same pixels (the port reads them with its own PNG/JPEG/PFM readers and
nearest resize, the JAX package with PIL and cv2), and the cameras, rays
and pseudo points come from the same numpy arithmetic on the same values,
so the tolerance for them is 0 as well."""

import os
import shutil

import cv2
import numpy as np
import pytest
from PIL import Image

from surf_tpu.config import ConfigFactory as JConfig
from surf_tpu.data import get_loader as j_get_loader
from surf_tpu.data.dtu import DTUDataset as JDTU
from surf_tpu.data.dtu_finetune import (DTUDatasetFinetune as JFinetune,
                                        DTUDatasetFinetuneNeuS as JNeuS)
from surf_tpu.data.mvs_generic import GenericMVSDataset as JGeneric
from surf_tpu.io.pfm import write_pfm
from surf_tpu.io.ply import write_ply

from surf_tpu_torch.config import ConfigFactory as TConfig
from surf_tpu_torch.data import (DTUDataset as TDTU, DTUDatasetFinetune as TFinetune,
                                 DTUDatasetFinetuneNeuS as TNeuS, get_dataset)
from surf_tpu_torch.data.mvs_generic import _SPECS, GenericMVSDataset as TGeneric
from surf_tpu_torch.data.mvs_scene import write_mvs_scene
from surf_tpu_torch.io.image import read_png, resize_nearest, write_png

H, W = 48, 64


def write_cam(path, vid):
    ang = vid * 0.3
    R = np.array([[np.cos(ang), -np.sin(ang), 0],
                  [np.sin(ang), np.cos(ang), 0],
                  [0, 0, 1]], np.float32)
    t = np.array([0.1 * vid, 0.05 * vid, 4.0 + 0.1 * vid], np.float32)
    extr = np.eye(4, dtype=np.float32)
    extr[:3, :3] = R
    extr[:3, 3] = t
    intr = np.array([[800.0, 0, 800], [0, 800, 600], [0, 0, 1]], np.float32)
    with open(path, "w") as f:
        f.write("extrinsic\n")
        for row in extr:
            f.write(" ".join(str(x) for x in row) + "\n")
        f.write("\nintrinsic\n")
        for row in intr:
            f.write(" ".join(str(x) for x in row) + "\n")
        f.write("\n2.5 0.01\n")


def write_pairs(root, n):
    with open(root / "Cameras/pair.txt", "w") as f:
        f.write(f"{n}\n")
        for ref in range(n):
            srcs = [v for v in range(n) if v != ref][:4]
            f.write(f"{ref}\n{len(srcs)} " +
                    " ".join(f"{s} {100 - i}" for i, s in enumerate(srcs)) + "\n")


def save_png(path, img, writer):
    """PIL or cv2 (which takes BGR) writes the same pixels."""
    if writer == "cv2":
        assert cv2.imwrite(str(path), img[..., ::-1] if img.ndim == 3 else img)
    else:
        Image.fromarray(img).save(path)


@pytest.fixture(scope="module")
def dtu_root(tmp_path_factory):
    """The DTU layout of tests/test_datasets.py:38-70, plus the finetune
    loader's filtered pseudo depths and point cloud; odd views written by
    cv2, even ones by PIL."""
    root = tmp_path_factory.mktemp("dtu")
    scan = "scan24"
    for d in ("Cameras", f"Rectified_raw/{scan}", f"Depths_raw/{scan}",
              f"Pseudo_depths/{scan}", "Pseudo_points", "PseudoMVSDepth",
              f"PseudoMVSScore/dtu_exp/{scan}/filtered_avg_depth"):
        os.makedirs(root / d, exist_ok=True)
    write_pairs(root, 5)
    rng = np.random.RandomState(0)
    for vid in range(5):
        writer = "cv2" if vid % 2 else "pil"
        write_cam(root / f"Cameras/{vid:08d}_cam.txt", vid)
        img = (rng.rand(H * 4, W * 4, 3) * 255).astype(np.uint8)
        for light in range(7):
            save_png(root / f"Rectified_raw/{scan}/rect_{vid + 1:0>3}_{light}_r5000.png",
                     img, writer)
        depth = rng.rand(H, W).astype(np.float32) * 2 + 2.5
        write_pfm(str(root / f"Depths_raw/{scan}/depth_map_{vid:0>4}.pfm"), depth)
        write_pfm(str(root / f"Pseudo_depths/{scan}/{vid:0>8}.pfm"), depth * 1.01)
        write_pfm(str(root / f"PseudoMVSScore/dtu_exp/{scan}/filtered_avg_depth/"
                             f"{vid:0>8}.pfm"),
                  rng.rand(H * 2, W * 2).astype(np.float32) * 2 + 2.5)
        mask = (rng.rand(H * 4, W * 4) > 0.3).astype(np.uint8) * 255
        save_png(root / f"Depths_raw/{scan}/depth_visual_{vid:0>4}.png", mask, writer)
    write_ply(str(root / "Pseudo_points/mvsnet024_l3.ply"),
              rng.randn(500, 3).astype(np.float32))
    write_ply(str(root / "PseudoMVSDepth/mvsnet024_l3.ply"),
              rng.randn(700, 3).astype(np.float32))
    return str(root)


@pytest.fixture(scope="module")
def neus_root(tmp_path_factory):
    """The NeuS layout of tests/test_datasets.py:158-221; view 0's mask is
    RGB (the loader keeps its first channel), the others are L."""
    root = tmp_path_factory.mktemp("neus")
    scan = "scan24"
    base = root / f"neus_data/data_DTU/dtu_{scan}"
    for d in (base / "image", base / "mask", root / "Cameras", root / "PseudoMVSDepth",
              root / f"PseudoMVSScore/dtu_exp/{scan}/filtered_avg_depth"):
        os.makedirs(d, exist_ok=True)
    write_pairs(root, 5)
    rng = np.random.RandomState(1)
    cams = {}
    intr = np.eye(4, dtype=np.float32)
    intr[:3, :3] = np.array([[800.0, 0, 800], [0, 800, 600], [0, 0, 1]])
    scale = np.eye(4, dtype=np.float32) * 2.0
    scale[3, 3] = 1.0
    scale[:3, 3] = [0.1, 0.2, 0.3]
    for vid in range(5):
        ang = vid * 0.3
        R = np.array([[np.cos(ang), -np.sin(ang), 0],
                      [np.sin(ang), np.cos(ang), 0],
                      [0, 0, 1]], np.float32)
        extr = np.eye(4, dtype=np.float32)
        extr[:3, :3] = R
        extr[:3, 3] = [0.1 * vid, 0.05 * vid, 4.0]
        cams[f"world_mat_{vid}"] = intr @ extr
        cams[f"scale_mat_{vid}"] = scale
        img = (rng.rand(H * 2, W * 2, 3) * 255).astype(np.uint8)
        Image.fromarray(img).save(base / f"image/{vid:0>6}.png")
        mask = (rng.rand(H * 2, W * 2) > 0.3).astype(np.uint8) * 255
        if vid == 0:
            mask = np.stack([mask, 255 - mask, mask], -1)
        Image.fromarray(mask).save(base / f"mask/{vid:0>3}.png")
        depth = rng.rand(H, W).astype(np.float32) * 2 + 2.5
        write_pfm(str(root / f"PseudoMVSScore/dtu_exp/{scan}/"
                             f"filtered_avg_depth/{vid:0>8}.pfm"), depth)
    np.savez(base / "cameras_sphere.npz", **cams)
    write_ply(str(root / "PseudoMVSDepth/mvsnet024_l3.ply"),
              rng.randn(500, 3).astype(np.float32))
    return str(root)


def confs(text):
    return JConfig.parse_string(text)["d"], TConfig.parse_string(text)["d"]


def assert_items_equal(got, ref):
    assert sorted(got) == sorted(ref)
    for k in ref:
        a, b = got[k], ref[k]
        if isinstance(b, str):
            assert a == b, k
            continue
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (k, a.dtype, b.dtype, a.shape)
        np.testing.assert_array_equal(a, b, err_msg=k)


def dtu_conf(root, mode):
    if mode == "train":
        return f"""d {{
            data_dir = {root}
            scene = [scan24]
            ref_view = [0, 1, 2, 3, 4]
            num_src_view = 2
            light_idx = [3, 5]
            factor = 1.0
            interval_scale = 1
            num_interval = 192
            img_hw = [{H}, {W}]
            n_rays = 64
        }}"""
    return f"""d {{
        data_dir = {root}
        scene = [scan24]
        ref_view = [1, 3]
        light_idx = [3]
        num_src_view = 2
        val_res_level = 2
        factor = 1.0
        interval_scale = 1
        num_interval = 192
        img_hw = [{H}, {W}]
    }}"""


@pytest.mark.parametrize("mode", ["train", "val"])
def test_dtu_items_equal_jax(dtu_root, mode):
    jc, tc = confs(dtu_conf(dtu_root, mode))
    jds = JDTU(jc, mode, rng=np.random.RandomState(7))
    tds = TDTU(tc, mode, rng=np.random.RandomState(7))
    assert len(tds) == len(jds) == (10 if mode == "train" else 2)
    # in order, so that the generator's stream advances alike
    for i in list(range(len(jds))) + [0]:
        assert_items_equal(tds[i], jds[i])


@pytest.fixture(scope="module")
def dtu_forms_root(dtu_root, tmp_path_factory):
    """``dtu_root`` with its images written again as Adam7-interlaced PNGs
    (``write_png(interlace=True)``) and its masks as 16-bit greyscale
    (even views; 0 or 4096) and palette PNGs (odd views; indices 0 or
    255), both by PIL."""
    root = tmp_path_factory.mktemp("dtu_forms")
    shutil.copytree(dtu_root, root, dirs_exist_ok=True)
    for p in sorted(root.glob("Rectified_raw/scan24/*.png")):
        write_png(str(p), read_png(str(p)), interlace=True)
    for vid in range(5):
        p = root / f"Depths_raw/scan24/depth_visual_{vid:0>4}.png"
        m = read_png(str(p)) > 127
        if vid % 2:
            im = Image.fromarray(m.astype(np.uint8) * 255, "P")
            im.putpalette(bytes(range(256)) * 3)
            im.save(p)
        else:
            Image.fromarray(m.astype(np.uint16) * 4096).save(p)
    return str(root)


@pytest.mark.parametrize("mode", ["train", "val"])
def test_dtu_items_equal_jax_on_interlaced_images_and_other_masks(dtu_forms_root, mode):
    root = dtu_forms_root
    assert open(f"{root}/Rectified_raw/scan24/rect_001_3_r5000.png", "rb").read()[28] == 1
    assert [open(f"{root}/Depths_raw/scan24/depth_visual_{v:0>4}.png", "rb").read()[24:26]
            for v in (0, 1)] == [b"\x10\x00", b"\x08\x03"]
    jc, tc = confs(dtu_conf(root, mode))
    jds = JDTU(jc, mode, rng=np.random.RandomState(7))
    tds = TDTU(tc, mode, rng=np.random.RandomState(7))
    for i in list(range(len(jds))) + [0]:
        item = tds[i]
        assert_items_equal(item, jds[i])
    assert 0 < item["masks" if mode == "val" else "mask_ref"].mean() < 1


def test_get_dataset_passes_the_seeded_generator_as_get_loader_does(dtu_root):
    text = dtu_conf(dtu_root, "train").replace("d {", "d {\n dataset_name = DTUDataset", 1)
    jc, tc = confs(text)
    _, _, jds = j_get_loader(jc, "train", seed=3)
    tds = get_dataset(tc, "train", seed=3)
    for i in (4, 0, 4):
        assert_items_equal(tds[i], jds[i])
    other = get_dataset(tc, "train", seed=4)[0]
    assert not np.array_equal(other["pixels_x"], tds[0]["pixels_x"])


def finetune_conf(root, img_hw, ref_view):
    return f"""d {{
        data_dir = {root}
        scene = scan24
        ref_view = {ref_view}
        factor = 1.0
        interval_scale = 1.0
        num_interval = 192
        img_hw = [{img_hw[0]}, {img_hw[1]}]
        n_rays = 32
        val_res_level = 4
    }}"""


def check_finetune_surface(tds, jds):
    for k in ("all_views", "images", "masks", "intrs", "c2ws", "near_fars",
              "pseudo_depths", "pseudo_pts", "scale_mat", "scale_factor", "scene"):
        a, b = getattr(tds, k), getattr(jds, k)
        if isinstance(b, (str, list)):
            assert a == b, k
        else:
            a, b = np.asarray(a), np.asarray(b)
            assert a.dtype == b.dtype and a.shape == b.shape, k
            np.testing.assert_array_equal(a, b, err_msg=k)
    assert_items_equal(tds.get_all_images(), jds.get_all_images())
    rj, rt = np.random.RandomState(5), np.random.RandomState(5)
    for vid in (0, 2, 1):
        assert_items_equal(tds.get_random_rays(vid, rng=rt), jds.get_random_rays(vid, rng=rj))
        assert_items_equal(tds.get_rays_at(vid), jds.get_rays_at(vid))


@pytest.mark.parametrize("img_hw", [(H, W), (H * 3, W * 3)])
def test_dtu_finetune_equals_jax(dtu_root, img_hw):
    jc, tc = confs(finetune_conf(dtu_root, img_hw, 2))
    jds, tds = JFinetune(jc), TFinetune(tc)
    assert tds.all_views == [2, 0, 1]
    check_finetune_surface(tds, jds)


def test_dtu_finetune_neus_equals_jax(neus_root):
    jc, tc = confs(finetune_conf(neus_root, (H, W), 0))
    jds, tds = JNeuS(jc), TNeuS(tc)
    assert tds.masks.shape == (3, H, W) and tds.all_views == [0, 1, 2]
    check_finetune_surface(tds, jds)


def test_finetune_datasets_through_get_dataset(dtu_root, neus_root):
    for name, root, cls in (("DTUDatasetFinetune", dtu_root, TFinetune),
                            ("DTUDatasetFinetuneNeuS", neus_root, TNeuS)):
        text = finetune_conf(root, (H, W), 1).replace("d {", f"d {{\n dataset_name = {name}", 1)
        ds = get_dataset(TConfig.parse_string(text)["d"], "finetune", seed=0)
        assert type(ds) is cls and ds.images.shape == (3, H, W, 3)


# -- the JPEG datasets (GenericMVSDataset) ---------------------------------------

MVS = ["BMVSDataset", "TanksDataset", "ETH3DDataset"]
MVS_SCAN = {"BMVSDataset": "5a0271884e62597cdee0d0eb", "TanksDataset": "Family",
            "ETH3DDataset": "facade"}
# files at about 1/50 of the native size; the loader at a 1/25-ish img_hw
MVS_FILE_HW = {"BMVSDataset": (72, 96), "TanksDataset": (54, 96), "ETH3DDataset": (83, 124)}
MVS_IMG_HW = {"BMVSDataset": (48, 64), "TanksDataset": (36, 64), "ETH3DDataset": (24, 48)}
MVS_VIEWS = 4


@pytest.fixture(scope="module")
def mvs_roots(tmp_path_factory):
    """Each dataset's layout as tests/test_datasets.py:125-148 writes the
    BMVS one: PIL JPEGs of random pixels (quality 75, 4:2:0), cam files,
    pair.txt at the spec's path and, for BMVS, PFM depths (a quarter of
    them below the depth range, so the masks hold zeros)."""
    roots = {}
    for name in MVS:
        root = tmp_path_factory.mktemp(name)
        spec, scan = _SPECS[name], MVS_SCAN[name]

        def path(key, vid=0):
            q = root / spec[key].format(scan=scan, vid=vid)
            os.makedirs(q.parent, exist_ok=True)
            return q
        with open(path("pair_pattern"), "w") as f:
            f.write(f"{MVS_VIEWS}\n")
            for ref in range(MVS_VIEWS):
                srcs = [v for v in range(MVS_VIEWS) if v != ref]
                f.write(f"{ref}\n{len(srcs)} " +
                        " ".join(f"{s} {10 - i}" for i, s in enumerate(srcs)) + "\n")
        rng = np.random.RandomState(1)
        for vid in range(MVS_VIEWS):
            write_cam(path("cam_pattern", vid), vid)
            img = (rng.rand(*MVS_FILE_HW[name], 3) * 255).astype(np.uint8)
            Image.fromarray(img).save(path("img_pattern", vid))
            if spec["depth_pattern"] is not None:
                depth = rng.rand(*MVS_FILE_HW[name]).astype(np.float32) * 2 + 2.0
                write_pfm(str(path("depth_pattern", vid)), depth)
        roots[name] = str(root)
    return roots


@pytest.fixture(scope="module")
def mvs_scene_roots(tmp_path_factory):
    """The procedural scene in each layout (``write_mvs_scene``: the port's
    JPEG encoder, 4:2:0), at the file sizes above; under ``"progressive"``
    the same scenes with progressive JPEGs."""
    roots = {"progressive": {}}
    for name in MVS:
        roots["progressive"][name] = str(tmp_path_factory.mktemp(name + "_progressive"))
        roots[name] = write_mvs_scene(str(tmp_path_factory.mktemp(name + "_scene")), name,
                                      MVS_SCAN[name], list(range(MVS_VIEWS)),
                                      image_hw=MVS_FILE_HW[name],
                                      progressive_root=roots["progressive"][name])
    return roots


def mvs_conf(name, root, mode):
    h, w = MVS_IMG_HW[name]
    views = ("ref_view = [0, 1, 2, 3]\n n_rays = 64" if mode == "train"
             else "ref_view = [1, 2]\n val_res_level = 2")
    return f"""d {{
        dataset_name = {name}
        data_dir = {root}
        scene = [{MVS_SCAN[name]}]
        {views}
        num_src_view = 2
        factor = 0.8
        interval_scale = 1
        num_interval = 100
        img_hw = [{h}, {w}]
    }}"""


@pytest.mark.parametrize("layout", ["pil", "scene", "progressive"])
@pytest.mark.parametrize("mode", ["train", "val"])
@pytest.mark.parametrize("name", MVS)
def test_mvs_items_equal_jax(mvs_roots, mvs_scene_roots, name, mode, layout):
    root = {"pil": mvs_roots, "scene": mvs_scene_roots,
            "progressive": mvs_scene_roots["progressive"]}[layout][name]
    if layout == "progressive":
        img = os.path.join(root, _SPECS[name]["img_pattern"].format(scan=MVS_SCAN[name],
                                                                    vid=0))
        assert b"\xff\xc2" in open(img, "rb").read()
    jc, tc = confs(mvs_conf(name, root, mode))
    jds = JGeneric(jc, mode, name, rng=np.random.RandomState(7))
    tds = TGeneric(tc, mode, name, rng=np.random.RandomState(7))
    assert len(tds) == len(jds) == (4 if mode == "train" else 2)
    # in order, so that the generator's stream advances alike
    for i in list(range(len(jds))) + [0]:
        item = tds[i]
        assert_items_equal(item, jds[i])
        assert item["imgs"].shape == (3, *MVS_IMG_HW[name], 3)
    if name == "BMVSDataset" and layout == "pil":
        assert 0 < item["mask"].mean() < 1
    if name != "BMVSDataset":
        assert not item["depth_ref"].any() and item["mask"].all()


def test_mvs_src_views_override_pair_txt(mvs_roots):
    text = mvs_conf("ETH3DDataset", mvs_roots["ETH3DDataset"], "val").replace(
        "num_src_view = 2", "num_src_view = 2\n src_views = [3, 0]")
    jc, tc = confs(text)
    item = TGeneric(tc, "val", "ETH3DDataset")[0]
    assert item["view_ids"].tolist() == [1, 3, 0] and int(item["src_idx"]) == 1
    assert_items_equal(item, JGeneric(jc, "val", "ETH3DDataset")[0])


@pytest.mark.parametrize("name", MVS)
def test_mvs_get_dataset_equals_get_loader(mvs_roots, name):
    jc, tc = confs(mvs_conf(name, mvs_roots[name], "train"))
    _, _, jds = j_get_loader(jc, "train", seed=3)
    tds = get_dataset(tc, "train", seed=3)
    assert type(tds).__name__ == name
    for i in (2, 0, 2):
        assert_items_equal(tds[i], jds[i])
    assert not np.array_equal(get_dataset(tc, "train", seed=4)[2]["pixels_x"],
                              tds[2]["pixels_x"])


# the confs' native -> img_hw ratios (ETH3D's changes the aspect) and the
# scene writer's repeat of a 1036x1553 render up to ETH3D's native size
MVS_RESIZES = [((4141, 6212), (1200, 2400)), ((1080, 1920), (1080, 1920)),
               ((576, 768), (576, 768)), ((1036, 1553), (4141, 6212)),
               ((1200, 2400), (300, 600))]


@pytest.mark.parametrize("src,dst", MVS_RESIZES)
def test_resize_nearest_at_the_mvs_ratios(src, dst):
    rng = np.random.RandomState(8)
    # every row and column index, through 3-channel f32 strips
    for a in (rng.rand(src[0], 2, 3).astype(np.float32),
              rng.rand(2, src[1], 3).astype(np.float32)):
        dsize = (dst[1] if a.shape[1] > 2 else 2, dst[0] if a.shape[0] > 2 else 2)
        np.testing.assert_array_equal(resize_nearest(a, dsize),
                                      cv2.resize(a, dsize, interpolation=cv2.INTER_NEAREST))
    a = (rng.rand(*src) * 255).astype(np.uint8)
    ref = cv2.resize(a, dst[::-1], interpolation=cv2.INTER_NEAREST)
    got = resize_nearest(a, dst[::-1])
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
