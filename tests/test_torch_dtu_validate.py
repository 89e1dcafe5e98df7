"""The port's validate on a DTU-layout scene (the procedural scene written
by ``surf_tpu_torch.data.dtu_scene`` at 96x128 and read by ``DTUDataset``
at 48x64), with the tiny model on the CPU:

* its artifacts are the JAX runner's: the arrays ``Validator.validate``
  hands ``write_artifacts`` are written again by the lines of
  ``Runner.validate`` (surf_tpu/runner.py:653-676: PIL for colour and
  normal, the runner's ``save_depth_png`` and ``np.save`` for each
  depth), and both directories hold the same files, decoded pixel for
  pixel and loaded bit for bit;
* ``--clean_mesh`` through the CLI keeps the faces the JAX package's
  ``clean_mesh`` keeps of the same raw mesh (the same faces and
  vertices, before the move to the scene's frame), and is off by
  default."""

import os
import re

import numpy as np
import pytest
import torch
from PIL import Image

from surf_tpu.geometry.clean_mesh import clean_mesh as j_clean_mesh
from surf_tpu.geometry.mesh import Mesh as JMesh
from surf_tpu.runner import save_depth_png as j_save_depth_png

from tiny_conf import TINY
from surf_tpu_torch import main, validate
from surf_tpu_torch.config import ConfigFactory
from surf_tpu_torch.data.dtu_scene import write_dtu_scene
from surf_tpu_torch.io import read_png

# one intra-op thread: the suite's xdist workers share the host's cores,
# and a thread a core in every worker oversubscribes them many times over
torch.set_num_threads(1)

DTU_VAL = """val_dataset {{
    dataset_name = DTUDataset
    data_dir = {root}
    scene = [scan24]
    ref_view = [0]
    light_idx = [3]
    num_src_view = 2
    val_res_level = 4
    factor = 1.0
    interval_scale = 1
    num_interval = 192
    img_hw = [48, 64]
}}
"""


@pytest.fixture(scope="module")
def conf_path(tmp_path_factory):
    d = tmp_path_factory.mktemp("dtu_val")
    root = write_dtu_scene(str(d / "scene"), image_hw=(96, 128))
    text = re.sub(r"val_dataset \{[^}]*\}\n", DTU_VAL.format(root=root), TINY, count=1)
    assert "DTUDataset" in text
    path = d / "tiny_dtu.conf"
    path.write_text(text)
    return str(path)


def runner_artifacts(d, file_name, epoch, color, normal, sdf_depth, render_depth,
                     auxi=None):
    """Runner.validate's lines (surf_tpu/runner.py:653-676) on given arrays."""
    for sub in ["val_img", "val_normal", "val_sdf_depth", "val_render_depth",
                "val_auxi_depth"]:
        os.makedirs(os.path.join(d, sub), exist_ok=True)
    img_fine = (color * 256).clip(0, 255).astype(np.uint8)
    normal_img = (normal * 128 + 128).clip(0, 255).astype(np.uint8)
    Image.fromarray(img_fine).save(os.path.join(d, "val_img", f"{file_name}_epoch{epoch}.png"))
    Image.fromarray(normal_img).save(os.path.join(
        d, "val_normal", f"{file_name}_epoch{epoch}.png"))
    j_save_depth_png(render_depth, os.path.join(
        d, "val_render_depth", f"{file_name}_epoch{epoch}.png"))
    j_save_depth_png(sdf_depth, os.path.join(d, "val_sdf_depth", f"{file_name}_epoch{epoch}.png"))
    np.save(os.path.join(d, "val_render_depth", f"{file_name}_epoch{epoch}.npy"), render_depth)
    np.save(os.path.join(d, "val_sdf_depth", f"{file_name}_epoch{epoch}.npy"), sdf_depth)
    if auxi is not None:
        j_save_depth_png(auxi, os.path.join(d, "val_auxi_depth", f"{file_name}_epoch{epoch}.png"))
        np.save(os.path.join(d, "val_auxi_depth", f"{file_name}_epoch{epoch}.npy"), auxi)


def test_validate_writes_the_runners_artifacts(conf_path, tmp_path, monkeypatch):
    calls, write = [], validate.write_artifacts

    def recorded(*args):
        calls.append(args)
        return write(*args)
    monkeypatch.setattr(validate, "write_artifacts", recorded)
    out = tmp_path / "port"
    v = validate.Validator(ConfigFactory.parse_file(conf_path), device="cpu",
                           mesh_resolution=24, base_exp_dir=str(out))
    (m,) = v.validate(3)
    assert m["scene"] == "scan24" and m["finite"] and len(calls) == 1
    _, file_name, epoch, color, normal, sdf, render, auxi = calls[0]
    assert file_name == "scan24_view0_light3" and epoch == 3
    assert color.shape == (12, 16, 3) and auxi is not None and auxi.shape == (48, 64)
    ref = tmp_path / "runner"
    runner_artifacts(str(ref), file_name, epoch, color, normal, sdf, render, auxi)
    for sub in ("val_img", "val_normal", "val_render_depth", "val_sdf_depth",
                "val_auxi_depth"):
        names = sorted(p.name for p in (ref / sub).iterdir())
        assert names and sorted(p.name for p in (out / sub).iterdir()) == names, sub
        for n in names:
            a, b = out / sub / n, ref / sub / n
            if n.endswith(".npy"):
                x, y = np.load(a), np.load(b)
                assert x.dtype == y.dtype
                np.testing.assert_array_equal(x, y)
            else:
                np.testing.assert_array_equal(read_png(str(a)), np.array(Image.open(b)))
                np.testing.assert_array_equal(np.array(Image.open(a)), np.array(Image.open(b)))


def test_clean_mesh_through_the_cli(conf_path, tmp_path, monkeypatch):
    seen, clean = [], validate.clean_mesh

    def recorded(mesh, masks, intrs, c2ws):
        raw = (mesh.vertices.copy(), mesh.faces.copy())
        out = clean(mesh, masks, intrs, c2ws)
        seen.append((raw, masks, intrs, c2ws, out.vertices.copy(), out.faces.copy()))
        return out
    monkeypatch.setattr(validate, "clean_mesh", recorded)
    args = ["--conf", conf_path, "--mode", "val", "--device", "cpu",
            "--mesh_resolution", "48"]
    (plain,) = main.main(args + ["--out", str(tmp_path / "a")])
    assert not seen and "clean_mesh_s" not in plain
    (m,) = main.main(args + ["--out", str(tmp_path / "b"), "--clean_mesh"])
    assert len(seen) == 1
    (v, f), masks, intrs, c2ws, v_t, f_t = seen[0]
    assert masks.shape == (3, 48, 64)
    assert m["mesh_faces_before_clean"] == plain["mesh_faces"] == len(f)
    assert 0 < m["mesh_faces"] == len(f_t) < len(f) and m["clean_mesh_s"] > 0
    ref = j_clean_mesh(JMesh(v, f), masks, intrs, c2ws)
    np.testing.assert_array_equal(f_t, ref.faces)
    np.testing.assert_array_equal(v_t, ref.vertices)
