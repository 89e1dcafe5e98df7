"""Port parity of the host-side copies (numpy only): the HOCON parser,
PLY I/O, the mesh container and the marching cubes extension (built into
the port's own build directory) against their surf_tpu originals.  These
are copies, so the results must be identical."""

import glob
import os

import numpy as np
import pytest

from surf_tpu.config import ConfigFactory as JConf
from surf_tpu.geometry.marching_cubes import marching_cubes as j_mc
from surf_tpu.geometry.mesh import Mesh as JMesh
from surf_tpu_torch import _build
from surf_tpu_torch.config import ConfigFactory as TConf
from surf_tpu_torch.geometry.marching_cubes import marching_cubes as t_mc
from surf_tpu_torch.geometry.mesh import Mesh as TMesh
from surf_tpu_torch.io import read_ply

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(ROOT, "confs", "*.conf"))))
def test_hocon_copy_parses_every_conf_the_same(path):
    assert TConf.parse_file(path) == JConf.parse_file(path)


def test_marching_cubes_copy_and_mesh_export(tmp_path):
    R = 20
    ax = np.linspace(-1, 1, R, dtype=np.float32)
    x, y, z = np.meshgrid(ax, ax, ax, indexing="ij")
    u = np.sqrt(x ** 2 + y ** 2 + z ** 2) - 0.6
    vt, tt = t_mc(-u, 0.0)
    vj, tj = j_mc(-u, 0.0)
    assert len(tt) > 100
    np.testing.assert_array_equal(vt, vj)
    np.testing.assert_array_equal(tt, tj)
    assert os.path.exists(os.path.join(_build.BUILD_DIR, "libmarching_cubes.so"))
    T = np.diag([2.0, 2.0, 2.0, 1.0])
    T[:3, 3] = [0.1, -0.2, 0.3]
    mt, mj = TMesh(vt, tt).apply_transform(T), JMesh(vj, tj).apply_transform(T)
    mt.export(str(tmp_path / "t.ply"))
    mj.export(str(tmp_path / "j.ply"))
    assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()
    d = read_ply(str(tmp_path / "t.ply"))
    np.testing.assert_allclose(d["vertices"], mt.vertices.astype(np.float32))
