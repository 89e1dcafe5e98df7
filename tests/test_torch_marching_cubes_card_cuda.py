"""Marching cubes on the card (csrc/marching_cubes_lattice.cu through
``geometry.marching_cubes``) against its plain version and the host C++
(tests marked ``cuda``; they skip without an NVIDIA GPU and import no
JAX: ``python -m pytest tests/test_torch_marching_cubes_card_cuda.py -m
cuda --noconftest``):

* the kernel's arrays equal the plain version's byte for byte on the
  card, and its mesh is the C++'s as tests/test_torch_marching_cubes_card.py
  holds the plain version's, on that file's lattices and on a 512^3
  lattice of 272 occupied 64^3 blocks (a DTU validate holds 238-269), one
  launch a mesh;
* the same lattice gives the same bytes twice;
* a validate launches the kernel once and no host marching cubes, and
  reports the cells it walked;
* surfbench's ``vertices_shifted`` fault moves the card path's vertices."""

import numpy as np
import pytest
import torch

from test_torch_marching_cubes_card import LATTICES, assert_cpp_mesh, lattice, mc, sdf, stages
from tiny_conf import TINY
from surf_tpu_torch import _build
from surf_tpu_torch.config import ConfigFactory
from surf_tpu_torch.geometry.extract import extract_geometry

DTU_SIZE = "sphere_512_of_272_blocks"


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from surf_tpu_torch.card import set_numerics
    set_numerics()
    return torch.device("cuda")


def dtu_size(dev):
    """A bumpy sphere's SDF (positive outside, as the SDF net's) over the
    512^3 lattice, held in the 272 blocks of 64^3 near its surface; the
    values made on the card."""
    R, B = 512, 64
    nb = R // B
    centre = (np.arange(nb) * B + B / 2 - 0.5) * 2 / (R - 1) - 1
    x, y, z = np.meshgrid(centre, centre, centre, indexing="ij")
    blocks = np.abs(np.sqrt(x ** 2 + y ** 2 + z ** 2) - 0.65) < 1.5 * B / (R - 1) * 3 ** 0.5
    at = torch.from_numpy(np.argwhere(blocks)).to(dev)
    p = [(-1.0 + 2.0 / (R - 1.0) * (at[:, a, None] * B + torch.arange(B, device=dev))).view(
        (-1,) + tuple(B if i == a else 1 for i in range(3))) for a in range(3)]
    u = (p[0] ** 2 + p[1] ** 2 + p[2] ** 2).sqrt() - 0.65 \
        + 0.02 * torch.sin(17 * p[0]) * torch.sin(13 * p[1]) * torch.sin(11 * p[2])
    return mc.BlockLattice(u.reshape(len(at), -1).contiguous(), blocks, R, B)


def card_lattice(name, dev):
    if name == DTU_SIZE:
        return dtu_size(dev)
    lat, _ = lattice(name)
    return mc.BlockLattice(lat.vals.to(dev), lat.blocks, lat.resolution, lat.block)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(LATTICES) + [DTU_SIZE])
def test_kernel_is_its_plain_version_and_the_cpp_mesh(card, name):
    lat = card_lattice(name, card)
    before = _build.launches["marching_cubes_lattice"]
    v, t = mc.marching_cubes(lat, 0.0)
    assert _build.launches["marching_cubes_lattice"] == before + 1
    cells = lat.cells
    vp, tp = (x.cpu().numpy() for x in mc.marching_cubes_plain(lat, 0.0))
    assert v.tobytes() == vp.tobytes() and t.tobytes() == tp.tobytes()
    assert cells == lat.cells
    assert_cpp_mesh(v, t, lat.dense().cpu().numpy())
    if name == DTU_SIZE:
        assert len(t) > 500_000 and lat.blocks.sum() == 272


@pytest.mark.cuda
def test_same_lattice_same_bytes_twice(card):
    lat = dtu_size(card)
    a = mc.marching_cubes(lat, 0.0)
    b = mc.marching_cubes(lat, 0.0)
    assert all(x.tobytes() == y.tobytes() for x, y in zip(a, b))


@pytest.mark.cuda
def test_validate_launches_the_kernel_once_and_no_host_marching_cubes(card, tmp_path,
                                                                     monkeypatch):
    from surf_tpu_torch.validate import Validator
    v = Validator(ConfigFactory.parse_string(TINY), device="cuda", mesh_resolution=96,
                  base_exp_dir=str(tmp_path))
    got, extract = {}, v.extract_geometry

    def kept(*a, **k):
        got["mesh"] = extract(*a, **k)
        return got["mesh"]
    v.extract_geometry = kept

    def no_host(*a, **k):
        raise AssertionError("the validate ran the host's marching cubes")
    monkeypatch.setattr(mc, "_get_lib", no_host)
    _build.reset_launches()
    (m,) = v.validate()
    assert _build.launches["marching_cubes_lattice"] == 1
    walked, crossing = m["mesh_cubes_cells"]
    assert walked > 0 and 0 < crossing <= walked
    monkeypatch.undo()
    verts, tris, u = got["mesh"]
    vc, tc = mc.marching_cubes(-u, 0.0)
    assert len(verts) == len(vc) > 0 and tris.shape == tc.shape
    ours = np.full(len(vc), -1)
    ours[tc.ravel()] = tris.ravel()
    assert np.array_equal(ours[tc], tris)


@pytest.mark.cuda
def test_vertices_shifted_fault_moves_the_card_vertices(card):
    from surfbench import faults
    R = 40
    verts, tris, _ = extract_geometry(sdf, stages(card), R, block=16)
    with faults.vertices_shifted():
        moved, tris_f, _ = extract_geometry(sdf, stages(card), R, block=16)
    assert len(tris) > 100 and np.array_equal(tris, tris_f)
    np.testing.assert_allclose(moved[:, 0] - verts[:, 0], 0.25 * 2.0 / (R - 1.0), atol=1e-6)
    assert np.array_equal(moved[:, 1:], verts[:, 1:])
