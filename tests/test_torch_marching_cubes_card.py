"""Marching cubes over the block lattice (``geometry.marching_cubes``) on
the CPU: the plain version of the card's kernel (csrc/marching_cubes_lattice.cu;
the kernel is held to it byte for byte by
tests/test_torch_marching_cubes_card_cuda.py) against the host C++
(csrc/marching_cubes.cpp) over the same lattice as an array:

* the same lattice edges hold vertices, in edge-key order, each on its
  edge, within 2 ulps of the C++'s vertex (the C++ interpolates some edges
  from their upper corner);
* the same triangles, in the same order, once the C++'s vertex indices are
  mapped to the plain version's;
* the blocks walked hold every cell with a crossing, and the counts of
  cells walked and with a crossing;
* on random sign fields, a sphere with whole blocks pinned at +100 and
  blocks at the lattice's edge, R not a multiple of B, a block over 64
  points a side, exact zeros and equal corners on an edge, an empty
  lattice, an all-inside one and one all outside but for its pinned
  blocks;
* ``extract_geometry`` on the CPU keeps its contract and meshes with the
  C++; a lattice on another device raises and falls back to nothing."""

import importlib

import numpy as np
import pytest
import torch

from surf_tpu_torch.geometry import extract
from surf_tpu_torch.geometry.extract import extract_geometry
from surf_tpu_torch.ops import sparse as sp

# the module (the package exports its function under the same name)
mc = importlib.import_module("surf_tpu_torch.geometry.marching_cubes")

torch.set_num_threads(1)


def fill(vals, blocks, R, B):
    """The lattice array as ``extract_geometry`` fills it."""
    u = np.full((R, R, R), 100.0, np.float32)
    for (bx, by, bz), v in zip(np.argwhere(blocks), vals.numpy().reshape(-1, B, B, B)):
        sx = slice(bx * B, min((bx + 1) * B, R))
        sy = slice(by * B, min((by + 1) * B, R))
        sz = slice(bz * B, min((bz + 1) * B, R))
        u[sx, sy, sz] = v[:sx.stop - sx.start, :sy.stop - sy.start, :sz.stop - sz.start]
    return u


def sphere(R, B, center, radius, band):
    """u = radius - |x - center| over [-1, 1]^3 (inside the sphere where
    -u < 0), kept in the blocks whose points come within ``band`` of the
    surface; the other blocks pinned at +100."""
    nb = -(-R // B)
    ax = -1.0 + 2.0 / (R - 1.0) * np.arange(nb * B)
    x, y, z = np.meshgrid(ax, ax, ax, indexing="ij")
    d = np.sqrt((x - center[0]) ** 2 + (y - center[1]) ** 2 + (z - center[2]) ** 2)
    u = (radius - d).astype(np.float32).reshape(nb, B, nb, B, nb, B).transpose(0, 2, 4, 1, 3, 5)
    blocks = (np.abs(u) < band).any(axis=(3, 4, 5))
    return u[blocks].reshape(-1, B ** 3), blocks


def random(R, B, p, seed, draw):
    rng = np.random.RandomState(seed)
    nb = -(-R // B)
    blocks = rng.rand(nb, nb, nb) < p
    return draw(rng, (int(blocks.sum()), B ** 3)), blocks


def normal(rng, shape):
    return rng.randn(*shape)


def levels(rng, shape):
    """Exact zeros (of both signs) and runs of equal values."""
    return rng.choice([-1.0, 0.0, -0.0, 0.5, 0.5, 0.5], size=shape)


LATTICES = {
    "random_signs": lambda: (20, 8, *random(20, 8, 0.5, 0, normal)),
    "random_signs_R_not_a_multiple": lambda: (30, 7, *random(30, 7, 0.5, 1, normal)),
    "sphere_pinned_blocks_at_the_edge": lambda: (37, 8, *sphere(37, 8, (0.7, 0.65, -0.75),
                                                               0.6, 0.15)),
    "sphere_block_over_64": lambda: (75, 70, *sphere(75, 70, (0.1, -0.2, 0.3), 0.7, 2.0)),
    "zeros_and_equal_corners": lambda: (20, 8, *random(20, 8, 0.6, 2, levels)),
    "empty": lambda: (20, 8, np.zeros((0, 512)), np.zeros((3, 3, 3), bool)),
    "all_inside": lambda: (20, 8, *random(20, 8, 0.6, 3, lambda r, s: np.abs(r.randn(*s))
                                          + 0.1)),
    "outside_but_pinned": lambda: (20, 8, *random(20, 8, 1.0, 4, lambda r, s: -np.abs(
        r.randn(*s)) - 0.1)),
}


def lattice(name):
    R, B, vals, blocks = LATTICES[name]()
    vals = torch.from_numpy(np.ascontiguousarray(vals, np.float32))
    return mc.BlockLattice(vals, blocks, R, B), fill(vals, blocks, R, B)


def crossing_keys(u):
    """Every lattice edge whose corners differ (-u < 0 on one side only),
    keyed (lower corner's linear index) * 3 + axis, sorted."""
    R = u.shape[0]
    inside = -u < 0
    keys = []
    for a in range(3):
        lo = [slice(None)] * 3
        hi = [slice(None)] * 3
        lo[a], hi[a] = slice(0, R - 1), slice(1, R)
        at = np.argwhere(inside[tuple(lo)] != inside[tuple(hi)])
        keys.append(((at[:, 0] * R + at[:, 1]) * R + at[:, 2]) * 3 + a)
    return np.sort(np.concatenate(keys))


def patterns(u):
    """Each cell's corner pattern (Bourke's order), (R-1)^3."""
    inside = (-u < 0).astype(np.int64)
    n = u.shape[0] - 1
    return sum(inside[dx:dx + n, dy:dy + n, dz:dz + n] << bit
               for bit, (dx, dy, dz) in enumerate(mc.CORNERS))


def assert_cpp_mesh(v, t, u):
    """(v, t), the plain version's or the kernel's mesh of the lattice
    array u, against the C++'s mesh of it."""
    R = u.shape[0]
    vc, tc = mc.marching_cubes(-u, 0.0)
    assert v.dtype == np.float32 and t.dtype == np.int64 and v.shape[1:] == t.shape[1:] == (3,)
    # the vertices, in key order, each on its edge
    keys = crossing_keys(u)
    assert len(v) == len(vc) == len(keys)
    low = np.stack([keys // 3 // (R * R), keys // 3 // R % R, keys // 3 % R], 1)
    axis = keys % 3
    on = v - low
    rows = np.arange(len(v))
    assert (on[rows, axis] >= 0).all() and (on[rows, axis] <= 1).all()
    on[rows, axis] = 0
    assert (on == 0).all()
    # the triangles, once the C++'s vertices are numbered as the plain version's
    assert t.shape == tc.shape
    ours = np.full(len(vc), -1)
    ours[tc.ravel()] = t.ravel()
    assert (ours >= 0).all() and len(np.unique(ours)) == len(vc)
    assert np.array_equal(ours[tc], t)
    # the C++'s positions within 2 ulps of the coordinate
    upper = (low + (np.arange(3) == axis[:, None])).astype(np.float32)
    assert (np.abs(vc - v[ours]) <= 2 * np.spacing(upper[ours])).all()


@pytest.mark.parametrize("name", sorted(LATTICES))
def test_plain_version_is_the_cpp_mesh_in_edge_key_order(name):
    lat, u = lattice(name)
    assert np.array_equal(lat.dense().numpy(), u)
    v, t = mc.marching_cubes(lat, 0.0)
    assert_cpp_mesh(v, t, u)
    if name not in ("empty", "all_inside", "outside_but_pinned"):
        assert len(t) > 100


@pytest.mark.parametrize("name", sorted(LATTICES))
def test_walk_holds_every_crossing_and_counts_cells(name):
    lat, u = lattice(name)
    R, B = lat.resolution, lat.block
    pat = patterns(u)
    crossing = np.argwhere((pat != 0) & (pat != 255))
    walked = {tuple(b) for b in lat.walked.tolist()}
    assert {tuple(c) for c in (crossing // B).tolist()} <= walked
    mc.lattice_mesh(lat, 0.0)
    cells = sum(int(np.prod([min(b * B + B, R - 1) - b * B for b in blk]))
                for blk in lat.walked.tolist())
    assert lat.cells == [cells, len(crossing)]


def test_block_lattice_refuses_values_that_do_not_fit():
    blocks = np.zeros((3, 3, 3), bool)
    blocks[1, 1, 1] = True
    with pytest.raises(ValueError, match="BlockLattice"):
        mc.BlockLattice(torch.zeros((2, 512)), blocks, 20, 8)
    with pytest.raises(ValueError, match="BlockLattice"):
        mc.BlockLattice(torch.zeros((1, 512), dtype=torch.float64), blocks, 20, 8)


def test_lattice_on_another_device_raises_and_meshes_nothing():
    lat, _ = lattice("random_signs")
    meta = mc.BlockLattice(lat.vals.to("meta"), lat.blocks, lat.resolution, lat.block)
    with pytest.raises(ValueError, match="marching_cubes_lattice"):
        mc.marching_cubes(meta, 0.0)
    assert meta.cells is None


def stages(device="cpu", seed=0):
    """One random sparse stage over the low quarter of the box."""
    rng = np.random.RandomState(seed)
    coords = np.stack(np.meshgrid(*[np.arange(4)] * 3, indexing="ij"), -1).reshape(-1, 3)
    keep = coords[rng.rand(len(coords)) < 0.6]
    grid = sp.make_grid(torch.from_numpy(keep).to(device),
                        torch.ones(len(keep), dtype=torch.bool, device=device),
                        torch.from_numpy(rng.rand(len(keep) * 8) < 0.8).to(device), 16)
    return [(grid, torch.zeros((len(keep) * 8, 1), device=device))]


def sdf(pts):
    return 0.45 - (pts + 0.4).norm(dim=1)


def test_extract_geometry_on_the_cpu_meshes_the_array_with_the_cpp(monkeypatch):
    def no_card_path(*a, **k):
        raise AssertionError("a host lattice went to the card's marching cubes")
    monkeypatch.setattr(mc, "lattice_mesh", no_card_path)
    R = 26
    stats = {}
    verts, tris, u = extract_geometry(sdf, stages(), R, block=8, stats=stats)
    assert isinstance(verts, np.ndarray) and verts.dtype == np.float32 and verts.shape[1:] == (3,)
    assert isinstance(tris, np.ndarray) and tris.dtype == np.int64 and tris.shape[1:] == (3,)
    assert isinstance(u, np.ndarray) and u.dtype == np.float32 and u.shape == (R, R, R)
    assert len(tris) > 100 and np.abs(verts).max() <= 1.0
    v, t = extract.marching_cubes(-u, 0.0)
    assert np.array_equal(verts, v / (R - 1.0) * 2.0 - 1.0) and np.array_equal(tris, t)
    assert "mesh_cubes_cells" not in stats
    assert set(stats) >= {"mesh_lattice_s", "mesh_fill_s", "mesh_cubes_s", "lattice_points",
                          "lattice_blocks"}
