"""Marching cubes, by where the lattice's values lie.

* A host array goes to the package's own copy of the C++ extension
  (csrc/marching_cubes.cpp), built lazily with g++ into the package's
  build directory and loaded through ctypes.
* A ``BlockLattice`` on the card (the mesh lattice's occupied blocks as the
  SDF kernel K5 leaves them there, with their block map) goes to the
  hand-written kernel of csrc/marching_cubes_lattice.cu: a count pass, a
  prefix sum over its tiles and an emit pass, so that only the mesh comes
  back to the host.  It makes the C++'s mesh up to a renumbering of its
  vertices (edge-key order; triangles in the C++'s cell and table order)
  and a vertex's last bit (each edge interpolated from its lower corner).
  A ``BlockLattice`` on the CPU takes the kernel's plain version,
  ``marching_cubes_plain``, which gives its arrays.
"""

from __future__ import annotations

import ctypes
import functools
import itertools
import os
import re

import numpy as np
import torch

from .. import _build
from .._build import NATIVE_FLOAT, host_lib
from ..parallel.ray_shard import to_host


def _get_lib():
    lib = host_lib("marching_cubes", "marching_cubes.cpp", NATIVE_FLOAT)
    if not getattr(lib, "_surf_typed", False):
        lib.mc_run.restype = ctypes.c_int
        lib.mc_run.argtypes = [
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_float,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_int64)),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ]
        lib.mc_free.restype = None
        lib.mc_free.argtypes = [ctypes.c_void_p]
        lib._surf_typed = True
    return lib


def marching_cubes(grid, iso=0.0):
    """grid: an (nx, ny, nz) float array (corners inside where grid < iso),
    or a ``BlockLattice`` of u (inside where -u < iso).  Returns (vertices
    (v, 3) float32 in grid-index coordinates, triangles (t, 3) int64) as
    host arrays."""
    if isinstance(grid, BlockLattice):
        v, t = lattice_mesh(grid, iso)
        return to_host(v).numpy(), to_host(t).numpy()
    lib = _get_lib()
    g = np.ascontiguousarray(grid, dtype=np.float32)
    nx, ny, nz = g.shape
    verts_p = ctypes.POINTER(ctypes.c_float)()
    tris_p = ctypes.POINTER(ctypes.c_int64)()
    nv = ctypes.c_int64()
    nt = ctypes.c_int64()
    rc = lib.mc_run(g.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                    nx, ny, nz, ctypes.c_float(iso),
                    ctypes.byref(verts_p), ctypes.byref(tris_p),
                    ctypes.byref(nv), ctypes.byref(nt))
    if rc != 0:
        raise MemoryError("marching cubes allocation failed")
    try:
        v = np.ctypeslib.as_array(verts_p, shape=(nv.value, 3)).copy() \
            if nv.value else np.zeros((0, 3), np.float32)
        t = np.ctypeslib.as_array(tris_p, shape=(nt.value, 3)).copy() \
            if nt.value else np.zeros((0, 3), np.int64)
    finally:
        lib.mc_free(verts_p)
        lib.mc_free(tris_p)
    return v, t


# ---------------------------------------------------------------------------
# the block lattice, and marching cubes over it on the card
# ---------------------------------------------------------------------------

MC_TILE = 64            # points of the kernel's tile: one z-run of a block row


class BlockLattice:
    """An R^3 lattice of u held as its occupied B^3 blocks: ``vals`` (k,
    B^3) f32, row i the i-th true block of ``blocks`` (nb^3 host bool, C
    order), a block's point (lx, ly, lz) at (lx B + ly) B + lz (a block
    past R holds its points past R too; they are never read); every point
    of any other block is +100.  Builds on ``vals``' device the block map
    (nb^3 int32: a block's row, or -1) and the blocks a mesh walks: those
    with an occupied block among themselves and their seven neighbours
    towards +x, +y, +z (a cell's corners lie in those eight; in any other
    block every cell's corners are +100).  ``cells``, after a mesh: [cells
    walked, cells with a crossing]."""

    def __init__(self, vals, blocks, resolution, block):
        R, B = int(resolution), int(block)
        occ = np.asarray(blocks, bool)
        nb = -(-R // B)
        k = int(occ.sum())
        if occ.shape != (nb,) * 3 or vals.shape != (k, B ** 3) or \
                vals.dtype != torch.float32 or not vals.is_contiguous():
            raise ValueError(f"BlockLattice: {tuple(vals.shape)} {vals.dtype} values for "
                             f"{k} of {occ.shape} blocks, not contiguous f32 ({k}, {B ** 3})")
        bmap = np.full(occ.shape, -1, np.int32)
        bmap[occ] = np.arange(k, dtype=np.int32)
        pad = np.pad(occ, [(0, 1)] * 3)
        walk = np.zeros_like(occ)
        for dx, dy, dz in itertools.product((0, 1), repeat=3):
            walk |= pad[dx:dx + nb, dy:dy + nb, dz:dz + nb]
        walked = np.ascontiguousarray(np.argwhere(walk), dtype=np.int32)
        lo = walked.astype(np.int64) * B
        self.walked_cells = int(np.prod(np.clip(np.minimum(lo + B, R - 1) - lo, 0, None),
                                        axis=1).sum())
        self.vals, self.blocks, self.resolution, self.block = vals, occ, R, B
        self.block_map = torch.from_numpy(bmap).to(vals.device)
        self.walked = torch.from_numpy(walked).to(vals.device)
        self.tiles = R * R * nb * -(-B // MC_TILE)
        self.cells = None

    def dense(self):
        """The (R, R, R) lattice of u."""
        R, B, nb = self.resolution, self.block, self.blocks.shape[0]
        full = torch.full((nb * B,) * 3, 100.0, dtype=torch.float32, device=self.vals.device)
        at = torch.from_numpy(np.argwhere(self.blocks)).to(self.vals.device)
        full.view(nb, B, nb, B, nb, B).permute(0, 2, 4, 1, 3, 5)[at[:, 0], at[:, 1], at[:, 2]] = \
            self.vals.view(-1, B, B, B)
        return full[:R, :R, :R]


@functools.cache
def _mc_tables():
    """csrc/marching_cubes.cpp's edgeTable and triTable (the kernel's copies)
    as int64 tensors, read from the source."""
    with open(os.path.join(_build.CSRC, "marching_cubes.cpp")) as f:
        src = f.read()
    edges = src[src.index("edgeTable[256] = {") + 18:]
    edges = [int(x, 16) for x in edges[:edges.index("}")].replace("\n", "").split(",")]
    rows = re.findall(r"\{([-0-9,]+)\}", src[src.index("triTable[256][16] = {"):])
    tri = [[int(x) for x in r.split(",")] for r in rows]
    return torch.tensor(edges), torch.tensor(tri)


# Bourke's corner order, and each edge's lower corner and axis
CORNERS = ((0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0),
           (0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1))
EDGE_LOW = ((0, 0, 0), (1, 0, 0), (0, 1, 0), (0, 0, 0), (0, 0, 1), (1, 0, 1),
            (0, 1, 1), (0, 0, 1), (0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0))
EDGE_AXIS = (0, 1, 0, 1, 0, 1, 0, 1, 2, 2, 2, 2)


def crossing_plain(iso, lo, glo, ghi):
    """The kernel's ``crossing``: the coordinate of the iso crossing on an
    edge from ``lo`` (value ``glo``) to ``lo + 1`` (``ghi``), f32 tensors,
    with the C++'s 1e-12 guards."""
    eps = torch.tensor(1e-12, dtype=torch.float32)
    mu = (iso - glo) / (ghi - glo)
    return torch.where((iso - glo).abs() < eps, lo,
                       torch.where((iso - ghi).abs() < eps, lo + 1.0,
                                   torch.where((glo - ghi).abs() < eps, lo, lo + mu)))


def marching_cubes_plain(lat, iso=0.0):
    """Plain version of the kernel: the same mesh, the same arrays, on the
    lattice's device.  Vertices (v, 3) f32 in edge-key order (lower
    corner's linear index * 3 + axis), triangles (t, 3) int64 in cell
    order and then table order.  Sets ``lat.cells``."""
    dev, R = lat.vals.device, lat.resolution
    g = -lat.dense()
    inside = g < iso
    keys, pos = [], []
    for a in range(3):
        lo = [slice(None)] * 3
        hi = [slice(None)] * 3
        lo[a], hi[a] = slice(0, R - 1), slice(1, R)
        lo, hi = tuple(lo), tuple(hi)
        cross = inside[lo] != inside[hi]
        at = cross.nonzero()
        p = at.float()
        p[:, a] = crossing_plain(iso, p[:, a], g[lo][cross], g[hi][cross])
        keys.append(((at[:, 0] * R + at[:, 1]) * R + at[:, 2]) * 3 + a)
        pos.append(p)
    keys = torch.cat(keys)
    order = torch.argsort(keys)
    keys, verts = keys[order], torch.cat(pos)[order]
    n = max(R - 1, 0)
    pattern = torch.zeros((n, n, n), dtype=torch.int32, device=dev)
    for bit, (dx, dy, dz) in enumerate(CORNERS):
        pattern |= inside[dx:dx + n, dy:dy + n, dz:dz + n].int() << bit
    edge_t, tri_t = (x.to(dev) for x in _mc_tables())
    lat.cells = [lat.walked_cells, int((edge_t[pattern] != 0).sum())]
    count = (tri_t >= 0).sum(1)[pattern]
    cells = count.nonzero()
    rows = tri_t[pattern[count > 0]]
    edges = rows[rows >= 0]
    low = cells.repeat_interleave(count[count > 0], dim=0) + \
        torch.tensor(EDGE_LOW, device=dev)[edges]
    ekeys = ((low[:, 0] * R + low[:, 1]) * R + low[:, 2]) * 3 + \
        torch.tensor(EDGE_AXIS, device=dev)[edges]
    tris = torch.searchsorted(keys, ekeys).reshape(-1, 3)
    return verts, tris


def _lattice_ptrs(lat):
    return (lat.vals.data_ptr(), lat.block_map.data_ptr(), lat.walked.data_ptr(),
            len(lat.walked), lat.resolution, lat.block)


_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_LATTICE_ARGS = [_P, _P, _P, _L, _I, _I, _F]


def lattice_counts(lat, iso=0.0):
    """The kernel's count pass: (cnt (3, T) int32, each tile's vertices,
    triangles and cells with a crossing; masks (T, 3) int64, its crossing
    edges by axis), T = ``lat.tiles``."""
    dev = lat.vals.device
    cnt = torch.zeros((3, lat.tiles), dtype=torch.int32, device=dev)
    masks = torch.empty((lat.tiles, 3), dtype=torch.int64, device=dev)
    with _build.on_device(lat.vals):
        fn = _build.kernel_fn("marching_cubes_lattice", "mc_lattice_count",
                              _LATTICE_ARGS + [_P, _P, _P])
        rc = fn(*_lattice_ptrs(lat), iso, cnt.data_ptr(), masks.data_ptr(),
                _build.stream_of(lat.vals))
    _build.check(rc, "marching_cubes_lattice count")
    return cnt, masks


def lattice_emit(lat, iso, cnt, masks, incl, nv, nt):
    """The kernel's emit pass: verts (nv, 3) f32 and tris (nt, 3) int64,
    from the count pass's ``cnt`` and ``masks`` and ``incl``, the
    inclusive prefix sums (2, T) int64 of cnt's first two rows."""
    dev = lat.vals.device
    verts = torch.empty((nv, 3), dtype=torch.float32, device=dev)
    tris = torch.empty((nt, 3), dtype=torch.int64, device=dev)
    with _build.on_device(lat.vals):
        fn = _build.kernel_fn("marching_cubes_lattice", "mc_lattice_emit",
                              _LATTICE_ARGS + [_P, _P, _P, _P, _P, _P])
        rc = fn(*_lattice_ptrs(lat), iso, cnt.data_ptr(), masks.data_ptr(),
                incl.data_ptr(), verts.data_ptr(), tris.data_ptr(),
                _build.stream_of(lat.vals))
    _build.check(rc, "marching_cubes_lattice emit")
    return verts, tris


def lattice_mesh(lat, iso=0.0):
    """Marching cubes over ``lat``: (verts (v, 3) f32 in lattice units,
    tris (t, 3) int64) on its device.  CPU tensors take the plain version;
    CUDA tensors launch the kernel (one launch counted a mesh: its count
    and emit passes), with one synchronise, to read the totals; anything
    else raises.  Sets ``lat.cells``."""
    if lat.vals.device.type == "cpu":
        return marching_cubes_plain(lat, iso)
    _build.require_cuda("marching_cubes_lattice", lat.vals, lat.block_map, lat.walked)
    cnt, masks = lattice_counts(lat, iso)
    incl = torch.cumsum(cnt[:2], dim=1, dtype=torch.int64)
    nv, nt, crossing = torch.cat((incl[:, -1], cnt[2].sum().view(1))).tolist()
    verts, tris = lattice_emit(lat, iso, cnt, masks, incl, nv, nt)
    _build.launches["marching_cubes_lattice"] += 1
    lat.cells = [lat.walked_cells, crossing]
    return verts, tris
