"""SDF lattice evaluation on the card -> marching cubes, with exact block
skipping (torch counterpart of surf_tpu/geometry/extract.py).

Blocks of the lattice that no stage's active voxel touches evaluate to the
pinned empty-space SDF (+100) everywhere (ops/sparse.occupied_blocks_host),
so they are skipped exactly.  Occupied blocks are evaluated
``blocks_per_call`` at a time, their lattice points generated on the
device from the block origins; one host copy at the end, for the lattice
array.  Who evaluates which blocks is the caller's: ``map_rows(fn, n)``
maps the rows [0, n) of the occupied-block list through ``fn`` and
returns them where they were gathered (the validate's ray-sharded form
splits the rows across a node's ranks and gathers them once on its first
rank; the JAX package shards each call's points instead: the same values,
one collective in place of one a call).  Values on the card are meshed
there, from the blocks as they lie (``BlockLattice``, the kernel of
csrc/marching_cubes_lattice.cu); values on the host by the C++ over the
lattice array.
"""

from __future__ import annotations

import numpy as np
import torch

from .marching_cubes import BlockLattice, marching_cubes
from ..ops.sparse import occupied_blocks_host
from ..parallel.ray_shard import to_host
from ..utils.spans import span


@torch.no_grad()
def extract_geometry(sdf_fn, stages, resolution, block=64, blocks_per_call=8,
                     map_rows=None, mesh=True, stats=None):
    """sdf_fn(pts (m, 3)) -> (m,) SDF.  Returns (verts in [-1,1], tris, u),
    host arrays.  ``map_rows(fn, n)``: ``fn`` on the rows [0, n), where
    they were gathered (default ``fn(arange(n))``); ``mesh`` false: only
    evaluate (the rows' values go elsewhere) and return None.  ``stats``, a
    dict, gets the seconds of the spans ``mesh.lattice`` (the occupied
    blocks, their SDF on the card and its host copy), ``mesh.fill`` (the
    lattice array) and ``mesh.cubes`` (marching cubes, on the card where
    the values lie there, and the vertices' rescale) as ``mesh_lattice_s``,
    ``mesh_fill_s`` and ``mesh_cubes_s``, and the counts ``lattice_points``
    (occupied blocks x B^3, the points evaluated), ``lattice_blocks``
    ([occupied, all] blocks) and, where the card meshed,
    ``mesh_cubes_cells`` ([cells it walked, cells with a crossing])."""
    # a block no larger than the lattice (the skipping is exact either way)
    R, G = int(resolution), int(blocks_per_call)
    B = min(int(block), R)
    dev = stages[0][1].device
    stats = {} if stats is None else stats

    def eval_blocks(rows):
        """(k,) rows of ``occupied`` -> their (k, B^3) SDF values."""
        vals = torch.empty((len(rows), B ** 3), device=dev)
        for s in range(0, len(rows), G):
            origins = origins_all[rows[s:s + G]]                   # (k, 3), k <= G
            k = len(origins)
            # lattice indices past R-1 clamp; the host copy drops those rows
            idx = torch.minimum(origins[:, :, None] + ar[None, None, :],
                                torch.tensor(R - 1, device=dev))
            p = -1.0 + scale * idx.float()                         # (k, 3, B)
            pts = torch.empty((k, B, B, B, 3), device=dev)
            pts[..., 0] = p[:, 0, :, None, None]
            pts[..., 1] = p[:, 1, None, :, None]
            pts[..., 2] = p[:, 2, None, None, :]
            vals[s:s + k] = sdf_fn(pts.reshape(-1, 3)).reshape(k, -1)
        return vals

    if map_rows is None:
        def map_rows(fn, n):
            return fn(torch.arange(n, device=dev))
    with span("mesh.lattice") as lattice:
        blocks = occupied_blocks_host(stages, R, B)
        occupied = np.argwhere(blocks)
        origins_all = torch.from_numpy(occupied * B).to(dev)
        ar = torch.arange(B, device=dev)
        scale = 2.0 / (R - 1.0)
        vals = map_rows(eval_blocks, len(occupied)) if len(occupied) else \
            torch.empty((0, B ** 3), device=dev)
        host = to_host(vals) if mesh else None
    stats.update(mesh_lattice_s=lattice.seconds, lattice_points=len(occupied) * B ** 3,
                 lattice_blocks=[len(occupied), int(blocks.size)])
    if not mesh:
        return None
    with span("mesh.fill") as fill:
        u = np.full((R, R, R), 100.0, np.float32)
        for (bx, by, bz), v in zip(occupied, host.numpy().reshape(-1, B, B, B)):
            sx = slice(bx * B, min((bx + 1) * B, R))
            sy = slice(by * B, min((by + 1) * B, R))
            sz = slice(bz * B, min((bz + 1) * B, R))
            u[sx, sy, sz] = v[:sx.stop - sx.start, :sy.stop - sy.start, :sz.stop - sz.start]
    with span("mesh.cubes") as cubes:
        if vals.device.type == "cuda":
            card = BlockLattice(vals, blocks, R, B)
            verts, tris = marching_cubes(card, 0.0)
            stats["mesh_cubes_cells"] = card.cells
        else:
            verts, tris = marching_cubes(-u, 0.0)
        verts = verts / (R - 1.0) * 2.0 - 1.0
    stats.update(mesh_fill_s=fill.seconds, mesh_cubes_s=cubes.seconds)
    return verts, tris, u
