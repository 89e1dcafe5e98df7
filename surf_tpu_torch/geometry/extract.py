"""SDF lattice evaluation on the card -> host marching cubes, with exact
block skipping (torch counterpart of surf_tpu/geometry/extract.py).

Blocks of the lattice that no stage's active voxel touches evaluate to the
pinned empty-space SDF (+100) everywhere (ops/sparse.occupied_blocks_host),
so they are skipped exactly.  Occupied blocks are evaluated
``blocks_per_call`` at a time, their lattice points generated on the
device from the block origins; one host copy at the end.
"""

from __future__ import annotations

import numpy as np
import torch

from .marching_cubes import marching_cubes
from ..ops.sparse import occupied_blocks_host


@torch.no_grad()
def extract_geometry(sdf_fn, stages, resolution, block=64, blocks_per_call=8):
    """sdf_fn(pts (m, 3)) -> (m,) SDF.  Returns (verts in [-1,1], tris, u)."""
    # a block no larger than the lattice (the skipping is exact either way)
    R, G = int(resolution), int(blocks_per_call)
    B = min(int(block), R)
    dev = stages[0][1].device
    blocks = occupied_blocks_host(stages, R, B)
    occupied = [tuple(b) for b in np.argwhere(blocks)]
    u = np.full((R, R, R), 100.0, np.float32)
    ar = torch.arange(B, device=dev)
    scale = 2.0 / (R - 1.0)
    pending = []
    for s in range(0, len(occupied), G):
        group = occupied[s:s + G]
        origins = torch.zeros((G, 3), dtype=torch.long)
        origins[:len(group)] = torch.tensor(group, dtype=torch.long) * B
        # lattice indices past R-1 clamp; the host copy drops those rows
        idx = torch.minimum(origins.to(dev)[:, :, None] + ar[None, None, :],
                            torch.tensor(R - 1, device=dev))
        p = -1.0 + scale * idx.float()                         # (G, 3, B)
        shp = (G, B, B, B)
        pts = torch.stack([p[:, 0, :, None, None].expand(shp),
                           p[:, 1, None, :, None].expand(shp),
                           p[:, 2, None, None, :].expand(shp)], dim=-1).reshape(-1, 3)
        pending.append((group, sdf_fn(pts)))
    vals_all = torch.stack([v for _, v in pending]).cpu().numpy() if pending else []
    for (group, _), vals in zip(pending, vals_all):
        vals = vals.reshape(G, B, B, B)
        for i, (bx, by, bz) in enumerate(group):
            sx = slice(bx * B, min((bx + 1) * B, R))
            sy = slice(by * B, min((by + 1) * B, R))
            sz = slice(bz * B, min((bz + 1) * B, R))
            u[sx, sy, sz] = vals[i, :sx.stop - sx.start, :sy.stop - sy.start,
                                 :sz.stop - sz.start]
    verts, tris = marching_cubes(-u, 0.0)
    verts = verts / (R - 1.0) * 2.0 - 1.0
    return verts, tris, u
