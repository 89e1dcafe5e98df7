"""What marching cubes makes of an SDF lattice, read without running it.

The program meshes the lattice u with surf_tpu_torch/csrc/marching_cubes.cpp
(commit 5b1d451) on the grid -u at iso 0: a corner is inside where
-u < 0, every lattice edge whose two corners differ gets one vertex (shared
by the cubes around it) at the linear zero crossing, and a cube makes the
triangles of Lorensen and Cline's table for its corner pattern.  So the
mesh of a lattice has as many vertices as the lattice has such edges, at
those crossings, and as many triangles as the table gives its cubes.
``TRIANGLES`` is the number of triangles of each of the 256 corner
patterns in that table (Bourke's corner order).
"""

from __future__ import annotations

import numpy as np

TRIANGLES = np.array([0, 1, 1, 2, 1, 2, 2, 3, 1, 2, 2, 3, 2, 3, 3, 2, 1, 2, 2, 3, 2, 3, 3, 4, 2, 3, 3, 4, 3, 4, 4, 3, 1, 2, 2, 3, 2, 3, 3, 4, 2, 3, 3, 4, 3, 4, 4, 3, 2, 3, 3, 2, 3, 4, 4, 3, 3, 4, 4, 3, 4, 5, 5, 2, 1, 2, 2, 3, 2, 3, 3, 4, 2, 3, 3, 4, 3, 4, 4, 3, 2, 3, 3, 4, 3, 4, 4, 5, 3, 4, 4, 5, 4, 5, 5, 4, 2, 3, 3, 4, 3, 4, 2, 3, 3, 4, 4, 5, 4, 5, 3, 2, 3, 4, 4, 3, 4, 5, 3, 2, 4, 5, 5, 4, 5, 2, 4, 1, 1, 2, 2, 3, 2, 3, 3, 4, 2, 3, 3, 4, 3, 4, 4, 3, 2, 3, 3, 4, 3, 4, 4, 5, 3, 2, 4, 3, 4, 3, 5, 2, 2, 3, 3, 4, 3, 4, 4, 5, 3, 4, 4, 5, 4, 5, 5, 4, 3, 4, 4, 3, 4, 5, 5, 4, 4, 3, 5, 2, 5, 4, 2, 1, 2, 3, 3, 4, 3, 4, 4, 5, 3, 4, 4, 5, 2, 3, 3, 2, 3, 4, 4, 5, 4, 5, 5, 2, 4, 3, 5, 4, 3, 2, 4, 1, 3, 4, 4, 5, 4, 5, 3, 4, 4, 5, 5, 2, 3, 4, 2, 1, 2, 3, 3, 2, 3, 4, 2, 1, 3, 2, 4, 1, 2, 1, 1, 0], np.int64)

# Bourke's corner order: bit i of a cube's pattern is corner CORNERS[i]
CORNERS = ((0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0),
           (0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1))


def _crop(u):
    """The smallest box of u holding every value below +100 and one more
    lattice point on each side (outside it no corner is inside and no
    edge changes sign), and its origin."""
    near = np.argwhere(u < 100.0)
    if len(near) == 0:
        return u[:0, :0, :0], np.zeros(3, np.int64)
    lo = np.maximum(near.min(0) - 1, 0)
    hi = np.minimum(near.max(0) + 2, u.shape)
    return u[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]], lo


def crossings(u):
    """(keys, points) of the lattice edges of u that change sign: an edge
    is keyed (lower corner's linear index) * 3 + axis over the whole
    lattice, its point in lattice units, both sorted by key."""
    R = np.array(u.shape, np.int64)
    c, lo = _crop(u)
    g = -c
    inside = g < 0
    keys, pts = [], []
    for axis in range(3):
        a = [slice(None)] * 3
        b = [slice(None)] * 3
        a[axis], b[axis] = slice(0, -1), slice(1, None)
        sel = inside[tuple(a)] != inside[tuple(b)]
        idx = np.argwhere(sel)
        ga, gb = g[tuple(a)][sel], g[tuple(b)][sel]
        mu = (np.float32(0.0) - ga) / (gb - ga)
        p = (idx + lo).astype(np.float32)
        p[:, axis] += mu
        low = idx + lo
        keys.append(((low[:, 0] * R[1] + low[:, 1]) * R[2] + low[:, 2]) * 3 + axis)
        pts.append(p)
    keys, pts = np.concatenate(keys), np.concatenate(pts)
    order = np.argsort(keys)
    return keys[order], pts[order]


def n_triangles(u):
    """The triangles marching cubes makes of u."""
    c, _ = _crop(u)
    inside = (-c) < 0
    if min(inside.shape) < 2:
        return 0
    n = [s - 1 for s in inside.shape]
    pattern = np.zeros(n, np.uint8)
    for bit, (dx, dy, dz) in enumerate(CORNERS):
        pattern |= inside[dx:dx + n[0], dy:dy + n[1], dz:dz + n[2]].astype(np.uint8) << bit
    return int(TRIANGLES[pattern].sum())


def match(verts, keys, points, R):
    """Matches mesh vertices (lattice units; each lies on a lattice edge)
    one to one to the crossings (``keys``, ``points``) of a lattice of side
    ``R``: a vertex takes, of the edges of its three axes through it, the
    nearest crossing that no other vertex took (two vertices can sit on one
    lattice point, each on its own edge).  Returns (the share of vertices
    and crossings left without a partner, over the crossings; the largest
    distance of a matched vertex from its crossing)."""
    q = np.asarray(verts, np.float64)
    n = len(q)
    cand_k, cand_d = [], []
    # on an edge of ``axis`` the vertex lies between its lower corner and the
    # next lattice point; rounding (vertices come in [-1, 1]) can move it
    # past either end by a few 1e-5
    for axis, shift in [(a, s) for a in range(3) for s in (-1e-3, 1e-3)]:
        low = np.round(q).astype(np.int64)
        low[:, axis] = np.floor(q[:, axis] + shift).astype(np.int64)
        low = np.clip(low, 0, R - 1)
        k = ((low[:, 0] * R + low[:, 1]) * R + low[:, 2]) * 3 + axis
        if len(keys):
            i = np.clip(np.searchsorted(keys, k), 0, len(keys) - 1)
            d = np.where(keys[i] == k, np.abs(q - points[i]).max(1), np.inf)
        else:
            d = np.full(n, np.inf)
        cand_k.append(k)
        cand_d.append(d)
    cand_k, cand_d = np.stack(cand_k, 1), np.stack(cand_d, 1)
    order = np.argsort(cand_d, 1, kind="stable")
    first = order[:, 0]
    rows = np.arange(n)
    best_k = np.where(np.isfinite(cand_d[rows, first]), cand_k[rows, first], -1)
    best_d = cand_d[rows, first]
    # the rare vertices whose nearest crossing another took: their next one
    _, at, counts = np.unique(best_k, return_index=True, return_counts=True)
    taken = set(best_k[at][best_k[at] >= 0].tolist())
    keep = np.zeros(n, bool)
    keep[at] = True
    for v in np.nonzero(~keep & (best_k >= 0))[0]:
        best_k[v], best_d[v] = -1, np.inf
        for c in order[v]:
            if np.isfinite(cand_d[v, c]) and int(cand_k[v, c]) not in taken:
                best_k[v], best_d[v] = cand_k[v, c], cand_d[v, c]
                taken.add(int(cand_k[v, c]))
                break
    matched = int((best_k >= 0).sum())
    unmatched = (n - matched) + (len(keys) - matched)
    shift = float(best_d[best_k >= 0].max()) if matched else float("inf")
    return unmatched / max(len(keys), 1), shift
