"""Runtime mesh cleaning against object masks and capture frusta: the
port's copy of surf_tpu/geometry/clean_mesh.py:21-88 (``--clean_mesh``).

* ``clean_mesh_by_mask``: project vertices into the dilated per-view
  masks, keep faces whose vertices land in more than ``min_nb_visible``;
* ``clean_mesh_outside_frustum``: cast a ray through every pixel of a
  ``upscale``-times finer grid of each view (the BVH raycaster,
  csrc/raycast_bvh.cpp, on all the host's threads), keep the faces hit,
  then drop connected components of fewer than ``min_cc`` faces.

The masks are dilated with ``cv2.dilate`` by
``cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (2r+1, 2r+1))``, rebuilt
here bit for bit: ``ellipse_kernel`` row by row as OpenCV builds it and
``dilate_masks`` as a union of row spans with zero borders.  All host-side
numpy and C++.
"""

from __future__ import annotations

import numpy as np

from .raycast import RayMeshIntersector


def ellipse_kernel(radius):
    """``cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (2r+1, 2r+1))``:
    row ``dy`` spans ``c - dx .. c + dx`` with
    ``dx = saturate_cast<int>(c * sqrt((r^2 - dy^2) / r^2))`` (round half
    to even)."""
    r = c = int(radius)
    k = np.zeros((2 * r + 1, 2 * r + 1), np.uint8)
    inv_r2 = 1.0 / (r * r) if r else 0.0
    for i in range(2 * r + 1):
        dy = i - r
        dx = int(np.rint(c * np.sqrt((r * r - dy * dy) * inv_r2)))
        k[i, max(c - dx, 0):min(c + dx + 1, 2 * r + 1)] = 1
    return k


def _dilate_rows(m, dx):
    """Binary dilation of each row of ``m`` by the span [-dx, dx]."""
    w = m.shape[1]
    c = np.zeros((m.shape[0], w + 1), np.int32)
    np.cumsum(m, axis=1, out=c[:, 1:])
    lo = np.clip(np.arange(w) - dx, 0, w)
    hi = np.clip(np.arange(w) + dx + 1, 0, w)
    return (c[:, hi] - c[:, lo]) > 0


def dilate(mask, kernel):
    """``cv2.dilate(mask, kernel)`` of a binary mask by a symmetric kernel
    whose rows are centred spans (as ``ellipse_kernel``'s): each kernel row
    dilates the rows by its half-width, shifted by its offset, zero
    outside the image."""
    m = np.asarray(mask) > 0
    h = m.shape[0]
    r = kernel.shape[0] // 2
    out = np.zeros_like(m)
    spans = {}
    for i in range(kernel.shape[0]):
        dx = int(kernel[i].sum()) // 2
        if not kernel[i].any():
            continue
        if dx not in spans:
            spans[dx] = _dilate_rows(m, dx)
        dy = i - r
        src = spans[dx]
        if dy >= 0:
            out[:h - dy] |= src[dy:]
        else:
            out[-dy:] |= src[:h + dy]
    return out.astype(np.uint8)


def dilate_masks(masks, radius=11):
    """Binary dilation of each mask with the (2r+1)² ellipse: uint8 0/1,
    as the JAX package's ``cv2.dilate`` gives it."""
    k = ellipse_kernel(radius)
    return np.stack([dilate(m, k) for m in masks])


def clean_mesh_by_mask(mesh, masks, intrs, c2ws, min_nb_visible=1):
    """masks: (nv, h, w) binary; intrs/c2ws (nv, 4, 4)."""
    pts = mesh.vertices  # (n, 3)
    nv, h, w = masks.shape
    visible = np.zeros(len(pts), np.int32)
    for v in range(nv):
        w2c = np.linalg.inv(c2ws[v])
        cam = pts @ w2c[:3, :3].T + w2c[:3, 3]
        proj = cam @ intrs[v][:3, :3].T
        z = proj[:, 2]
        xy = proj[:, :2] / np.clip(z[:, None], 1e-8, None)
        nx = 2 * xy[:, 0] / (w - 1) - 1
        ny = 2 * xy[:, 1] / (h - 1) - 1
        inside = (np.abs(nx) <= 1) & (np.abs(ny) <= 1) & (z > 1e-8)
        xi = np.clip(np.round(xy[:, 0]).astype(np.int64), 0, w - 1)
        yi = np.clip(np.round(xy[:, 1]).astype(np.int64), 0, h - 1)
        visible += (masks[v][yi, xi] > 0) & inside
    keep_vert = visible > min_nb_visible
    face_mask = keep_vert[mesh.faces].all(axis=-1)
    mesh.update_faces(face_mask)
    return mesh


def clean_mesh_outside_frustum(mesh, masks, intrs, c2ws, upscale=4, min_cc=500,
                               chunk=1 << 20):
    """Keep faces hit by at least one camera ray; then keep connected
    components with >= min_cc faces (utils/clean_mesh.py:38-106)."""
    if len(mesh.faces) == 0:
        return mesh
    intersector = RayMeshIntersector(mesh)
    nv, h, w = masks.shape
    hit = np.zeros(len(mesh.faces), bool)
    for v in range(nv):
        ys, xs = np.meshgrid(np.linspace(0, h - 1, int(h * upscale), dtype=np.float32),
                             np.linspace(0, w - 1, int(w * upscale), dtype=np.float32),
                             indexing="ij")
        p = np.stack([xs.reshape(-1), ys.reshape(-1), np.ones(xs.size, np.float32)], -1)
        dirs = p @ np.linalg.inv(intrs[v][:3, :3]).T
        dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
        dirs = dirs @ c2ws[v][:3, :3].T
        origin = np.broadcast_to(c2ws[v][:3, 3], dirs.shape)
        for s in range(0, len(dirs), chunk):
            tri, _ = intersector.intersects_first(origin[s:s + chunk], dirs[s:s + chunk])
            tri = tri[tri >= 0]
            hit[tri] = True
    mesh.update_faces(hit)
    if len(mesh.faces):
        labels, n = mesh.face_adjacency_components()
        sizes = np.bincount(labels, minlength=n)
        mesh.update_faces(sizes[labels] >= min_cc)
    mesh.remove_unreferenced_vertices()
    return mesh


def clean_mesh(mesh, masks, intrs, c2ws, dilate_radius=11, min_cc=500):
    """The inline ``--clean_mesh`` pass (utils/clean_mesh.py:109-130)."""
    masks = dilate_masks(np.asarray(masks), dilate_radius)
    mesh = clean_mesh_by_mask(mesh, masks, np.asarray(intrs), np.asarray(c2ws))
    mesh = clean_mesh_outside_frustum(mesh, masks, np.asarray(intrs),
                                      np.asarray(c2ws), min_cc=min_cc)
    return mesh
