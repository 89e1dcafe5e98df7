"""Minimal triangle-mesh container (replaces the reference's trimesh usage:
construction at runner.py:231, transform at runner.py:236, export at
runner.py:240, face updates + connected components in utils/clean_mesh.py)."""

from __future__ import annotations

import numpy as np
from scipy.sparse import coo_matrix
from scipy.sparse.csgraph import connected_components

from ..io.ply import write_ply, read_ply


class Mesh:
    def __init__(self, vertices, faces):
        self.vertices = np.asarray(vertices, dtype=np.float64)
        self.faces = np.asarray(faces, dtype=np.int64)

    def copy(self):
        return Mesh(self.vertices.copy(), self.faces.copy())

    def apply_transform(self, T):
        """4x4 homogeneous transform, in place (trimesh-compatible)."""
        T = np.asarray(T)
        self.vertices = self.vertices @ T[:3, :3].T + T[:3, 3]
        return self

    def update_faces(self, face_mask):
        self.faces = self.faces[np.asarray(face_mask, bool)]
        return self

    def remove_unreferenced_vertices(self):
        used = np.zeros(len(self.vertices), bool)
        used[self.faces.reshape(-1)] = True
        remap = np.cumsum(used) - 1
        self.vertices = self.vertices[used]
        self.faces = remap[self.faces]
        return self

    def face_adjacency_components(self):
        """Connected components over faces (shared-edge adjacency via shared
        vertices — matches trimesh.graph usage in clean_mesh's cc>=500
        filter).  Returns (labels (n_faces,), n_components)."""
        nf = len(self.faces)
        if nf == 0:
            return np.zeros(0, np.int64), 0
        # faces sharing a vertex are connected (superset of edge adjacency;
        # equivalent for the purpose of dropping small floaters)
        rows = np.repeat(np.arange(nf), 3)
        cols = self.faces.reshape(-1)
        nv = len(self.vertices)
        m = coo_matrix((np.ones(nf * 3, np.int8), (rows, cols)), shape=(nf, nv))
        graph = m @ m.T
        n, labels = connected_components(graph, directed=False)
        return labels, n

    def export(self, path):
        write_ply(path, self.vertices.astype(np.float32), self.faces.astype(np.int32))

    @staticmethod
    def load(path):
        d = read_ply(path)
        return Mesh(d["vertices"], d.get("faces", np.zeros((0, 3), np.int64)))

    def __repr__(self):
        return f"Mesh(v={len(self.vertices)}, f={len(self.faces)})"
