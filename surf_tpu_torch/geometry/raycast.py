"""ctypes wrapper over the native BVH raycaster (csrc/raycast_bvh.cpp, a
copy of the JAX package's): pyembree-equivalent first-hit queries for mesh
cleaning.  Built with g++ at first use into the package's build directory
(``_build.host_lib``), as the marching cubes are."""

from __future__ import annotations

import ctypes

import numpy as np

from .._build import NATIVE_FLOAT, host_lib

_F32P = ctypes.POINTER(ctypes.c_float)
_I64P = ctypes.POINTER(ctypes.c_int64)


def _get_lib():
    lib = host_lib("raycast_bvh", "raycast_bvh.cpp", NATIVE_FLOAT)
    if not getattr(lib, "_surf_typed", False):
        lib.bvh_build.restype = ctypes.c_void_p
        lib.bvh_build.argtypes = [_F32P, ctypes.c_int64, _I64P, ctypes.c_int64]
        lib.bvh_first_hit.restype = None
        lib.bvh_first_hit.argtypes = [ctypes.c_void_p, _F32P, _F32P, ctypes.c_int64,
                                      _I64P, _F32P]
        lib.bvh_free.restype = None
        lib.bvh_free.argtypes = [ctypes.c_void_p]
        lib._surf_typed = True
    return lib


class RayMeshIntersector:
    """First-hit intersector (trimesh.ray.ray_pyembree-compatible subset)."""

    def __init__(self, mesh):
        self._lib = _get_lib()
        self._verts = np.ascontiguousarray(mesh.vertices, dtype=np.float32)
        self._tris = np.ascontiguousarray(mesh.faces, dtype=np.int64)
        self._handle = self._lib.bvh_build(
            self._verts.ctypes.data_as(_F32P), len(self._verts),
            self._tris.ctypes.data_as(_I64P), len(self._tris))

    def intersects_first(self, origins, directions):
        """Returns (tri_idx (n,) int64, -1 on miss; t (n,) float32)."""
        o = np.ascontiguousarray(origins, dtype=np.float32)
        d = np.ascontiguousarray(directions, dtype=np.float32)
        n = len(o)
        tri = np.empty(n, np.int64)
        t = np.empty(n, np.float32)
        self._lib.bvh_first_hit(self._handle, o.ctypes.data_as(_F32P),
                                d.ctypes.data_as(_F32P), n, tri.ctypes.data_as(_I64P),
                                t.ctypes.data_as(_F32P))
        return tri, t

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.bvh_free(self._handle)
            self._handle = None
