"""Host-side marching cubes through the package's own copy of the C++
extension (csrc/marching_cubes.cpp), built lazily with g++ into the
package's build directory and loaded through ctypes.  The SDF lattice is
computed on the card; extraction runs on the host CPU.
"""

from __future__ import annotations

import ctypes

import numpy as np

from .._build import NATIVE_FLOAT, host_lib


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
    """grid: (nx, ny, nz) float array.  Returns (vertices (v, 3) float32 in
    grid-index coordinates, triangles (t, 3) int64)."""
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
