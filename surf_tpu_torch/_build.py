"""Builds the package's native code at first use, into the git-ignored
``surf_tpu_torch/_build/`` directory, and loads it with ctypes.

* ``csrc/*.cu``: the hand-written CUDA kernels, one shared library each,
  compiled by ``nvcc`` for ``sm_90a`` with a plain C interface (no PyTorch
  headers, so a build takes seconds).  ``build_kernels()`` starts one
  ``nvcc`` per source, all at once, and waits for them.
* ``csrc/marching_cubes.cpp``, ``csrc/raycast_bvh.cpp``,
  ``csrc/png_unfilter.cpp`` and ``csrc/jpeg_decode.cpp``: host code (the
  marching cubes, the mesh cleaning's BVH raycaster, the PNG reader's
  unfilter, the JPEG codec), compiled by ``g++`` through ``host_lib``;
  the marching cubes and the raycaster with ``-march=native``
  (``NATIVE_FLOAT``), as the JAX package builds its copies, so that their
  float arithmetic contracts and rounds as the reference's does on the
  same host (an edge-on ray then hits the same face).

Nothing is compiled when a module is imported.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")

# the JAX package's g++ flag for its marching cubes and raycaster
NATIVE_FLOAT = ("-march=native",)

# kernel library name -> CUDA source
CUDA_SOURCES = {
    "grid_sample": "grid_sample.cu",
    "sparse_trilinear": "sparse_trilinear.cu",
    "gather_conv": "gather_conv.cu",
}

# -fmad=false: no contraction of a*b+c, so the kernels round like the plain
# PyTorch versions they are checked against (floor() of a voxel coordinate
# is discontinuous; a fused multiply-add can move it across a cell edge)
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-fmad=false"]

_LIBS: dict = {}
_LOCK = threading.Lock()


def _nvcc():
    path = shutil.which("nvcc")
    if path is None:
        cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME or put nvcc on PATH)")
    return path


def _stale(out, src):
    return (not os.path.exists(out)) or os.path.getmtime(out) < os.path.getmtime(src)


def _start_nvcc(name):
    src = os.path.join(CSRC, CUDA_SOURCES[name])
    out = os.path.join(BUILD_DIR, f"lib{name}.so")
    if not _stale(out, src):
        return None
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", src, "-o", tmp]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, tmp, out, cmd


def _finish(name, started):
    proc, tmp, out, cmd = started
    log, _ = proc.communicate()
    with open(os.path.join(BUILD_DIR, f"{name}.log"), "w") as f:
        f.write(" ".join(cmd) + "\n" + log)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {CUDA_SOURCES[name]}:\n{log}")
    os.replace(tmp, out)


def build_kernels(names=None):
    """Compile every (stale) CUDA kernel library in parallel.  Returns the
    dict name -> ptxas report (registers, shared memory, spills)."""
    names = list(names or CUDA_SOURCES)
    os.makedirs(BUILD_DIR, exist_ok=True)
    with _LOCK:
        started = {n: _start_nvcc(n) for n in names}
        errors = []
        for n, s in started.items():
            if s is not None:
                try:
                    _finish(n, s)
                except RuntimeError as e:
                    errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))
    reports = {}
    for n in names:
        log = os.path.join(BUILD_DIR, f"{n}.log")
        if os.path.exists(log):
            with open(log) as f:
                reports[n] = f.read()
    return reports


def cuda_lib(name):
    """The loaded kernel library ``name`` (built on first use)."""
    lib = _LIBS.get(name)
    if lib is None:
        build_kernels([name])
        lib = ctypes.CDLL(os.path.join(BUILD_DIR, f"lib{name}.so"))
        _LIBS[name] = lib
    return lib


def host_lib(name, source, flags=()):
    """The loaded host library built from ``csrc/<source>`` with g++ and
    the extra ``flags``."""
    lib = _LIBS.get(name)
    if lib is None:
        src = os.path.join(CSRC, source)
        out = os.path.join(BUILD_DIR, f"lib{name}.so")
        os.makedirs(BUILD_DIR, exist_ok=True)
        with _LOCK:
            if _stale(out, src):
                tmp = f"{out}.{os.getpid()}.tmp"
                subprocess.run(["g++", "-O3", *flags, "-shared", "-fPIC", "-std=c++17",
                                "-pthread", src, "-o", tmp], check=True, capture_output=True)
                os.replace(tmp, out)
        lib = ctypes.CDLL(out)
        _LIBS[name] = lib
    return lib


def kernel_fn(lib_name, fn_name, argtypes):
    """A typed C entry point of a kernel library.  Pointers and the stream
    are ``c_void_p`` (a bare Python int would be cut to 32 bits)."""
    fn = getattr(cuda_lib(lib_name), fn_name)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
    return fn


def check(rc, what):
    """Raise if a kernel's C entry returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")


def stream_of(t):
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream


def on_device(t):
    """The launch context of a kernel on ``t``: its card made current (a
    ctypes launch runs on the current device, which a rank that did not
    call ``set_device`` may not have made its tensors')."""
    import torch
    return torch.cuda.device(t.device)


# launches of each hand-written kernel: a wrapper adds one where it
# launches its kernel, and nowhere else (the CPU path adds nothing)
launches = {"bilinear_sample_2d": 0, "trilinear_sample_3d": 0,
            "sparse_trilinear_multi": 0, "gather_conv": 0,
            "bilinear_sample_2d_bwd": 0, "trilinear_sample_3d_bwd": 0,
            "sparse_trilinear_multi_bwd": 0, "gather_conv_dw": 0,
            "bilinear_sample_2d_bwd2_gather": 0, "bilinear_sample_2d_bwd2_scatter": 0,
            "trilinear_sample_3d_bwd2_gather": 0, "trilinear_sample_3d_bwd2_scatter": 0}


def reset_launches():
    for k in launches:
        launches[k] = 0


def require_cuda(what, *tensors):
    """The wrapper's device rule: a CUDA tensor launches the kernel; a CPU
    tensor takes the plain version (caller's branch); anything else, a
    mix, or tensors on two cards, raises."""
    dev = {t.device.type for t in tensors}
    if dev != {"cuda"}:
        raise ValueError(f"{what}: tensors on {sorted(dev)}; the kernel needs "
                         f"them all on one CUDA device")
    cards = {t.device.index for t in tensors}
    if len(cards) != 1:
        raise ValueError(f"{what}: tensors on cards {sorted(cards)}; the kernel needs "
                         f"them all on one CUDA device")
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{what}: non-contiguous input")
