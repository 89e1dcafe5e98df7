"""What a run leaves in its experiment directory besides checkpoints,
meshes and scalars: the source backup (surf_tpu/runner.py:192-207) and
the ``train.profile_dir`` trace (runner.py:136-137).

* ``codes_backup(base_exp_dir)`` copies the repository into
  ``<base_exp_dir>/codes_recording`` once: nothing if that directory
  exists, an ``OSError`` ignored (the backup is best effort).
* ``profile_trace(profile_dir, device)`` is a context: with a directory,
  a ``torch.profiler`` trace of the CPU (and, on a card, CUDA) activity
  inside it, exported as a Chrome trace
  ``<profile_dir>/trace_<pid>_<unix time>.json`` when it ends.
"""

from __future__ import annotations

import contextlib
import os
import shutil
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# the JAX runner's patterns, and the port's build and chip-run outputs
BACKUP_IGNORE = ("exp", "outputs", "data", ".git", "__pycache__", "*.so", ".jax_cache",
                 "codes_recording", "_build", "chiprun_out")


def codes_backup(base_exp_dir, src=ROOT):
    """Copy ``src`` (the repository) into ``<base_exp_dir>/codes_recording``
    unless that exists; returns the destination."""
    dst = os.path.join(base_exp_dir, "codes_recording")
    if os.path.exists(dst):
        return dst
    try:
        shutil.copytree(src, dst, ignore=shutil.ignore_patterns(*BACKUP_IGNORE))
    except OSError:
        pass
    return dst


@contextlib.contextmanager
def profile_trace(profile_dir, device="cpu"):
    """A ``torch.profiler.profile`` around the block when ``profile_dir``
    is set (else nothing); yields the trace's path or None."""
    if not profile_dir:
        yield None
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, f"trace_{os.getpid()}_{int(time.time())}.json")
    with torch.profiler.profile(activities=activities) as prof:
        try:
            yield path
        finally:
            if torch.device(device).type == "cuda":
                torch.cuda.synchronize(device)
    prof.export_chrome_trace(path)
    print(f"profiler trace: {path}", flush=True)
