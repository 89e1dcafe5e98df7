"""Where one validation pass spends its time on the card.

    python -m surf_tpu_torch.profile_validate [--conf confs/surf_synthetic_full.conf]
        [--mesh_resolution 512] [--out exp/profile_validate]

Runs ``Validator.validate`` twice on seeded random weights: once to warm up
(kernel builds, cuDNN plans, the allocator), then under ``torch.profiler``
(CPU and CUDA activities).  Prints the card (nvidia-smi name and power
limit), the pass's busy share (the union of the device operations'
intervals over its wall time), then for each span of the profiled pass
(``Validator.validate``'s ``upload``, ``build`` with ``build.fpn`` and
``build.cascade``, ``mesh`` with ``mesh.lattice``, ``mesh.fill`` and
``mesh.cubes``, ``render``, ``write``; ``utils.spans``) its host time,
the device time of the operations that start inside it, its busy share
(the profiler's own host cost lowers it) and its heaviest operations,
and the device operations of the whole pass by total time.  The whole
table goes to ``<out>/kernels.txt``.  A last ``[lattice]`` line gives the
profiled pass's K5 launches (``sdf_lattice_mlp``, one a call of
``blocks_per_call`` occupied blocks) and marching cubes' on the card (one
a mesh) and its ``lattice_points``, ``lattice_blocks`` and
``mesh_cubes_cells``.  Needs a card; the numeric settings are the port's
own (``card.set_numerics``).  ``chip_smoke.py`` reports the warm pass's
metrics without the profiler.
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from . import _build
from .card import nvidia_smi_line, set_numerics
from .config import ConfigFactory
from .utils import spans
from .validate import Validator

TOP = 25                  # kernels printed; kernels.txt has them all
PHASE_TOP = 8             # kernels printed per phase


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--conf", default="confs/surf_synthetic_full.conf")
    p.add_argument("--mesh_resolution", type=int, default=512)
    p.add_argument("--out", default="exp/profile_validate")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_validate needs an NVIDIA GPU")
    set_numerics()
    smi = nvidia_smi_line()
    print(f"[device] {smi}", flush=True)
    os.makedirs(args.out, exist_ok=True)
    v = Validator(ConfigFactory.parse_file(args.conf), device="cuda",
                  mesh_resolution=args.mesh_resolution,
                  base_exp_dir=os.path.join(args.out, "val"))
    v.validate()                                             # warm-up

    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.time()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        results = v.validate()
        torch.cuda.synchronize()
    report(prof, (), time.time() - t0, args.out, smi)
    lattice_line(results)


def lattice_line(results):
    """The lattice's K5 and marching cubes launches and counts of the pass
    ``results``."""
    keys = ("lattice_points", "lattice_blocks", "mesh_cubes_cells")
    print("[lattice] " + json.dumps({
        "sdf_lattice_mlp_launches": _build.launches["sdf_lattice_mlp"],
        "marching_cubes_lattice_launches": _build.launches["marching_cubes_lattice"],
        "scenes": [{k: m.get(k) for k in keys} for m in results]}), flush=True)


def union(intervals):
    """Sorted (start, end) pairs -> their union, as sorted disjoint
    [start, end] pairs."""
    out = []
    for a, b in intervals:
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def covered(busy, a, b):
    """How much of [a, b] the disjoint sorted intervals ``busy`` cover."""
    i = bisect.bisect_right(busy, [a, float("inf")])
    if i and busy[i - 1][1] > a:
        i -= 1
    total = 0
    for s, e in busy[i:]:
        if s >= b:
            break
        total += min(e, b) - max(s, a)
    return total


def report(prof, phases, wall_s, out, smi):
    """Print the profiled pass: the device's busy share (the union of its
    operations' intervals over the pass's wall time), then for each phase
    (the ranges named in ``phases`` and every span recorded in the pass,
    ``utils.spans``) its occurrences, host time, the device time of the
    operations that start inside it (a phase ends in a synchronise where
    its time is to count; backward kernels launched from the autograd
    thread start in the range around ``backward``), its busy share and its
    heaviest operations, and the device operations by time (all of them in
    ``<out>/kernels.txt``).  Read from the profiler's raw event list;
    times in nanoseconds there."""
    names = list(dict.fromkeys([*phases, *(r[0] for r in spans.recorded())]))
    ranges = {n: [] for n in names}
    ops = []
    for e in prof.profiler.kineto_results.events():
        a = e.start_ns()
        b = a + e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            # a range's mirror on the device timeline is no operation
            annotation = getattr(e, "is_user_annotation", None)
            if e.name() not in ranges and not (annotation and annotation()):
                ops.append((a, b, e.name()))
        elif e.name() in ranges:
            ranges[e.name()].append((a, b))
    ops.sort()
    busy = union((a, b) for a, b, _ in ops)
    busy_s = sum(b - a for a, b in busy) / 1e9
    device_s = sum(b - a for a, b, _ in ops) / 1e9
    print("[profiled] " + json.dumps({"wall_s": wall_s, "device_s": device_s,
                                      "busy_s": busy_s, "busy_share": busy_s / wall_s}),
          flush=True)
    starts = [a for a, _, _ in ops]
    for name in names:
        if not ranges[name]:
            continue
        by_name, host, inside = {}, 0, 0
        for a, b in ranges[name]:
            host += b - a
            inside += covered(busy, a, b)
            for s, e, k in ops[bisect.bisect_left(starts, a):bisect.bisect_left(starts, b)]:
                by_name[k] = by_name.get(k, 0) + e - s
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:PHASE_TOP]
        print("[phase] " + json.dumps({
            "phase": name, "count": len(ranges[name]), "host_s": host / 1e9,
            "device_s": sum(by_name.values()) / 1e9, "busy_share": inside / max(host, 1),
            "top": [{"name": n[:100], "device_ms": t / 1e6} for n, t in top]}), flush=True)
    totals = {}
    for a, b, k in ops:
        n, t = totals.get(k, (0, 0))
        totals[k] = (n + 1, t + b - a)
    kernels = sorted(totals.items(), key=lambda kv: -kv[1][1])
    with open(os.path.join(out, "kernels.txt"), "w") as f:
        f.write(f"{smi}\nkernel\tcalls\tdevice_ms\tshare_of_device_time\n")
        for k, (n, t) in kernels:
            f.write(f"{k}\t{n}\t{t / 1e6}\t{t / 1e9 / device_s}\n")
    for k, (n, t) in kernels[:TOP]:
        print("[kernel] " + json.dumps({
            "name": k[:120], "calls": n, "device_ms": t / 1e6,
            "share": t / 1e9 / device_s}), flush=True)


if __name__ == "__main__":
    main()
