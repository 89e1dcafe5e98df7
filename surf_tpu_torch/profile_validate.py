"""Where one validation pass spends its time on the card.

    python -m surf_tpu_torch.profile_validate [--conf confs/surf_synthetic_full.conf]
        [--mesh_resolution 512] [--out exp/profile_validate]

Runs ``Validator.validate`` twice on seeded random weights: once to warm up
(kernel builds, cuDNN plans, the allocator), then under ``torch.profiler``
(CPU and CUDA activities).  Prints the card (nvidia-smi name and power
limit), then for each phase of the profiled pass (the ``build`` / ``mesh``
/ ``render`` ranges of ``Validator.validate``) its host time, the device
time of the kernels launched inside it and their ratio (the device's busy
share; the profiler's own host cost lowers it) with its heaviest kernels,
and the CUDA kernels of the whole pass by total device time.  The whole
kernel table goes to ``<out>/kernels.txt``.  Needs a card; the numeric
settings are the port's own (``card.set_numerics``).  ``chip_smoke.py``
reports the warm pass's metrics without the profiler.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from .card import nvidia_smi_line, set_numerics
from .config import ConfigFactory
from .validate import Validator

PHASES = ("build", "mesh", "render")
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
    t0 = time.time()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        v.validate()
        torch.cuda.synchronize()
    wall_s = time.time() - t0
    # the phase ranges show up twice: as host ranges and as spans on the
    # device timeline; neither is a kernel
    is_kernel = lambda e: e.device_type == DeviceType.CUDA and e.key not in PHASES
    run = [e for e in prof.events() if is_kernel(e)]
    device_s = sum(e.time_range.elapsed_us() for e in run) / 1e6
    print("[profiled] " + json.dumps({"wall_s": wall_s, "device_s": device_s,
                                      "busy_share": device_s / wall_s}), flush=True)
    # a phase's kernels are those that start inside its host range: each
    # phase ends in a synchronise, and backward kernels launched from the
    # autograd thread are not children of the range
    for e in prof.events():
        if e.key in PHASES and e.device_type == DeviceType.CPU:
            a, b = e.time_range.start, e.time_range.end
            by_name = {}
            for k in run:
                if a <= k.time_range.start < b:
                    by_name[k.key] = by_name.get(k.key, 0) + k.time_range.elapsed_us()
            dev_s = sum(by_name.values()) / 1e6
            host_s = (b - a) / 1e6
            top = sorted(by_name.items(), key=lambda kv: -kv[1])[:PHASE_TOP]
            print("[phase] " + json.dumps({
                "phase": e.key, "host_s": host_s, "device_s": dev_s,
                "busy_share": dev_s / host_s,
                "top": [{"name": n[:100], "device_ms": t / 1e3} for n, t in top]}),
                flush=True)
    kernels = sorted((e for e in prof.key_averages() if is_kernel(e)),
                     key=lambda e: -e.device_time_total)
    with open(os.path.join(args.out, "kernels.txt"), "w") as f:
        f.write(f"{smi}\nkernel\tcalls\tdevice_ms\tshare_of_device_time\n")
        for e in kernels:
            f.write(f"{e.key}\t{e.count}\t{e.device_time_total / 1e3}\t"
                    f"{e.device_time_total / 1e6 / device_s}\n")
    for e in kernels[:TOP]:
        print("[kernel] " + json.dumps({
            "name": e.key[:120], "calls": e.count,
            "device_ms": e.device_time_total / 1e3,
            "share": e.device_time_total / 1e6 / device_s}), flush=True)


if __name__ == "__main__":
    main()
