"""Readings for the limits of a cell's check (not run by the benchmark).

    python -m surfbench.calibrate --workload <name> --seeds a,b,... \\
        [--fault <name>] [--control_seeds c,d,e] [--seconds 3] [--out <file.jsonl>]

For each seed of ``--seeds``, one run of the cell (``--seconds`` of
window) and the numbers its check compares: the program's readings.  For
each seed of ``--control_seeds``, the same check with the control in the
program's place: the reference itself computed with TF32 on, the
precision below the configuration's f32 (each traffic module's
``control``).  With ``--fault``, the ``--seeds`` runs have that fault of
surfbench/faults.py planted in the program.  One JSON line a reading,
to standard output and to ``--out``.  All in one process, so the card's
start-up is paid once.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control_seeds", default="")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--fault", default=None,
                   help="a fault of surfbench/faults.py planted under the --seeds runs")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    from .run import cache_dirs
    cache_dirs()
    import contextlib
    import importlib
    import torch
    from . import faults, harness, manifest
    if not torch.cuda.is_available():
        print("surfbench.calibrate: needs a CUDA device", file=sys.stderr)
        return 2
    cell = manifest.cell(manifest.load_benchmark(os.getcwd()), args.workload)
    traffic = importlib.import_module(f"surfbench.traffic.{cell['workload']['traffic']}")
    out = open(args.out, "a") if args.out else None

    def emit(row):
        line = json.dumps(row)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
    kind = "fault:" + args.fault if args.fault else "program"
    for seed in [int(s) for s in args.seeds.split(",") if s]:
        t0 = time.time()
        info = {}
        fault = faults.FAULTS[cell["workload"]["traffic"]][args.fault]() if args.fault \
            else contextlib.nullcontext()
        with fault:
            result, compared = harness.run(cell, seed, args.seconds, 0, info=info)
        emit({"kind": kind, "seed": seed, "s": time.time() - t0,
              "metrics": {k: v["value"] for k, v in result["metrics"].items()},
              "numbers": {n: v for n, v, _ in compared}, "info": info})
    for seed in [int(s) for s in args.control_seeds.split(",") if s]:
        t0 = time.time()
        ctx = harness.Ctx(cell, seed, device="cuda", trace=False)
        traffic.prepare(ctx)
        traffic.control(ctx)
        harness.free_card(ctx)
        compared, _ = traffic.check(ctx)
        emit({"kind": "control", "seed": seed, "s": time.time() - t0,
              "numbers": {n: v for n, v, _ in compared},
              "info": {k: v for k, v in ctx.info.items() if not k.startswith("val_")}})
        del ctx
        harness.free_card()
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
