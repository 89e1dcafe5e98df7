"""Runs one cell of the benchmark of surf_tpu_torch once.

    python -m surfbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Set-up makes the cell's inputs and weights
from the seed and warms up its shapes; the window then runs the cell's
traffic for ``--seconds``; the check compares what the window's work
produced with the plain reference (surfbench/reference/).  The last line
of standard output is the result: with ``--trace 0`` the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics read from a
profile of the window.  The numbers compared, each with its limit, are
the last lines of standard error and the result's last key.  Exits 2
without a result where the card, the count of cards the cell asks for or
the program is missing, and 3 where the process holds JAX or the JAX
package once the window has closed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def _process_start():
    """The wall-clock time this process started (Linux), else now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return time.time() - up + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time()


T_START = _process_start()
HERE = os.path.dirname(os.path.abspath(__file__))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def cache_dirs():
    """Fixed cache directories inside the checkout, for whatever the
    program or PyTorch compiles (the port's own kernels build into
    surf_tpu_torch/_build/)."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        path = os.path.join(HERE, ".cache", sub)
        os.makedirs(path, exist_ok=True)
        os.environ[var] = path


def main(argv=None):
    args = parse_args(argv)
    cache_dirs()
    from . import harness, manifest
    import torch
    bench = manifest.load_benchmark(os.getcwd())
    cell = manifest.cell(bench, args.workload)
    chips = int(cell["entry"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"surfbench: needs {chips} CUDA device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    try:
        import surf_tpu_torch  # noqa: F401  (the system under test)
    except ImportError as e:
        print(f"surfbench: the program surf_tpu_torch is missing: {e}", file=sys.stderr)
        return 2
    result, compared = harness.run(cell, args.seed, args.seconds, args.trace,
                                   device="cuda", t_start=T_START)
    bad = harness.forbidden_modules()
    if bad:
        print(f"surfbench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    for name, value, limit in compared:
        print(f"{name} {value!r} limit {limit!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
