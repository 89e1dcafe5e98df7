"""What every cell's run shares: the context a traffic kind fills, the
kernel-bound pass, the model-FLOP count, the reading of the numbers a
check compares and the result's line.

A traffic module (``surfbench/traffic/<kind>.py``) defines
``prepare(ctx)`` (make the inputs and weights from the seed),
``setup(ctx)`` (``prepare``, then build the program on them and warm up
its shapes), ``window(ctx, seconds)`` (run whole units until the window
is over, counting them in ``ctx.units``), ``end_to_end(ctx)``
(the cell's end-to-end metrics but ``setup_s`` and ``peak_mem_gb``),
``bound_pass(ctx)`` (one unit more with every kernel call counted),
``release(ctx)`` (move what the check reads off the card, after one more
unit where the check compares one, and free the program), ``check(ctx, flops)`` (run the reference; return the numbers
compared and, with ``flops``, the model FLOPs of one unit) and
``control(ctx)`` (the reference in a lower precision in the program's
place, for ``calibrate``).
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import shutil
import sys
import tempfile
import time

import torch

from . import counts
from .trace import Trace, WINDOW, host_range, profiler

# top-level module names that a run of the port must not hold
FORBIDDEN = ("jax", "jaxlib", "flax", "surf_tpu")


class Ctx:
    """One run of one cell."""

    def __init__(self, cell, seed, *, device, trace):
        self.cell = cell
        self.workload = cell["workload"]
        self.config = cell["config"]
        self.seed = int(seed)
        self.device = torch.device(device)
        self.trace = bool(trace)
        self.out_dir = tempfile.mkdtemp(prefix=f"surfbench_{cell['name']}_")
        self.units = 0
        self.elapsed = 0.0
        self.tr = None              # Trace of the window (traced runs)
        self.kernels = None         # {"bound_s", "device_s"} (traced runs)
        self.flops_per_unit = None  # model FLOPs of one unit (traced runs)
        self.info = {}              # what the traffic records for the metric readers

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def forbidden_modules():
    """The forbidden top-level names that ``sys.modules`` holds, compared
    whole (``surf_tpu_torch`` is not ``surf_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


@contextlib.contextmanager
def count_kernels(ctx):
    """Every call of a kernel wrapper (``counts.KERNELS``) inside the block
    runs alone in a host range ``surfbench.<kernel>`` that ends once the
    card is done, and its bound is counted after it.  Yields the list of
    the calls' bounds in seconds."""
    calls = []
    swaps = []
    for k, (mod_name, fn_name) in counts.KERNELS.items():
        mod = importlib.import_module(mod_name)
        orig = getattr(mod, fn_name)

        def counted(*a, __k=k, __fn=orig, **kw):
            ctx.sync()
            with host_range(f"surfbench.{__k}", sync=ctx.device.type == "cuda"):
                out = __fn(*a, **kw)
            with torch.no_grad():
                b, f = counts.call_counts(__k, a, kw, out)
            calls.append(counts.bound_s(b, f))
            return out
        swaps.append((mod, fn_name, orig))
        setattr(mod, fn_name, counted)
    try:
        yield calls
    finally:
        for mod, fn_name, orig in swaps:
            setattr(mod, fn_name, orig)


def kernel_pass(ctx, run_unit):
    """Runs ``run_unit()`` profiled with every kernel call counted; sets
    ``ctx.kernels``: the summed bound and device seconds of the calls."""
    names = [f"surfbench.{k}" for k in counts.KERNELS]
    with profiler() as prof:
        with torch.profiler.record_function(WINDOW):
            with count_kernels(ctx) as calls:
                run_unit()
            ctx.sync()
    tr = Trace(prof, names)
    ctx.kernels = {"bound_s": sum(calls),
                   "device_s": sum(sum(tr.range_device_s(n)) for n in names)}


@contextlib.contextmanager
def model_flops():
    """Counts the matmul and convolution operations of the reference run
    inside the block (``torch.utils.flop_counter``), with each sparse
    convolution counted by its present (row, tap) pairs, 2 Cin Cout each,
    in place of the dense gathered product the plain version computes.
    Yields a dict whose ``total`` is set when the block ends."""
    from torch.utils.flop_counter import FlopCounterMode
    from .reference.nn import reg_net
    box = {"dense": 0, "present": 0}
    fwd, dw = reg_net.gather_conv_plain, reg_net.gather_conv_dw_plain

    def tally(x, idx, c_out, live):
        if live is not None:
            idx = torch.where(live[:, None], idx, torch.full_like(idx, -1))
        R, T = idx.shape
        box["dense"] += 2 * R * T * x.shape[1] * c_out
        box["present"] += 2 * int((idx >= 0).sum()) * x.shape[1] * c_out

    def fwd_counted(x, idx, w, live=None):
        tally(x, idx, w.shape[2], live)
        return fwd(x, idx, w, live)

    def dw_counted(x, idx, ct, live=None):
        tally(x, idx, ct.shape[1], live)
        return dw(x, idx, ct, live)
    reg_net.gather_conv_plain, reg_net.gather_conv_dw_plain = fwd_counted, dw_counted
    out = {}
    try:
        with FlopCounterMode(display=False) as fcm:
            yield out
        out["total"] = fcm.get_total_flops() - box["dense"] + box["present"]
    finally:
        reg_net.gather_conv_plain, reg_net.gather_conv_dw_plain = fwd, dw


def free_card(ctx=None):
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def run(cell, seed, seconds, trace, *, device="cuda", t_start=None, info=None):
    """One run of ``cell``: set-up, the window, the traced reading (with
    ``trace``) and the check.  Returns (result dict, [(name, value,
    limit)]); ``info``, a dict, gets what the check noted beside its
    numbers."""
    from . import manifest
    t_start = time.time() if t_start is None else t_start
    ctx = Ctx(cell, seed, device=device, trace=trace)
    traffic = importlib.import_module(f"surfbench.traffic.{cell['workload']['traffic']}")
    clock = [("start", t_start)]

    def lap(name):
        clock.append((name, time.time()))
    traffic.setup(ctx)
    ctx.sync()
    if ctx.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(ctx.device)
    setup_s = time.time() - t_start
    lap("setup")
    if trace:
        with profiler() as prof:
            with torch.profiler.record_function(WINDOW):
                traffic.window(ctx, seconds)
                ctx.sync()
        lap("window")
        ctx.tr = Trace(prof, traffic.RANGES)
        del prof
        lap("trace_read")
    else:
        traffic.window(ctx, seconds)
        lap("window")
    peak = torch.cuda.max_memory_allocated(ctx.device) if ctx.device.type == "cuda" else 0
    if trace:
        traffic.bound_pass(ctx)
        lap("bound_pass")
    traffic.release(ctx)
    free_card(ctx)
    compared, ctx.flops_per_unit = traffic.check(ctx, flops=trace)
    free_card(ctx)
    shutil.rmtree(ctx.out_dir, ignore_errors=True)
    lap("check")
    print("surfbench: seconds " + " ".join(
        f"{n}={b - a:.3f}" for (_, a), (n, b) in zip(clock, clock[1:])), file=sys.stderr)

    if trace:
        metrics = {}
        for m in cell["per_layer"]:
            v = manifest.module("metrics", m["name"]).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        e2e = dict(traffic.end_to_end(ctx))
        e2e["peak_mem_gb"] = peak / 1e9
        e2e["setup_s"] = setup_s
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in cell["end_to_end"]}
    correct = bool(compared) and all(v == v and v <= lim for _, v, lim in compared)
    dev = {"platform": "gpu" if ctx.device.type == "cuda" else ctx.device.type,
           "kind": torch.cuda.get_device_name(ctx.device) if ctx.device.type == "cuda"
           else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": ctx.units, "failed": 0,
              "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = ctx.tr.busy_s()
        dev["window_s"] = ctx.tr.window_s
        result["breakdown"] = {"device_ops": ctx.tr.device_ops(),
                               "idle_gaps": ctx.tr.idle_gaps()}
    result["checked"] = {n: {"value": v, "limit": lim} for n, v, lim in compared}
    if info is not None:
        info.update({k: v for k, v in ctx.info.items() if not k.startswith("val_")})
    return result, compared
