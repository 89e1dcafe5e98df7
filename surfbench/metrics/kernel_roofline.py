"""The hand-written kernels' share of their roofline, in %: over every
call of a K1-K4w wrapper in one more unit of the cell's traffic run after
the window (a validate, or a training step), the summed
bound (surfbench/counts.py: the bytes at 3.35 TB/s or the f32
operations at 67 TFLOP/s, the longer) over the summed device time of the
calls' operations (torch.profiler), each call run alone between two
synchronises.  ``kernel_roofline.val`` and ``kernel_roofline.train``;
BENCHMARK.json's ``workloads`` lists say which cells report which."""


def read(ctx):
    if ctx.kernels is None or ctx.kernels["device_s"] <= 0:
        return None
    return 100.0 * ctx.kernels["bound_s"] / ctx.kernels["device_s"]
