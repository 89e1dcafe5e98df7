"""The share of the traced window, in %, in which no operation ran on the
card: 1 - (the union of the device operations' intervals) / (the window).
``device_idle.val`` and ``device_idle.train``; BENCHMARK.json's
``workloads`` lists say which cells report which."""


def read(ctx):
    if ctx.tr is None:
        return None
    return 100.0 * (1.0 - ctx.tr.busy_s() / ctx.tr.window_s)
