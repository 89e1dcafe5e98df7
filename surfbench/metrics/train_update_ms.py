"""Mean device milliseconds a training step spends in its ``update``
range: the device operations that start inside the harness's host range
around the step's update (which ends in a synchronise in traced runs)."""


def read(ctx):
    if ctx.tr is None:
        return None
    per_step = ctx.tr.range_device_s("update")
    return 1e3 * sum(per_step) / len(per_step) if per_step else None
