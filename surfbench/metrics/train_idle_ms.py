"""The card's idle milliseconds a training step inside one span of the
program's forward, ``train.<part>`` for ``train_idle_ms.<part>`` (fpn,
cascade, render, loss; the part is this module's name after its last
dot): for each such span the program recorded inside the traced window
(``surf_tpu_torch.utils.spans``, on the profiler's clock), the part of its
interval that no device operation covers, less what its child spans
leave idle (its self time), summed and divided by the window's steps.
Nothing where the program records no spans, or none of that name."""

from __future__ import annotations

import bisect

PREFIX = "train."


def covered(busy, cum, a, b):
    """Nanoseconds of [a, b] covered by ``busy`` (sorted disjoint
    intervals, ``cum`` the running sum of their lengths)."""
    def before(t):
        i = bisect.bisect_right(busy, [t, float("inf")])
        return cum[i] - (max(busy[i - 1][1] - t, 0) if i else 0)
    return before(b) - before(a)


def self_idle_ns(busy, records, t0, t1):
    """{span name: idle ns inside its spans less their children's} over
    the records (name, parent, start_ns, end_ns) that lie in [t0, t1]."""
    busy = [list(iv) for iv in busy]
    cum = [0]
    for a, b in busy:
        cum.append(cum[-1] + b - a)
    spans = sorted((r for r in records if t0 <= r[2] and r[3] <= t1), key=lambda r: r[2])
    starts = [r[2] for r in spans]
    idle = {}
    for name, _, a, b in spans:
        own = (b - a) - covered(busy, cum, a, b)
        for c_name, c_parent, c, d in spans[bisect.bisect_left(starts, a):
                                            bisect.bisect_right(starts, b)]:
            if c_parent == name and d <= b and (c, d) != (a, b):
                own -= (d - c) - covered(busy, cum, c, d)
        idle[name] = idle.get(name, 0) + own
    return idle


def read(ctx):
    if ctx.tr is None or not ctx.units:
        return None
    if not hasattr(ctx, "span_idle_ns"):
        try:
            from surf_tpu_torch.utils.spans import recorded
        except ImportError:
            ctx.span_idle_ns = {}
        else:
            ctx.span_idle_ns = self_idle_ns(ctx.tr.busy_intervals(), recorded(),
                                            ctx.tr.t0, ctx.tr.t1)
    name = PREFIX + __name__.rsplit(".", 1)[-1]
    if name not in ctx.span_idle_ns:
        return None
    return ctx.span_idle_ns[name] / 1e6 / ctx.units
