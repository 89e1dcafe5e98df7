"""The card's idle milliseconds a finetune step inside one span of the
program's step, ``finetune.<part>`` for ``finetune_idle_ms.<part>`` (rays,
render, loss, update; the part is this module's name after its last
dot): as ``train_idle_ms`` reads the training forward's spans, each
span's self time less what the card was busy in it, summed over the
traced window and divided by its steps.  Nothing where the program
records no spans, or none of that name."""

from __future__ import annotations

from surfbench.metrics.train_idle_ms import self_idle_ns

PREFIX = "finetune."


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
