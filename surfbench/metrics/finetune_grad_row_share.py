"""The share of the stage storages' rows, in %, whose gradient a finetune
step touched: Σ rows with a gradient not all zero over Σ rows, over every
stage and every traced step of the window, from the program's counter
``storage_grad_rows`` (counted after each step's backward while a
profiler runs).  Adam passes over every row of every storage; this is the
part of that pass that has a gradient to work on.  Nothing where the
program keeps no such counter."""

from __future__ import annotations


def read(ctx):
    rows = [stage for step in ctx.info.get("storage_grad_rows") or () for stage in step]
    total = sum(n for _, n in rows)
    return 100.0 * sum(t for t, _ in rows) / total if total else None
