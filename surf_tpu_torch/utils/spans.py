"""The port's one way to time a phase: ``with span(name) as s: ...``.

A span is a ``torch.profiler.record_function`` range, so it lands in any
profile, timed by the host clock ``time.time_ns``, the clock of the
profiler's kineto events (a span's start falls within a fraction of a
millisecond of its range's).  Once the block ends the span's ``seconds``
hold its duration; the callers that report a phase's time read it there.

While a profiler runs (``torch.autograd.profiler._is_profiler_enabled``)
each span also records ``(name, parent name, start_ns, end_ns)`` in
memory, its parent being the innermost span open on the same thread (None
at the top); ``recorded()`` returns the newest ``CAP`` records, in the
order the spans ended.  With no profiler running a span costs its range,
the clock reads and one test.  Spans stay outside per-chunk, per-block and
per-kernel loops: a validate or a training step opens a few dozen at most.
"""

from __future__ import annotations

import collections
import threading
import time

import torch
from torch.autograd import profiler as _autograd_profiler

CAP = 100_000

_records = collections.deque(maxlen=CAP)
_open = threading.local()


def _stack():
    stack = getattr(_open, "names", None)
    if stack is None:
        stack = _open.names = []
    return stack


class span:
    """One timed phase; ``seconds`` is set when the block ends."""

    __slots__ = ("name", "seconds", "_range", "_start", "_parent")

    def __init__(self, name):
        self.name = name
        self.seconds = None
        self._parent = False            # not recording (no profiler ran at entry)

    def __enter__(self):
        if recording():
            stack = _stack()
            self._parent = stack[-1] if stack else None
            stack.append(self.name)
        self._range = torch.profiler.record_function(self.name)
        self._start = time.time_ns()
        self._range.__enter__()
        return self

    def __exit__(self, *exc):
        self._range.__exit__(*exc)
        end = time.time_ns()
        self.seconds = (end - self._start) / 1e9
        if self._parent is not False:
            _stack().pop()
            _records.append((self.name, self._parent, self._start, end))
        return False


def recording():
    """Whether spans record now: a profiler runs."""
    return bool(_autograd_profiler._is_profiler_enabled)


def recorded():
    """The records of the spans that ended while a profiler ran: [(name,
    parent name or None, start_ns, end_ns)], oldest first."""
    return list(_records)


def clear():
    """Drops every record."""
    _records.clear()
