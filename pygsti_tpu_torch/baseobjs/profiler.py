"""Profiler: the port's timers and spans (counterpart of
pygsti_tpu/baseobjs/profiler.py, trimmed to what the fit path calls).

Timers: ``Profiler.timing(name)`` adds a block's host seconds to
``timers[name]``; the GST protocol exports them as
``est.parameters['profiler']``.

Spans: while ``tracing()`` is open (one switch for the whole process, off
by default), ``span(name)`` at a layer boundary of the fit path records
(name, start ns, end ns, parent span, request id) into the tracing
profiler's preallocated lists; a ``fit`` span opened outside any other fit
starts a new request id, which every span inside it shares.  Off, a span
is one global check that returns the one shared no-op context: no clock
reading, no allocation.  On or off, a span does no device work: it never
synchronizes, records an event, reads a tensor or launches anything, so
it ends when the host leaves the layer, not when the card does.

Both read ``clock_ns``, Unix-epoch nanoseconds: the clock on which
torch.profiler's kineto events are stamped, so a device trace taken over
the same window joins with the spans.  Spans are recorded on the thread
that opened ``tracing()``; spans opened on other threads are not.
"""

from __future__ import annotations

import contextlib
import threading
import time

clock_ns = time.time_ns

_OFF = contextlib.nullcontext()     # the one context a span returns while tracing is off
_tracing = None                     # the Profiler spans record into, or None


def span(name):
    """A context recording span `name` into the tracing profiler; the
    shared no-op context while tracing is off."""
    prof = _tracing
    if prof is None:
        return _OFF
    return prof._open(name)


@contextlib.contextmanager
def tracing():
    """Turn span recording on for the block, into a new Profiler, which
    the block gets; the previous state is restored after it."""
    global _tracing
    prof = Profiler()
    prof._record_spans()
    before, _tracing = _tracing, prof
    try:
        yield prof
    finally:
        _tracing = before


class Profiler(object):
    """Timers (host seconds by name) and, while it is the tracing
    profiler, spans."""

    CAPACITY = 1 << 14      # spans the lists hold before they grow (doubling)

    def __init__(self):
        self.timers = {}
        self.num_spans = 0

    # -- timers ---------------------------------------------------------------
    @contextlib.contextmanager
    def timing(self, name):
        """Add the block's host seconds to ``timers[name]``."""
        t0 = clock_ns()
        try:
            yield
        finally:
            self.timers[name] = self.timers.get(name, 0.0) + (clock_ns() - t0) * 1e-9

    def format_times(self, sort_by="name"):
        items = sorted(self.timers.items(),
                       key=(lambda kv: kv[0]) if sort_by == "name" else (lambda kv: -kv[1]))
        return "\n".join("  %-40s %.3fs" % (k, v) for k, v in items)

    # -- spans ----------------------------------------------------------------
    def _record_spans(self):
        """Preallocate the span lists, for spans opened on this thread."""
        cap = self.CAPACITY
        self.span_names = []            # distinct span names, in order of first use
        self._name_index = {}
        self._name = [0] * cap
        self._start = [0] * cap
        self._end = [0] * cap
        self._parent = [-1] * cap
        self._request = [0] * cap
        self._stack = []
        self._requests = 0
        self._thread = threading.get_ident()

    def _open(self, name):
        if threading.get_ident() != self._thread:
            return _OFF
        i = self.num_spans
        if i == len(self._start):
            for lst, fill in ((self._name, 0), (self._start, 0), (self._end, 0),
                              (self._parent, -1), (self._request, 0)):
                lst.extend([fill] * i)
        k = self._name_index.get(name)
        if k is None:
            k = self._name_index[name] = len(self.span_names)
            self.span_names.append(name)
        parent = self._stack[-1] if self._stack else -1
        request = self._request[parent] if parent >= 0 else 0
        if name == 'fit' and request == 0:
            self._requests += 1
            request = self._requests
        self._name[i] = k
        self._parent[i] = parent
        self._request[i] = request
        self.num_spans = i + 1
        self._stack.append(i)
        self._start[i] = clock_ns()
        return self

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._end[self._stack.pop()] = clock_ns()
        return False

    def spans(self):
        """The recorded spans as lists of equal length, in order of
        opening: 'names' (the distinct names), 'name' (index into it),
        'start' and 'end' (clock_ns), 'parent' (index, -1 at the root),
        'request' (0 outside any fit)."""
        n = self.num_spans
        return {'names': list(self.span_names), 'name': self._name[:n],
                'start': self._start[:n], 'end': self._end[:n],
                'parent': self._parent[:n], 'request': self._request[:n]}
