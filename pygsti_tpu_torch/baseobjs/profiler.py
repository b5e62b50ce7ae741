"""Profiler: named time and count accumulators on the host's clock
(counterpart of pygsti_tpu/baseobjs/profiler.py, trimmed to what the
iterative GST loop and the protocol call).  Device work is asynchronous: a
timed block that must include the card's work ends in a read of its result
or a ``synchronize()``, as the LM loop's does."""

from __future__ import annotations

import contextlib
import time


class Profiler(object):
    """Named accumulators for timing and counts."""

    def __init__(self):
        self.timers = {}
        self.counters = {}

    def add_time(self, name, start_time):
        self.timers[name] = self.timers.get(name, 0.0) + (time.time() - start_time)

    @contextlib.contextmanager
    def timing(self, name):
        t0 = time.time()
        try:
            yield
        finally:
            self.add_time(name, t0)

    def add_count(self, name, inc=1):
        self.counters[name] = self.counters.get(name, 0) + inc

    def format_times(self, sort_by="name"):
        items = sorted(self.timers.items(),
                       key=(lambda kv: kv[0]) if sort_by == "name" else (lambda kv: -kv[1]))
        return "\n".join("  %-40s %.3fs" % (k, v) for k, v in items)


class DummyProfiler(object):
    """No-op profiler."""

    def add_time(self, name, start_time):
        pass

    def add_count(self, name, inc=1):
        pass

    @contextlib.contextmanager
    def timing(self, name):
        yield
