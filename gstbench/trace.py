"""The device trace of a run's window: torch.profiler with CUDA activity
only (no CPU ops recorded, so the host is not slowed by recording them),
read straight from the profiler's raw events.

`summary` reduces the events to what the per-layer metrics read: the
count of device activities (kernels, copies, fills), the union of their
intervals (busy seconds), the device time of the kernel `bwd_*` launches,
and the breakdown (the device operations that took most time, and the
idle gaps summed by the operation the device then waited for).
"""

from __future__ import annotations

import re
import time

import numpy as np
import torch

from gstbench.arith import union_and_gaps

KERNEL = re.compile(r'\bbwd_\w*kernel')


def short_name(name):
    """A device operation's name without 'void ' and its argument list."""
    if name.startswith('void '):
        name = name[5:]
    depth = 0
    for i, ch in enumerate(name):
        if ch == '<':
            depth += 1
        elif ch == '>':
            depth -= 1
        elif ch == '(' and depth == 0 and i > 0:
            name = name[:i]
            break
    return name[:80].strip() or '(unnamed)'


class DeviceTrace(object):
    def __init__(self):
        self.prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])
        self.window_s = None

    def start(self):
        torch.cuda.synchronize()
        self.prof.start()
        self.t0 = time.perf_counter()

    def stop(self):
        torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self.t0
        self.prof.stop()

    def events(self):
        """(names, name index [n], start ns [n], end ns [n]) of every device
        activity, sorted by start."""
        cuda = torch.autograd.DeviceType.CUDA
        index, names, code, start, dur = {}, [], [], [], []
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() != cuda:
                continue
            n = e.name()
            i = index.get(n)
            if i is None:
                i = index[n] = len(names)
                names.append(n)
            code.append(i)
            start.append(e.start_ns())
            dur.append(e.duration_ns())
        start = np.asarray(start, dtype=np.int64)
        order = np.argsort(start, kind='stable')
        end = start + np.asarray(dur, dtype=np.int64)
        return names, np.asarray(code, dtype=np.int64)[order], start[order], end[order]


def summary(events, window_s):
    names, code, start, end = events
    busy, gaps, after = union_and_gaps(start, end)
    busy = int(busy)
    dur = (end - start).astype(np.float64) * 1e-9
    per_name = np.bincount(code, weights=dur, minlength=len(names)) if len(code) else \
        np.zeros(len(names))
    kern = np.array([bool(KERNEL.search(n)) for n in names], dtype=bool)
    by_op, by_gap = {}, {}
    for i, n in enumerate(names):
        k = short_name(n)
        by_op[k] = by_op.get(k, 0.0) + float(per_name[i])
    gap_by_name = np.bincount(code[after], weights=gaps.astype(np.float64) * 1e-9,
                              minlength=len(names)) if len(gaps) else np.zeros(len(names))
    for i, n in enumerate(names):
        if gap_by_name[i] > 0:
            k = 'host before ' + short_name(n)
            by_gap[k] = by_gap.get(k, 0.0) + float(gap_by_name[i])

    def top(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]

    return {'window_s': window_s, 'events': int(len(code)), 'busy_s': busy * 1e-9,
            'kernel_s': float(per_name[kern].sum()) if len(names) else 0.0,
            'device_ops': top(by_op), 'idle_gaps': top(by_gap)}
