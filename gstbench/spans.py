"""The join of the program's spans with the device trace of a traced
run's window, and the tool that makes such a run:

    python3 gstbench/spans.py --workload <name> --seed <n> --seconds <s>

runs one `--trace 1` run of the cell through run.py's `run_cell` with the
program's tracing switch (pygsti_tpu_torch's `baseobjs.profiler.tracing`)
on for exactly the window, so the program records its spans at the layer
boundaries of the fit path (name, start and end ns, parent) on the clock
the device trace's events are stamped on.  Joined with that trace:

- idle: the window minus the union of the device activities; each idle
  nanosecond is charged to the innermost span open on the host at that
  instant, or to `outside` (the client: the resample and its DataSet) where
  none is.  The charges sum to the window's idle time exactly.
- launches: each device activity is charged to the innermost span open when
  the host launched it: the time of the CUDA runtime call with the same
  correlation id (recorded by the CUDA-only profiler as a host event).

The record keeps the least lead of a device activity over its launch: a
negative lead is device time stamped before its launch, a clock the join
does not correct.

The result line is run.py's, with METRICS (read by their readers under
metrics/, '<metric>.<the cell's suffix>') and `breakdown.idle_by_span`
added.  run.py itself does not turn the spans on: a `--trace 1` run of it
reads what it read before.
"""

from __future__ import annotations

import contextlib
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from gstbench.arith import union_and_gaps  # noqa: E402

OUTSIDE = 'outside'
clock_ns = time.time_ns              # the program's span clock (profiler.clock_ns)
# the metrics of the join, and their units
METRICS = {'idle_protocol_ms': 'ms', 'idle_lm_ms': 'ms', 'idle_objective_ms': 'ms',
           'idle_tensors_ms': 'ms', 'idle_scan_ms': 'ms', 'idle_outside_ms': 'ms',
           'evals_per_step': 'evaluations', 'scan_launches_per_step': 'launches'}


@contextlib.contextmanager
def program_spans():
    """The program's spans over the block: yields its recording profiler."""
    from pygsti_tpu_torch.baseobjs.profiler import tracing
    with tracing() as prof:
        yield prof


def trace_events(prof):
    """(device start [n], device end [n], launch time [n] or -1) of every
    device activity of a torch.profiler session `prof`, in ns, sorted by
    start; the launch time is the start of the host runtime event that
    shares the activity's correlation id."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    d_start, d_dur, d_corr, h_start, h_corr = [], [], [], [], []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cuda:
            d_start.append(e.start_ns())
            d_dur.append(e.duration_ns())
            d_corr.append(e.correlation_id())
        else:
            h_start.append(e.start_ns())
            h_corr.append(e.correlation_id())
    start = np.asarray(d_start, dtype=np.int64)
    end = start + np.maximum(np.asarray(d_dur, dtype=np.int64), 0)
    launch = launch_times(np.asarray(d_corr, dtype=np.int64),
                          np.asarray(h_start, dtype=np.int64),
                          np.asarray(h_corr, dtype=np.int64))
    order = np.argsort(start, kind='stable')
    return start[order], end[order], launch[order]


def launch_times(d_corr, h_start, h_corr):
    """Per device activity, the start of the host event of its correlation
    id (the earliest, where several share it), or -1."""
    out = np.full(len(d_corr), -1, dtype=np.int64)
    keep = h_corr > 0
    if not keep.any() or not len(d_corr):
        return out
    hc, hs = h_corr[keep], h_start[keep]
    order = np.lexsort((hs, hc))
    hc, hs = hc[order], hs[order]
    first = np.r_[True, hc[1:] != hc[:-1]]
    hc, hs = hc[first], hs[first]
    pos = np.clip(np.searchsorted(hc, d_corr), 0, len(hc) - 1)
    hit = hc[pos] == d_corr
    out[hit] = hs[pos[hit]]
    return out


def innermost(spans, w0, w1):
    """(segment starts [m + 1], span index per segment [m]) partitioning
    [w0, w1) by the innermost span open, -1 where none is.  `spans` is the
    program's record (profiler.Profiler.spans()): properly nested, in
    order of opening."""
    start, end = spans['start'], spans['end']
    bounds, ids = [w0], []
    stack = []

    def emit(until, i):
        until = min(max(until, w0), w1)
        if until > bounds[-1]:
            bounds.append(until)
            ids.append(i)

    for i in range(len(start)):
        s = start[i]
        while stack and end[stack[-1]] <= s:
            top = stack.pop()
            emit(end[top], top)
        emit(s, stack[-1] if stack else -1)
        stack.append(i)
    while stack:
        top = stack.pop()
        emit(end[top], top)
    emit(w1, -1)
    return np.asarray(bounds, dtype=np.int64), np.asarray(ids, dtype=np.int64)


def merged(start, end, w0, w1):
    """The union of intervals [start, end) clipped to [w0, w1), as sorted
    disjoint (starts, ends)."""
    s = np.clip(np.asarray(start, dtype=np.int64), w0, w1)
    e = np.clip(np.asarray(end, dtype=np.int64), w0, w1)
    keep = e > s
    order = np.argsort(s[keep], kind='stable')
    s, e = s[keep][order], e[keep][order]
    if not len(s):
        return s, e
    busy, gaps, after = union_and_gaps(s, e)
    us = s[np.r_[0, after]]
    return us, np.r_[us[1:] - gaps, s[0] + busy + gaps.sum()]


def busy_before(us, ue, t):
    """The busy ns of the union (us, ue) before each time in `t`."""
    if not len(us):
        return np.zeros(len(t), dtype=np.int64)
    cum = np.r_[0, np.cumsum(ue - us)]
    k = np.searchsorted(us, t, side='right') - 1
    kk = np.clip(k, 0, len(us) - 1)
    part = np.clip(t - us[kk], 0, ue[kk] - us[kk])
    return np.where(k >= 0, cum[kk] + part, 0)


def join(spans, w0, w1, d_start, d_end, launch=None):
    """Idle ns and launches of the window [w0, w1) by span name.

    Returns {'idle_ns': {name: ns}, 'launches': {name: count}, 'idle_total_ns',
    'busy_ns'}; `outside` holds what no span covers.  With `launch` None
    (no host runtime events) 'launches' is None."""
    names = spans['names']
    name_of = np.asarray(spans['name'], dtype=np.int64)
    bounds, ids = innermost(spans, w0, w1)
    us, ue = merged(d_start, d_end, w0, w1)
    c = busy_before(us, ue, bounds)
    idle_seg = np.diff(bounds) - np.diff(c)
    labels = np.full(len(ids), len(names), dtype=np.int64)
    labels[ids >= 0] = name_of[ids[ids >= 0]]
    idle = np.zeros(len(names) + 1, dtype=np.int64)
    np.add.at(idle, labels, idle_seg)
    out_names = list(names) + [OUTSIDE]
    result = {'idle_ns': {n: int(v) for n, v in zip(out_names, idle) if v},
              'idle_total_ns': int(w1 - w0 - (ue - us).sum()),
              'busy_ns': int((ue - us).sum()), 'launches': None}
    if launch is not None:
        lt = np.asarray(launch, dtype=np.int64)
        lt = lt[(lt >= w0) & (lt < w1)]
        seg = np.searchsorted(bounds, lt, side='right') - 1
        lab = labels[np.clip(seg, 0, len(labels) - 1)]
        cnt = np.bincount(lab, minlength=len(names) + 1)
        result['launches'] = {n: int(v) for n, v in zip(out_names, cnt) if v}
    return result


def record(prof, spans, w0, w1):
    """What a run's record keeps of its spans: the spans, the window's
    bounds on their clock, and their join with the device trace `prof`
    (a stopped torch.profiler session over the same window)."""
    d_start, d_end, launch = trace_events(prof)
    matched = launch >= 0
    # the clocks' agreement: no activity starts on the card before the host
    # launched it, and every launch lies in the window
    lead = d_start[matched] - launch[matched]
    joined = join(spans, w0, w1, d_start, d_end, launch if matched.any() else None)
    counts = np.bincount(np.asarray(spans['name'], dtype=np.int64),
                         minlength=len(spans['names']))
    return dict(spans, window_ns=[int(w0), int(w1)],
                count={n: int(c) for n, c in zip(spans['names'], counts)},
                launch_lead_min_ns=int(lead.min()) if len(lead) else None,
                launches_outside_window=int(np.sum((launch[matched] < w0)
                                                   | (launch[matched] >= w1))), **joined)


def describe(sp):
    """One log line of a run's join."""
    return ("spans: %d (%s); idle %.3f s by span, busy %.3f s; launches matched %s, "
            "the least lead of an activity over its launch %s ns, launches outside the "
            "window %d"
            % (len(sp['start']), ', '.join('%s %d' % kv for kv in sp['count'].items()),
               sp['idle_total_ns'] * 1e-9, sp['busy_ns'] * 1e-9,
               None if sp['launches'] is None else sum(sp['launches'].values()),
               sp['launch_lead_min_ns'], sp['launches_outside_window']))


def idle_by_span(rec, top=10):
    """[[span name, idle seconds], ...] of the `top` names by idle time."""
    idle = rec['spans']['idle_ns']
    return [[k, v * 1e-9] for k, v in sorted(idle.items(), key=lambda kv: -kv[1])[:top]]


def iterations(rec):
    return sum(s['iterations'] for f in rec['fits'] for s in f['stages'])


def idle_ms_per_step(rec, names):
    """Card-idle ms per LM iteration charged to spans `names`, or None
    without spans."""
    sp = rec.get('spans')
    iters = iterations(rec)
    if not sp or not iters:
        return None
    return 1e-6 * sum(sp['idle_ns'].get(n, 0) for n in names) / iters


def traced_run(run_cell, cell, seed, seconds, device, t_start, log=None):
    """`run_cell` (run.py's) traced, with the program's spans on for its
    window and joined with its device trace; returns (result, check lines)
    with METRICS and `breakdown.idle_by_span` added.  For the call it wraps
    DeviceTrace.start and .stop (the window's first instant on the spans'
    clock; the stopped session) and traffic.timed_window (the spans).
    Raises where the run opened no window or recorded no span."""
    from gstbench import spec, trace, traffic
    log = log or (lambda *a: print(*a, file=sys.stderr, flush=True))
    got = {}
    start, stop, window = trace.DeviceTrace.start, trace.DeviceTrace.stop, traffic.timed_window

    def start_(tr):
        start(tr)
        got['w0'] = clock_ns()

    def stop_(tr):
        stop(tr)
        got['trace'] = tr

    def window_(gen, secs):
        with program_spans() as prog:
            recs, window_s = window(gen, secs)
        got['prog'] = prog
        got['fits'] = [{'stages': r['stages']} for r in recs]
        return recs, window_s

    trace.DeviceTrace.start, trace.DeviceTrace.stop, traffic.timed_window = start_, stop_, window_
    try:
        result, lines = run_cell(cell, seed, seconds, True, device, t_start, log)
    finally:
        trace.DeviceTrace.start, trace.DeviceTrace.stop, traffic.timed_window = start, stop, window
    if 'w0' not in got or 'prog' not in got or not got['prog'].num_spans:
        raise RuntimeError("the traced run of %s opened no window with the program's spans "
                           "on, or recorded no span in it" % cell.name)
    tr = got.pop('trace')
    t0 = time.perf_counter()
    sp = record(tr.prof, got['prog'].spans(), got['w0'],
                got['w0'] + round(tr.window_s * 1e9))
    del tr
    log("spans joined in %.1f s; %s" % (time.perf_counter() - t0, describe(sp)))
    rec = {'fits': got['fits'], 'spans': sp}
    suffix = next(m['name'].split('.', 1)[1] for m, _ in cell.metrics('per_layer')
                  if '.' in m['name'])
    for name, unit in METRICS.items():
        v = spec.metric_reader(name, cell.bench_dir).read(rec)
        if v is not None:
            result['metrics']['%s.%s' % (name, suffix)] = {'value': float(v), 'unit': unit}
    result['breakdown']['idle_by_span'] = idle_by_span(rec)
    result['checks'] = result.pop('checks')          # the result's last key, as run.py's
    return result, lines


def main(argv=None):
    """run.py's main, its run traced with the program's spans."""
    from gstbench import run
    inner = run.run_cell

    def run_cell(cell, seed, seconds, trace, device, t_start, log=None):
        return traced_run(inner, cell, seed, seconds, device, t_start, log)

    run.run_cell = run_cell
    try:
        return run.main(list(sys.argv[1:] if argv is None else argv) + ['--trace', '1'])
    finally:
        run.run_cell = inner


if __name__ == '__main__':
    sys.exit(main())
