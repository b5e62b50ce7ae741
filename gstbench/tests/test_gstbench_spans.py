"""The join of the program's spans with the device trace (spans.py) and the
readers of its metrics, on hand-made spans and device intervals, held to a
nanosecond-by-nanosecond count."""

import types

import numpy as np
import pytest

from gstbench import spans, spec
from gstbench.tests import checkout

IDLE_READERS = ['idle_protocol_ms', 'idle_lm_ms', 'idle_objective_ms', 'idle_tensors_ms',
                'idle_scan_ms', 'idle_outside_ms']
READERS = IDLE_READERS + ['evals_per_step', 'scan_launches_per_step']
assert READERS == list(spans.METRICS)


def make_spans(items):
    """The program's record of (name, start, end, parent) in order of opening."""
    names = []
    for n, *_ in items:
        if n not in names:
            names.append(n)
    return {'names': names, 'name': [names.index(n) for n, *_ in items],
            'start': [s for _, s, _, _ in items], 'end': [e for _, _, e, _ in items],
            'parent': [p for *_, p in items], 'request': [1] * len(items)}


def brute(sp, w0, w1, d_start, d_end):
    """Idle ns by name, one nanosecond at a time."""
    out = {}
    for t in range(w0, w1):
        if any(a <= t < b for a, b in zip(d_start, d_end)):
            continue
        inner = spans.OUTSIDE
        for i in range(len(sp['start'])):          # the last opened that holds t
            if sp['start'][i] <= t < sp['end'][i]:
                inner = sp['names'][sp['name'][i]]
        out[inner] = out.get(inner, 0) + 1
    return out


# fit [10, 100) > lm.run [20, 90) > lm.iteration [30, 60) > scan [35, 45);
# then objective.lsvec [62, 80) > scan [70, 78)
NESTED = make_spans([('fit', 10, 100, -1), ('lm.run', 20, 90, 0), ('lm.iteration', 30, 60, 1),
                     ('scan', 35, 45, 2), ('objective.lsvec', 62, 80, 1), ('scan', 70, 78, 4)])


def test_innermost_span_outside_and_gaps_across_boundaries():
    # device busy [0, 5), [40, 50) (across scan's end into lm.iteration),
    # [58, 64) (across lm.iteration's end, lm.run, into objective.lsvec), [95, 105)
    d_start, d_end = [0, 40, 58, 95], [5, 50, 64, 105]
    got = spans.join(NESTED, 0, 120, np.array(d_start), np.array(d_end))
    assert got['idle_ns'] == brute(NESTED, 0, 120, d_start, d_end) == {
        'outside': 5 + 15,                      # [5, 10), [105, 120)
        'fit': 10 + 5,                          # [10, 20), [90, 95)
        'lm.run': 10 + 10,                      # [20, 30), [80, 90); [60, 62) is busy
        'lm.iteration': 5 + 8,                  # [30, 35), [50, 58)
        'scan': 5 + 8,                          # [35, 40), [70, 78)
        'objective.lsvec': 6 + 2}               # [64, 70), [78, 80)
    assert sum(got['idle_ns'].values()) == got['idle_total_ns'] == 120 - 5 - 10 - 6 - 10


def test_idle_sums_to_the_window_less_the_union_to_the_nanosecond():
    rng = np.random.default_rng(2147483659)
    for trial in range(40):
        items, stack, t = [], [], 1000 + int(rng.integers(0, 50))
        for _ in range(int(rng.integers(0, 25))):
            while stack and rng.random() < 0.4:
                i = stack.pop()
                t += int(rng.integers(0, 20))
                items[i][2] = t
            t += int(rng.integers(0, 20))
            items.append([['fit', 'lm.run', 'scan', 'model.tensors'][int(rng.integers(0, 4))],
                          t, None, stack[-1] if stack else -1])
            stack.append(len(items) - 1)
        while stack:
            t += int(rng.integers(0, 20))
            items[stack.pop()][2] = t
        sp = make_spans([tuple(x) for x in items])
        w0, w1 = 990, t + 30
        n = int(rng.integers(0, 30))
        d_start = rng.integers(w0 - 40, w1 + 40, n)
        d_end = d_start + rng.integers(0, 60, n)
        got = spans.join(sp, w0, w1, d_start, d_end)
        busy = sum(1 for u in range(w0, w1) if any(a <= u < b for a, b in zip(d_start, d_end)))
        assert got['busy_ns'] == busy
        assert got['idle_total_ns'] == sum(got['idle_ns'].values()) == (w1 - w0) - busy
        assert got['idle_ns'] == brute(sp, w0, w1, d_start, d_end), trial


def test_launches_go_to_the_span_that_held_them():
    # launches at 5 (outside), 36 and 44 (scan), 59 (lm.iteration), 71 (the
    # second scan), 95 (fit), 130 (after the window: not counted), -1 (none)
    launch = np.array([5, 36, 44, 59, 71, 95, 130, -1])
    got = spans.join(NESTED, 0, 120, np.zeros(8, np.int64), np.zeros(8, np.int64), launch)
    assert got['launches'] == {'outside': 1, 'scan': 3, 'lm.iteration': 1, 'fit': 1}
    assert spans.join(NESTED, 0, 120, launch, launch)['launches'] is None


def test_launch_times_match_correlation_ids():
    # host events: corr 7 twice (the launch call first), corr 9, corr 0 (no id)
    got = spans.launch_times(np.array([9, 7, 8, 7]), np.array([50, 30, 20, 10]),
                             np.array([7, 9, 7, 0]))
    assert list(got) == [30, 20, -1, 20]


def test_merged_is_the_union_clipped_to_the_window():
    s, e = spans.merged([5, 0, 12, 30, 31], [10, 3, 20, 35, 32], 2, 33)
    assert list(s) == [2, 5, 12, 30] and list(e) == [3, 10, 20, 33]
    # unsorted, touching, empty and outside the window
    s, e = spans.merged([20, 10, 15, 40, 1], [30, 15, 15, 50, 2], 5, 38)
    assert list(s) == [10, 20] and list(e) == [15, 30]
    assert len(spans.merged([], [], 0, 10)[0]) == 0


class FakeEvent(object):
    def __init__(self, device, start, dur, corr):
        self.d, self.s, self.du, self.c = device, start, dur, corr

    def device_type(self):
        import torch
        return torch.autograd.DeviceType.CUDA if self.d else torch.autograd.DeviceType.CPU

    def start_ns(self):
        return self.s

    def duration_ns(self):
        return self.du

    def correlation_id(self):
        return self.c


class FakeSession(object):
    """A stopped torch.profiler session holding hand-made kineto events."""

    def __init__(self, events):
        res = type('R', (), {'events': lambda _: events})()
        self.profiler = type('P', (), {'kineto_results': res})()


def synthetic_record():
    # two LM iterations: the kernels launched at 36, 71, 95 (in scan, scan, fit)
    session = FakeSession([FakeEvent(True, 40, 10, 11), FakeEvent(False, 36, 2, 11),
                           FakeEvent(True, 72, 2, 12), FakeEvent(False, 71, 1, 12),
                           FakeEvent(True, 96, 9, 13), FakeEvent(False, 95, 1, 13),
                           FakeEvent(False, 3, 1, 0)])
    sp = spans.record(session, NESTED, 0, 120)
    return {'spans': sp, 'fits': [{'stages': [{'iterations': 2}]}]}


def test_record_and_readers_on_a_synthetic_trace():
    rec = synthetic_record()
    sp = rec['spans']
    assert sp['window_ns'] == [0, 120] and sp['count']['scan'] == 2
    assert sp['launch_lead_min_ns'] == 1 and sp['launches_outside_window'] == 0
    assert sp['launches'] == {'scan': 2, 'fit': 1}
    values = {m: spec.metric_reader(m + '.gst2q').read(rec) for m in READERS}
    idle = brute(NESTED, 0, 120, [40, 72, 96], [50, 74, 105])
    per = {k: v * 1e-6 / 2 for k, v in idle.items()}
    assert values['idle_protocol_ms'] == pytest.approx(per['fit'], rel=1e-12)
    assert values['idle_lm_ms'] == pytest.approx(per['lm.run'] + per['lm.iteration'], rel=1e-12)
    assert values['idle_objective_ms'] == pytest.approx(per['objective.lsvec'], rel=1e-12)
    assert values['idle_tensors_ms'] == 0
    assert values['idle_scan_ms'] == pytest.approx(per['scan'], rel=1e-12)
    assert values['idle_outside_ms'] == pytest.approx(per['outside'], rel=1e-12)
    # the six sum to the window's idle per iteration
    assert sum(values[m] for m in IDLE_READERS) == pytest.approx(
        (120 - 10 - 2 - 9) * 1e-6 / 2, rel=1e-12)
    assert values['evals_per_step'] == 0.5 and values['scan_launches_per_step'] == 1.0
    assert spans.idle_by_span(rec)[0] == ['outside', pytest.approx(25e-9)]
    assert 'spans: 6' in spans.describe(sp)


@pytest.mark.parametrize('name', READERS)
def test_readers_return_nothing_without_spans(name):
    reader = spec.metric_reader(name + '.cloud3q')
    fits = [{'stages': [{'iterations': 5}]}]
    assert reader.read({'fits': fits, 'trace': None}) is None
    assert reader.read({'fits': fits, 'trace': None, 'spans': None}) is None
    assert reader.read({'fits': [], 'spans': synthetic_record()['spans']}) is None


def test_device_time_stamped_before_its_launch_is_reported_not_moved():
    # the kernel of correlation id 11 reads 4 ns before its launch at 36
    session = FakeSession([FakeEvent(True, 32, 10, 11), FakeEvent(False, 36, 2, 11),
                           FakeEvent(True, 72, 2, 12), FakeEvent(False, 71, 1, 12)])
    sp = spans.record(session, NESTED, 0, 120)
    assert sp['launch_lead_min_ns'] == -4
    assert sp['idle_ns'] == brute(NESTED, 0, 120, [32, 72], [42, 74])
    assert 'least lead of an activity over its launch -4 ns' in spans.describe(sp)


def test_program_spans_switch():
    from pygsti_tpu_torch.baseobjs import profiler
    with spans.program_spans() as prog:
        assert prog is not None and profiler._tracing is prog
        with profiler.span('fit'):
            pass
    assert profiler._tracing is None and prog.num_spans == 1


def test_traced_run_refuses_a_run_without_spans(monkeypatch):
    """A run that never reaches the wrapped window, or records no span in
    it, is an error, not run.py's plain result."""
    from gstbench import trace, traffic
    monkeypatch.setattr(trace.DeviceTrace, 'start', lambda self: None)
    gen = types.SimpleNamespace(request=lambda k: {'stages': []},
                                device=types.SimpleNamespace(type='cpu'))

    def no_window(cell, seed, seconds, trace, device, t_start, log):
        return {'metrics': {}, 'breakdown': {}, 'checks': []}, []

    def empty_window(cell, seed, seconds, trace_, device, t_start, log):
        trace.DeviceTrace.start(None)
        traffic.timed_window(gen, 0.0)
        return no_window(cell, seed, seconds, trace_, device, t_start, log)

    cell = types.SimpleNamespace(name='tiny_cell')
    for run_cell in (no_window, empty_window):
        with pytest.raises(RuntimeError, match='recorded no span'):
            spans.traced_run(run_cell, cell, 1, 0.0, 'cpu', 0.0, log=lambda *a: None)


def test_a_traced_run_of_the_tiny_cell_on_the_cpu(tmp_path):
    """The tool's run on the CPU: the device trace stood in for by a
    CPU-activity profiler (no device activity), so the whole window is
    idle and charged to the spans and `outside`."""
    root = checkout.make(tmp_path)
    checkout.write_tiny_design(root)
    proc = checkout.run_python(root, """
import json, time, torch
from gstbench import run, spans, spec, trace
torch.cuda.synchronize = lambda *a, **k: None
class CPUTrace(trace.DeviceTrace):
    def __init__(self):
        self.prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])
        self.window_s = None
trace.DeviceTrace = CPUTrace
res, lines = spans.traced_run(run.run_cell, spec.Cell('tiny_cell', sys.path[0]), 2**31 + 23,
                              1.0, 'cpu', time.perf_counter(), log=lambda *a: None)
print(json.dumps(res))
""")
    res = checkout.last_json(proc)
    m = {k: v['value'] for k, v in res['metrics'].items()}
    assert res['correct'] is True and list(res)[-1] == 'checks'
    assert {k + '.gst2q' for k in IDLE_READERS + ['evals_per_step']} <= set(m)
    assert 'scan_launches_per_step.gst2q' not in m         # no device activity to charge
    iters = m['lm_iters.gst2q'] * res['attempted']
    idle_ms = sum(m[k + '.gst2q'] for k in IDLE_READERS) * iters
    assert idle_ms == pytest.approx(res['device']['window_s'] * 1e3, rel=1e-3)
    assert m['evals_per_step.gst2q'] >= 1
    assert {k for k, _ in res['breakdown']['idle_by_span']} <= {
        'fit', 'fit.layout', 'objective.build', 'lm.run', 'lm.iteration', 'objective.jtj_jtf',
        'objective.lsvec', 'model.tensors', 'scan', 'outside'}
