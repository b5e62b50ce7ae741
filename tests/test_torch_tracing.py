"""The port's spans (baseobjs/profiler.py): off they record nothing and cost
one global check; on, a 1-qubit GateSetTomography.run and a
run_gst_fit_simple each give one well-nested tree of spans under one
`fit`, with one `lm.iteration` per LM iteration and one `objective.lsvec`
per residual evaluation of the LM, and no span touches the device."""

import sys

import numpy as np
import pytest
import torch

import pygsti_tpu_torch.modelpacks.smq1Q_XYI as mp
from pygsti_tpu_torch.algorithms.core import run_gst_fit_simple
from pygsti_tpu_torch.baseobjs import profiler
from pygsti_tpu_torch.baseobjs.profiler import Profiler, span, tracing
from pygsti_tpu_torch.circuits.gstcircuits import create_lsgst_circuit_lists
from pygsti_tpu_torch.data.datasetconstruction import simulate_data
from pygsti_tpu_torch.objectivefns.objectivefns import ObjectiveFunctionBuilder
from pygsti_tpu_torch.optimize import device_lm
from pygsti_tpu_torch.protocols import gst
from pygsti_tpu_torch.protocols.protocol import ProtocolData

# the nine spans of the fit path
SPANS = {'fit', 'fit.layout', 'objective.build', 'lm.run', 'lm.iteration',
         'objective.jtj_jtf', 'objective.lsvec', 'model.tensors', 'scan'}


@pytest.fixture(scope='module')
def design():
    target = mp.target_model('full TP')
    lists = create_lsgst_circuit_lists(target, mp.prep_fiducials(), mp.meas_fiducials(),
                                       mp.germs(), [1, 2])
    truth = target.copy().depolarize(op_noise=0.05, spam_noise=0.02)
    ds = simulate_data(truth, list(lists[-1]), 1000, seed=7, device="cpu")
    return target, lists, ds


@pytest.fixture
def no_device_work(monkeypatch):
    """Every call that would wait on, time or read the card raises."""
    def refuse(*a, **k):
        raise AssertionError("a span touched the device")
    monkeypatch.setattr(torch.cuda, 'synchronize', refuse)
    monkeypatch.setattr(torch.cuda, 'Event', refuse)


@pytest.fixture
def lm_evaluations(monkeypatch):
    """Counts the residual evaluations the device LM asks for."""
    count = [0]
    make = device_lm.make_device_lm

    def counted(jtj_jtf_fn, lsvec_fn, *a, **k):
        def lsvec(x):
            count[0] += 1
            return lsvec_fn(x)
        return make(jtj_jtf_fn, lsvec, *a, **k)
    monkeypatch.setattr(device_lm, 'make_device_lm', counted)
    return count


def tree(rec):
    """(names per span, start, end, parent, request) as numpy arrays."""
    s = rec.spans()
    names = np.array([s['names'][k] for k in s['name']], dtype=object)
    return (names, np.array(s['start']), np.array(s['end']), np.array(s['parent']),
            np.array(s['request']))


def check_tree(rec):
    """One fit, one request id, children inside their parents; returns the
    names per span."""
    names, start, end, parent, request = tree(rec)
    assert set(names) <= SPANS
    assert list(names).count('fit') == 1 and names[0] == 'fit' and parent[0] == -1
    assert (parent[1:] >= 0).all() and (parent[1:] < np.arange(1, len(names))).all()
    assert (request == request[0]).all() and request[0] > 0
    assert (end >= start).all()
    p = parent[1:]
    assert (start[1:] >= start[p]).all() and (end[1:] <= end[p]).all()
    # siblings do not overlap: spans are opened in order of start
    assert (np.diff(start) >= 0).all()
    return names


def test_off_records_nothing_and_returns_the_shared_noop(monkeypatch):
    def no_clock():
        raise AssertionError("a span read the clock while tracing is off")
    assert profiler._tracing is None
    monkeypatch.setattr(profiler, 'clock_ns', no_clock)
    ctx = span('scan')
    assert ctx is span('fit') is profiler._OFF
    blocks = sys.getallocatedblocks()
    for _ in range(10000):
        with span('scan'):
            pass
    assert sys.getallocatedblocks() - blocks < 50


def test_tracing_switch_records_nested_spans_and_restores_off():
    with tracing() as rec:
        assert profiler._tracing is rec
        with span('fit'):
            with span('lm.run'):
                pass
            with span('scan'):
                pass
        with span('fit'):
            pass
    assert profiler._tracing is None
    names, start, end, parent, request = tree(rec)
    assert list(names) == ['fit', 'lm.run', 'scan', 'fit']
    assert list(parent) == [-1, 0, 0, -1] and list(request) == [1, 1, 1, 2]
    assert rec.num_spans == 4 and (end >= start).all()
    with span('fit'):                     # off again: nothing more
        pass
    assert rec.num_spans == 4


def test_spans_grow_past_their_capacity():
    with tracing() as rec:
        for _ in range(Profiler.CAPACITY + 3):
            with span('scan'):
                pass
    assert rec.num_spans == Profiler.CAPACITY + 3
    assert len(rec.spans()['start']) == Profiler.CAPACITY + 3


def test_timer_and_span_share_their_clock_readings(monkeypatch):
    """Timers and spans read the one clock, clock_ns: a timer around a
    span reads the span's readings and its own, nothing else."""
    ticks = iter(range(100, 200))
    monkeypatch.setattr(profiler, 'clock_ns', lambda: next(ticks))
    prof = Profiler()
    assert prof.num_spans == 0 and not hasattr(prof, '_start')   # a plain Profiler: timers only
    with tracing() as rec:
        with prof.timing('iteration 0: chi2 optimize'):
            with span('lm.run'):
                pass
        with prof.timing('checkpoint writes'):
            pass
    names, start, end, _, _ = tree(rec)
    assert list(names) == ['lm.run'] and (start[0], end[0]) == (101, 102)
    assert prof.timers == {'iteration 0: chi2 optimize': 3 * 1e-9, 'checkpoint writes': 1 * 1e-9}


def test_spans_on_other_threads_are_not_recorded():
    import threading
    with tracing() as rec:
        t = threading.Thread(target=lambda: span('scan').__enter__())
        t.start()
        t.join(10)
        assert not t.is_alive()
    assert rec.num_spans == 0


def test_gst_run_spans(design, no_device_work, lm_evaluations):
    target, lists, ds = design
    data = ProtocolData(gst.GateSetTomographyDesign(target, lists), ds)

    def run():
        return gst.GateSetTomography(gst.GSTInitialModel(model=target.copy()),
                                     gaugeopt_suite=None, verbosity=0, device="cpu") \
            .run(data, disable_checkpointing=True)

    plain = run().estimates['GateSetTomography']
    evals_off = lm_evaluations[0]
    with tracing() as rec:
        est = run().estimates['GateSetTomography']
    names = check_tree(rec)
    assert set(names) == SPANS
    iters = sum(r.optimizer_specific_qtys['iterations']
                for rs in est.parameters['optimizer_results'] for r in rs)
    stages = sum(len(rs) for rs in est.parameters['optimizer_results'])
    assert list(names).count('lm.iteration') == iters
    assert list(names).count('objective.lsvec') == lm_evaluations[0] - evals_off
    assert list(names).count('objective.jtj_jtf') == iters
    assert list(names).count('objective.build') == list(names).count('lm.run') == stages
    assert list(names).count('fit.layout') == 1
    # the timers: the same keys with tracing on and off
    assert sorted(est.parameters['profiler']) == sorted(plain.parameters['profiler']) == sorted(
        ['iteration %d: %s %s' % (i, b, what) for i in range(len(lists))
         for b in (['chi2'] + (['logl'] if i == len(lists) - 1 else []))
         for what in ('objective build', 'optimize')] + ['gauge optimization + badfit'])
    # each stage's build span lies inside its timer
    _, start, end, _, _ = tree(rec)
    built = [(e - s) * 1e-9 for n, s, e in zip(names, start, end) if n == 'objective.build']
    timed = [v for k, v in est.parameters['profiler'].items() if k.endswith('objective build')]
    assert len(built) == len(timed)
    assert all(b <= t for b, t in zip(sorted(built), sorted(timed)))


def test_gst_fit_simple_spans(design, no_device_work, lm_evaluations):
    target, lists, ds = design
    model = target.copy()
    with tracing() as rec:
        result, _ = run_gst_fit_simple(ds, model, lists[-1], {'maxiter': 30},
                                       ObjectiveFunctionBuilder('chi2'), device="cpu")
    names = check_tree(rec)
    assert set(names) == SPANS - {'fit.layout'}
    assert list(names).count('lm.iteration') == result.optimizer_specific_qtys['iterations']
    assert list(names).count('objective.lsvec') == lm_evaluations[0]
    # one span per scan (the F stash per bucket, the residual's propagate), not per layer
    lsvec = list(names).count('objective.lsvec')
    assert list(names).count('scan') < (lsvec + list(names).count('objective.jtj_jtf')) * 8
