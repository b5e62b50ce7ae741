"""The check's control and its faults, at a size a test run holds: the
1-qubit tiny cell on the CPU.  The control (the plain reference in float32
in the program's place) has to fail a number; each fault planted under the
program (faults.py) has to make a run's `correct` false, with the rest of
the run driven as on the card (only the look for a card is skipped)."""


import pytest

from gstbench.tests import checkout


@pytest.fixture(scope='module')
def root(tmp_path_factory):
    r = checkout.make(tmp_path_factory.mktemp('control'))
    checkout.write_tiny_design(r)
    return r


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
def test_the_control_fails_and_the_program_passes_on_the_card(root, card):
    check_control(root, 'cuda')


def test_the_control_fails_and_the_program_passes(root):
    check_control(root, 'cpu')


def check_control(root, device):
    proc = checkout.run_python(root, """
import json
from gstbench import control, spec
cell = spec.Cell('tiny_cell', sys.path[0])
rows, summary = control.readings(cell, [11, 2**31 + 5, 4294967296], %r, log=lambda l: None)
print(json.dumps(dict(summary, limits=cell.limits)))
""" % device)
    s = checkout.last_json(proc)
    lim = s['limits']
    # the harness's own comparison: the program passes on every seed, the control fails
    assert s['program_correct'] == [True] * 3, s
    assert s['control_correct'] == [False] * 3, s
    assert all(s['program_max'][k] <= lim[k] for k in lim), s
    failed = [k for k in ('prob_gap', 'value_gap', 'grad_gap') if s['control_min'][k] > lim[k]]
    assert failed, s
    # the decrement's upper end: a fit that leaves its state unchanged
    assert s['start_decrement_min'] > lim['decrement']


@pytest.mark.parametrize('fault', [None, 'unchanged', 'half', 'altered'])
def test_each_fault_makes_the_run_incorrect(root, fault):
    proc = checkout.run_python(root, """
import contextlib, json, time
from gstbench import faults, run, spec
cell = spec.Cell('tiny_cell', sys.path[0])
fault = %r
with faults.planted(fault) if fault else contextlib.nullcontext():
    res, lines = run.run_cell(cell, 2**31 + 9, 0.5, False, 'cpu', time.perf_counter(),
                              log=lambda *a: None)
print(json.dumps(res))
""" % (fault,))
    res = checkout.last_json(proc)
    assert res['correct'] is (fault is None), res['checks']
    assert list(res)[-1] == 'checks'
    if fault is not None:
        assert res['failed'] >= 1
    if fault == 'altered':
        # the fit reports the value at its altered vector: only the decrement catches it
        checks = res['checks']
        assert checks['value_gap']['value'] <= checks['value_gap']['limit'], checks
        assert checks['decrement']['value'] > checks['decrement']['limit'], checks
