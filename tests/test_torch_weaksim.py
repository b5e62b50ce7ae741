"""The weak (shot-sampling) simulator and CHP program text in the port
against the JAX package: the cases of tests/test_weaksim.py, each held to
the JAX package's values (the same shots from RandomState(base_seed +
shot), so frequencies are equal; CHP text equal line for line)."""

import numpy as np
import pytest

from pygsti_tpu.circuits import Circuit as JCircuit
from pygsti_tpu.forwardsims import weakforwardsim as jw
from pygsti_tpu.processors.processorspec import QubitProcessorSpec as JQPS

from pygsti_tpu_torch.circuits.circuit import Circuit as TCircuit
from pygsti_tpu_torch.forwardsims import weakforwardsim as tw
from pygsti_tpu_torch.processors.processorspec import QubitProcessorSpec as TQPS

GATES = ['Gh', 'Gp', 'Gxpi2', 'Gcnot']
CASES = [([('Gh', 0), ('Gcnot', 0, 1)], 400, 0),
         ([('Gxpi2', 0), ('Gxpi2', 0)], 50, 1),
         ([('Gh', 0), ('Gp', 0), ('Gh', 1), ('Gcnot', 1, 0), ('Gxpi2', 1)], 300, 2)]


@pytest.fixture(scope='module')
def pspecs():
    return JQPS(2, GATES, geometry='line'), TQPS(2, GATES, geometry='line')


@pytest.mark.parametrize('layers,shots,seed', CASES)
def test_sampled_frequencies_equal(pspecs, layers, shots, seed):
    jp, tp = pspecs
    a = jw.CHPForwardSimulator(shots=shots, pspec=jp, base_seed=seed).probs(JCircuit(layers, (0, 1)))
    b = tw.CHPForwardSimulator(shots=shots, pspec=tp, base_seed=seed).probs(TCircuit(layers, (0, 1)))
    assert list(a.items()) == list(b.items())
    keep = [list(b.keys())[0]]
    assert list(tw.CHPForwardSimulator(shots=shots, pspec=tp, base_seed=seed).probs(
        TCircuit(layers, (0, 1)), outcomes=keep).keys()) == keep


def test_bell_state_and_deterministic_circuits(pspecs):
    _, tp = pspecs
    p = tw.CHPForwardSimulator(shots=4000, pspec=tp, base_seed=0).probs(
        TCircuit([('Gh', 0), ('Gcnot', 0, 1)], (0, 1)))
    assert abs(p[('00',)] - 0.5) < 0.03 and abs(p[('11',)] - 0.5) < 0.03
    assert ('01',) not in p and ('10',) not in p
    sim = tw.CHPForwardSimulator(shots=50, pspec=tp, base_seed=1)
    assert sim.probs(TCircuit([('Gxpi2', 0), ('Gxpi2', 0)], (0, 1)))[('10',)] == 1.0
    bulk = sim.bulk_probs([TCircuit([('Gxpi2', 1), ('Gxpi2', 1)], (0, 1))], clip_to=(0, 0.5))
    assert list(bulk.values())[0][('01',)] == 0.5


@pytest.mark.parametrize('layers', [c[0] for c in CASES])
def test_chp_program_text_equal(pspecs, layers):
    jp, tp = pspecs
    a = jw.circuit_to_chp_program(JCircuit(layers, (0, 1)), jp)
    b = tw.CHPForwardSimulator(pspec=tp).to_chp_program(TCircuit(layers, (0, 1)))
    assert a == b
    ops = [l.split()[0] for l in b.splitlines() if l and not l.startswith('#')]
    assert set(ops) <= {'h', 'p', 'c', 'm'} and ops[-2:] == ['m', 'm']


def test_non_clifford_gate_refused():
    tp = TQPS(1, ['Gxpi2'])
    with pytest.raises(ValueError, match='Non-Clifford'):
        tw.circuit_to_chp_program(TCircuit([('Gzr', 0)], (0,)), tp)
