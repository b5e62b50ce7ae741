"""The state-vector simulator in the port against the JAX package's and
against the port's superoperator simulator, on unitary models made by
create_explicit_model and by the expression constructors; a model that is
not unitary raises the JAX package's ValueError."""

import numpy as np
import pytest

from pygsti_tpu.circuits import Circuit as JCircuit
from pygsti_tpu.forwardsims.statevecsim import StateVectorForwardSimulator as JSV
from pygsti_tpu.models import modelconstruction as jmc
from pygsti_tpu.processors import QubitProcessorSpec as JSpec

from pygsti_tpu_torch.circuits.circuit import Circuit
from pygsti_tpu_torch.forwardsims.forwardsim import SimpleForwardSimulator
from pygsti_tpu_torch.forwardsims.statevecsim import StateVectorForwardSimulator as TSV
from pygsti_tpu_torch.models import modelconstruction as tmc
from pygsti_tpu_torch.processors.processorspec import QubitProcessorSpec as TSpec

GATES = ['Gxpi2', 'Gypi2', 'Gcnot']


def _circuits(nq, n, seed, depth=7):
    rng = np.random.RandomState(seed)
    lines = '@(%s)' % ','.join(str(q) for q in range(nq))
    out = ['{}' + lines]
    for _ in range(n):
        layers = []
        for t in range(depth):
            if t % 3 == 2:
                c = rng.randint(nq - 1)
                layers.append('Gcnot:%d:%d' % (c, c + 1))
            else:
                layers.append('%s:%d' % (['Gxpi2', 'Gypi2'][rng.randint(2)], rng.randint(nq)))
        out.append(''.join(layers) + lines)
    return out


@pytest.mark.parametrize("nq", [2, 3])
def test_statevec_against_dense_and_jax(nq):
    """create_explicit_model(ideal_gate_type='static unitary'): the port's
    state-vector probabilities equal its superoperator simulator's and the
    JAX package's state-vector ones within 1e-12."""
    tm = tmc.create_explicit_model(TSpec(nq, GATES, geometry='line'),
                                   ideal_gate_type='static unitary')
    jm = jmc.create_explicit_model(JSpec(nq, GATES, geometry='line'),
                                   ideal_gate_type='static unitary')
    strs = _circuits(nq, 10, seed=nq)
    circuits = [Circuit(s) for s in strs]
    sv = TSV(tm, 'cpu')
    layout = sv.create_layout(circuits)
    p_sv = sv.bulk_fill_probs(None, layout)
    dense = SimpleForwardSimulator(tm, 'cpu')
    p_dense = dense.bulk_fill_probs(None, dense.create_layout(circuits))
    jsv = JSV(jm)
    p_jax = np.asarray(jsv.bulk_fill_probs(None, jsv.create_layout([JCircuit(s)
                                                                    for s in strs])))
    assert p_sv.shape == p_dense.shape == p_jax.shape == (len(strs) * 2 ** nq,)
    assert np.max(np.abs(p_sv - p_dense)) < 1e-12
    assert np.max(np.abs(p_sv - p_jax)) < 1e-12


def test_statevec_parallel_layers_and_full_unitary():
    """Composite layers and 'full unitary' members at parameters off the
    target: state-vector against superoperator probabilities, 1e-12."""
    tm = tmc.create_explicit_model(TSpec(2, GATES, geometry='line'),
                                   ideal_gate_type='full unitary')
    tm.from_vector(tm.to_vector() + 0.05 * np.random.RandomState(1).randn(tm.num_params))
    circuits = [Circuit(s) for s in ('[Gxpi2:0Gypi2:1]Gcnot:0:1@(0,1)',
                                     'Gxpi2:1[Gypi2:0Gxpi2:1]Gxpi2:0@(0,1)')]
    sv, dense = TSV(tm, 'cpu'), SimpleForwardSimulator(tm, 'cpu')
    p_sv = sv.bulk_fill_probs(None, sv.create_layout(circuits))
    p_dense = dense.bulk_fill_probs(None, dense.create_layout(circuits))
    assert np.max(np.abs(p_sv - p_dense)) < 1e-12
    assert abs(sum(sv.probs(circuits[0]).values()) - 1) < 1e-12


def test_statevec_expression_model():
    """A 'static unitary' model from expressions (the JAX package's own
    test's model): the same probabilities as the JAX package's state-vector
    simulator."""
    args = (['Q0', 'Q1'], ['Gii', 'Gxi', 'Gyi', 'Gcnot'],
            ["I(Q0):I(Q1)", "X(pi/2,Q0)", "Y(pi/2,Q0)", "CX(pi,Q0,Q1)"])
    jm = jmc.create_explicit_model_from_expressions(*args, gate_type='static unitary')
    tm = tmc.create_explicit_model_from_expressions(*args, gate_type='static unitary')
    strs = ['{}@(Q0,Q1)', 'Gxi@(Q0,Q1)', 'GxiGcnot@(Q0,Q1)', 'GyiGcnotGxi@(Q0,Q1)']
    jsv = JSV(jm)
    p_jax = np.asarray(jsv.bulk_fill_probs(None, jsv.create_layout([JCircuit(s)
                                                                    for s in strs])))
    sv = TSV(tm, 'cpu')
    p_sv = sv.bulk_fill_probs(None, sv.create_layout([Circuit(s) for s in strs]))
    assert np.max(np.abs(p_sv - p_jax)) < 1e-12


def test_non_unitary_model_raises_the_same_error():
    """A model with a member that has no unitary raises ValueError, with
    the JAX package's words."""
    tm = tmc.create_explicit_model(TSpec(2, GATES, geometry='line'), ideal_gate_type='full TP')
    jm = jmc.create_explicit_model(JSpec(2, GATES, geometry='line'), ideal_gate_type='full TP')
    s = 'Gxpi2:0@(0,1)'
    with pytest.raises(ValueError) as te:
        TSV(tm, 'cpu').probs(Circuit(s))
    with pytest.raises(ValueError) as je:
        jsv = JSV(jm)
        jsv.bulk_fill_probs(None, jsv.create_layout([JCircuit(s)]))
    assert str(te.value) == str(je.value)
