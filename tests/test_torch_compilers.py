"""The port's Clifford compilers against the JAX package's: for seeded
random Cliffords on 1-4 qubits, the compiled circuits are equal as strings
for the same rand_state, and each implements its target under
symplectic_rep_of_clifford_circuit."""

import numpy as np
import pytest

from pygsti_tpu.algorithms import compilers as jc
from pygsti_tpu.circuits.circuit import Circuit as JCircuit
from pygsti_tpu.processors.processorspec import QubitProcessorSpec as JQPS
from pygsti_tpu.tools import matrixmod2 as jm2

from pygsti_tpu_torch.algorithms import compilers as tc
from pygsti_tpu_torch.circuits.circuit import Circuit as TCircuit
from pygsti_tpu_torch.processors.processorspec import QubitProcessorSpec as TQPS
from pygsti_tpu_torch.tools import symplectic as tsym

GATES = {'cnot': ['Gxpi2', 'Gypi2', 'Gcnot'], 'cphase': ['Gh', 'Gp', 'Gcphase']}


def specs(n, gates='cnot'):
    return (JQPS(n, GATES[gates], geometry='line'), TQPS(n, GATES[gates], geometry='line'))


def clifford(n, seed):
    return tsym.random_clifford(n, rand_state=np.random.RandomState(seed))


def rep(circ):
    return tsym.symplectic_rep_of_clifford_circuit(circ)


@pytest.mark.parametrize("gates", ['cnot', 'cphase'])
@pytest.mark.parametrize("algorithm", ['ROGGE', 'BGGE'])
@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_compile_clifford(n, algorithm, gates):
    """compile_clifford: equal strings, exact (s, p); with Pauli-frame
    randomization and with the phase fix prepended too."""
    jp, tp = specs(n, gates)
    for seed in range(3):
        s, p = clifford(n, seed)
        for opts in ({}, {'paulirandomize': True}, {'prefixpaulis': True}):
            a = jc.compile_clifford(s, p, jp, algorithm=algorithm, iterations=6,
                                    rand_state=np.random.RandomState(seed + 10), **opts)
            b = tc.compile_clifford(s, p, tp, algorithm=algorithm, iterations=6,
                                    rand_state=np.random.RandomState(seed + 10), **opts)
            assert a.str == b.str
            sc, pc = rep(b)
            assert np.array_equal(sc, s) and np.array_equal(pc % 4, p % 4)


@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_compile_clifford_without_processor(n):
    """Without a processor: over the internal H/P/CNOT gates."""
    for seed in range(2):
        s, p = clifford(n, seed)
        a = jc.compile_clifford(s, p, rand_state=np.random.RandomState(seed))
        b = tc.compile_clifford(s, p, rand_state=np.random.RandomState(seed))
        assert a.str == b.str
        assert np.array_equal(rep(b)[0], s)


@pytest.mark.parametrize("opts", [{'algorithms': ['ROGGE']}, {'algorithms': ['BGGE']},
                                  {'algorithms': ['BGGE', 'ROGGE'], 'paulirandomize': True},
                                  {'costfunction': 'depth'}, {'costfunction': '2QGC'}])
@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_compile_symplectic(n, opts):
    """compile_symplectic: equal strings, the target symplectic matrix."""
    jp, tp = specs(n)
    for seed in range(3):
        s, _ = clifford(n, seed)
        a = jc.compile_symplectic(s, jp, iterations=5, rand_state=np.random.RandomState(seed),
                                  **opts)
        b = tc.compile_symplectic(s, tp, iterations=5, rand_state=np.random.RandomState(seed),
                                  **opts)
        assert a.str == b.str
        assert np.array_equal(rep(b)[0], s)


@pytest.mark.parametrize("native", [False, True])
@pytest.mark.parametrize("algorithm", ['ROCAGE', 'BGE'])
@pytest.mark.parametrize("n", [2, 3, 4])
def test_compile_cnot_circuit(n, algorithm, native):
    """compile_cnot_circuit on random invertible GF(2) matrices, given as
    the matrix and as the symplectic rep of a CNOT circuit."""
    jp, tp = specs(n)
    for seed in range(3):
        M = jm2.random_invertible_matrix(n, rand_state=np.random.RandomState(seed))
        s = np.zeros((2 * n, 2 * n), np.int64)
        s[:n, :n] = M
        s[n:, n:] = jm2.inv_mod2(M).T        # a CNOT circuit's Z block
        for given in (M, s):
            a = jc.compile_cnot_circuit(given, jp, algorithm=algorithm,
                                        compile_to_native=native,
                                        rand_state=np.random.RandomState(seed))
            b = tc.compile_cnot_circuit(given, tp, algorithm=algorithm,
                                        compile_to_native=native,
                                        rand_state=np.random.RandomState(seed))
            assert a.str == b.str
            assert np.array_equal(rep(b)[0][:n, :n] % 2, M)


@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_stabilizer_compilations(n):
    """compile_stabilizer_state implements (s, p) and
    compile_stabilizer_measurement its inverse; compile_conditional_symplectic
    gives equal circuits whose product keeps the right half of s."""
    jp, tp = specs(n)
    for seed in range(3):
        s, p = clifford(n, seed)
        for name in ('compile_stabilizer_state', 'compile_stabilizer_measurement'):
            a = getattr(jc, name)(s, p, jp, iterations=4, rand_state=np.random.RandomState(seed))
            b = getattr(tc, name)(s, p, tp, iterations=4, rand_state=np.random.RandomState(seed))
            assert a.str == b.str
            want = (s, p) if name == 'compile_stabilizer_state' else tsym.inverse_clifford(s, p)
            sc, pc = rep(b)
            assert np.array_equal(sc, want[0]) and np.array_equal(pc % 4, want[1] % 4)
        for calg in ('ROCAGE', 'BGE'):
            a = jc.compile_conditional_symplectic(s, jp, calg=calg,
                                                  rand_state=np.random.RandomState(seed))
            b = tc.compile_conditional_symplectic(s, tp, calg=calg,
                                                  rand_state=np.random.RandomState(seed))
            assert [c.str for c in a] == [c.str for c in b]


def test_compile_1q_clifford_and_costs():
    """Every one-qubit Clifford's shortest native word, and the standard
    cost functions on a circuit."""
    for i in range(24):
        s, p = tsym.compute_internal_gate_symplectic_representations(['Gc%d' % i])['Gc%d' % i]
        for natives in (('Gxpi2', 'Gypi2'), ('Gh', 'Gp')):
            a = jc.compile_1q_clifford(s, p, natives, 'Q1')
            b = tc.compile_1q_clifford(s, p, natives, 'Q1')
            assert [str(x) for x in a] == [str(x) for x in b]
            assert np.array_equal(rep(TCircuit(b, ('Q1',)))[0], s)
    text = 'Gxpi2:0Gcnot:0:1[Gypi2:0Gxpi2:1]Gcnot:1:0@(0,1)'
    for name in ('2QGC', 'depth', '2QGC:10:depth:1', '2QGC:3:depth:2'):
        assert jc.create_standard_costfunction(name)(JCircuit(text)) == \
            tc.create_standard_costfunction(name)(TCircuit(text))
    with pytest.raises(ValueError):
        tc.create_standard_costfunction('2QGC:x')
    assert tc.synthesize_symplectic(clifford(3, 1)[0]) == jc.synthesize_symplectic(
        clifford(3, 1)[0])
