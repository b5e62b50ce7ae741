"""The port's GF(2) linear algebra and symplectic Clifford tools against the
JAX package's, on the same seeded inputs: matrices, phase vectors and the
Clifford representations of the standard gates must be exactly equal.  Also
the processor spec's Clifford representations and the compilation rules'
one-qubit words, which used to raise in the port."""

import numpy as np
import pytest

from pygsti_tpu.algorithms import compilers as jcomp
from pygsti_tpu.circuits.circuit import Circuit as JCircuit
from pygsti_tpu.processors.processorspec import QubitProcessorSpec as JQPS
from pygsti_tpu.tools import matrixmod2 as jm2
from pygsti_tpu.tools import symplectic as jsym

from pygsti_tpu_torch.algorithms import compilers as tcomp
from pygsti_tpu_torch.circuits.circuit import Circuit as TCircuit
from pygsti_tpu_torch.processors import compilationrules as tcr
from pygsti_tpu_torch.processors.processorspec import QubitProcessorSpec as TQPS
from pygsti_tpu_torch.tools import matrixmod2 as tm2
from pygsti_tpu_torch.tools import symplectic as tsym


def same(a, b):
    """Exact equality of nested results: arrays by value and dtype kind,
    labels and circuits by their strings, numbers exactly."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        return a.shape == b.shape and a.dtype.kind == b.dtype.kind and np.array_equal(a, b)
    if isinstance(a, dict):
        return isinstance(b, dict) and list(a) == list(b) and all(same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)) and not hasattr(a, 'sslbls'):
        return isinstance(b, (list, tuple)) and len(a) == len(b) and \
            all(same(x, y) for x, y in zip(a, b))
    if hasattr(a, 'layertup') or hasattr(a, 'sslbls'):
        return str(a) == str(b)
    return a == b


def random_bits(rng, shape):
    return rng.randint(0, 2, shape).astype(np.int64)


# (name, function of (module, rng) -> result), each called on both packages
# with RandomState(seed)
MOD2_CASES = [
    ('dot_mod2', lambda m, r: m.dot_mod2(random_bits(r, (5, 4)), random_bits(r, (4, 3)))),
    ('multidot_mod2', lambda m, r: m.multidot_mod2([random_bits(r, (4, 4)) for _ in range(3)])),
    ('det_mod2', lambda m, r: m.det_mod2(random_bits(r, (5, 5)))),
    ('matrix_directsum', lambda m, r: m.matrix_directsum(random_bits(r, (2, 3)),
                                                         random_bits(r, (3, 2)))),
    ('inv_mod2', lambda m, r: m.inv_mod2(m.random_invertible_matrix(6, rand_state=r))),
    ('gaussian_elimination_mod2', lambda m, r: m.gaussian_elimination_mod2(
        random_bits(r, (5, 7)))),
    ('rank_mod2', lambda m, r: m.rank_mod2(random_bits(r, (6, 6)))),
    ('solve_mod2', lambda m, r: m.solve_mod2(m.random_invertible_matrix(5, rand_state=r),
                                             random_bits(r, 5))),
    ('Axb_mod2', lambda m, r: m.Axb_mod2(m.random_invertible_matrix(4, rand_state=r),
                                         random_bits(r, 4))),
    ('strictly_upper_triangle', lambda m, r: m.strictly_upper_triangle(random_bits(r, (5, 5)))),
    ('diagonal_as_vec', lambda m, r: m.diagonal_as_vec(random_bits(r, (5, 5)))),
    ('diagonal_as_matrix', lambda m, r: m.diagonal_as_matrix(random_bits(r, (5, 5)))),
    ('random_bitstring', lambda m, r: m.random_bitstring(9, 0.3, rand_state=r)),
    ('parity_bitstring', lambda m, r: m.parity_bitstring(7, 1, rand_state=r)),
    ('random_symmetric_invertable_matrix', lambda m, r: m.random_symmetric_invertable_matrix(
        4, rand_state=r)),
    ('albert_factor', lambda m, r: m.albert_factor(
        m.random_symmetric_invertable_matrix(4, rand_state=r), rand_state=r)),
    ('proper_permutation', lambda m, r: m.proper_permutation(
        m.random_symmetric_invertable_matrix(4, rand_state=r))),
]


@pytest.mark.parametrize("case", MOD2_CASES, ids=lambda c: c[0])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_matrixmod2(case, seed):
    _, fn = case
    a = fn(jm2, np.random.RandomState(seed))
    b = fn(tm2, np.random.RandomState(seed))
    assert same(a, b)


def _random_clifford_circuit(mod_circuit, rng, n, depth):
    names1 = ['Gxpi2', 'Gypi2', 'Gh', 'Gp', 'Gzpi2', 'Gc7', 'Gc20']
    layers = []
    for _ in range(depth):
        if n > 1 and rng.rand() < 0.4:
            q = rng.randint(n - 1)
            layers.append(('Gcnot', q, q + 1) if rng.rand() < 0.5 else ('Gcphase', q + 1, q))
        else:
            layers.append((names1[rng.randint(len(names1))], rng.randint(n)))
    return mod_circuit(layers, tuple(range(n)))


SYM_CASES = [
    ('symplectic_form', lambda m, r, n: (m.symplectic_form(n),
                                         m.symplectic_form(n, 'directsum'))),
    ('random_symplectic_matrix', lambda m, r, n: m.random_symplectic_matrix(n, rand_state=r)),
    ('random_clifford', lambda m, r, n: m.random_clifford(n, rand_state=r)),
    ('compose_and_inverse', lambda m, r, n: (lambda c1, c2: (
        m.compose_cliffords(*c1, *c2), m.inverse_clifford(*c1),
        m.inverse_symplectic(c2[0]), m.check_valid_clifford(*c1)))(
            m.random_clifford(n, rand_state=r), m.random_clifford(n, rand_state=r))),
    ('construct_valid_phase_vector', lambda m, r, n: m.construct_valid_phase_vector(
        m.random_symplectic_matrix(n, rand_state=r), r.randint(0, 4, 2 * n))),
    ('symplectic_kronecker', lambda m, r, n: m.symplectic_kronecker(
        [m.random_clifford(1, rand_state=r) for _ in range(n)])),
    ('embed_clifford', lambda m, r, n: m.embed_clifford(
        *m.random_clifford(1, rand_state=r), [n - 1], n + 1)),
    ('compute_symplectic_matrix', lambda m, r, n: [m.compute_symplectic_matrix(
        int(i), n) for i in r.randint(0, m.compute_num_symplectics(n), 4)]),
    ('compute_symplectic_label', lambda m, r, n: m.compute_symplectic_label(
        m.compute_symplectic_matrix(int(r.randint(0, m.compute_num_symplectics(n))), n), n)),
    ('counts', lambda m, r, n: (m.compute_num_symplectics(n), m.compute_num_cliffords(n),
                                m.compute_num_cosets(n))),
    ('random_symplectic_index', lambda m, r, n: m.random_symplectic_index(n, rand_state=r)),
    ('random_phase_vector', lambda m, r, n: m.random_phase_vector(
        m.random_symplectic_matrix(n, rand_state=r), n, rand_state=r)),
    ('change_symplectic_form_convention', lambda m, r, n: m.change_symplectic_form_convention(
        m.random_symplectic_matrix(n, rand_state=r), 'directsum')),
    ('bitstrings', lambda m, r, n: [(m.int_to_bitstring(int(i), 2 * n),
                                     m.bitstring_to_int(m.int_to_bitstring(int(i), 2 * n), 2 * n))
                                    for i in r.randint(0, 4 ** n, 5)]),
    ('transvections', lambda m, r, n: (lambda x, y: (
        m.find_symplectic_transvection(x, y), m.symplectic_innerproduct(x, y),
        m.symplectic_transvection(x, y)))(random_bits(r, 2 * n) | np.eye(2 * n, dtype=int)[0],
                                          random_bits(r, 2 * n) | np.eye(2 * n, dtype=int)[1])),
    ('find_paulis', lambda m, r, n: (lambda s, p1, p2: (
        m.find_postmultipled_pauli(s, p1, p2, list(range(n))),
        m.find_premultipled_pauli(s, p1, p2)))(
            *(lambda c: (c[0], c[1], m.random_phase_vector(c[0], n, rand_state=r)))(
                m.random_clifford(n, rand_state=r)))),
    ('find_pauli_layer', lambda m, r, n: (lambda p: (
        m.find_pauli_number(p[:2]), m.find_pauli_layer(p, list(range(n))),
        m.bitstring_for_pauli(p)))(2 * random_bits(r, 2 * n))),
    ('apply_internal_gate_to_symplectic', lambda m, r, n: [
        (lambda s: (m.apply_internal_gate_to_symplectic(s, g, q, ot), s)[1])(
            m.random_symplectic_matrix(n, rand_state=r))
        for g, q in (('H', [0]), ('P', [n - 1]), ('CNOT', [0, n - 1]), ('SWAP', [0, n - 1]))
        for ot in ('row', 'column')] if n > 1 else None),
    ('stabilizer_states', lambda m, r, n: (lambda st: (
        st, [m.pauli_z_measurement_probability(*st, q) for q in range(n)],
        m.pauli_z_measurement(*st, 0)[::2],
        m.stabilizer_outcome_probability(*st, list(random_bits(r, n))),
        m.stabilizer_measurement_prob(st, [0] * n)))(
            m.apply_clifford_to_stabilizer_state(
                *m.random_clifford(n, rand_state=r),
                *m.prep_stabilizer_state(n, list(random_bits(r, n)))))),
    ('measure_all_qubits_deterministic', lambda m, r, n: m.measure_all_qubits_deterministic(
        *m.apply_clifford_to_stabilizer_state(
            *m.compute_internal_gate_symplectic_representations(['Gxpi'])['Gxpi']
            if n == 1 else m.embed_clifford(
                *m.compute_internal_gate_symplectic_representations(['Gcnot'])['Gcnot'],
                [0, n - 1], n),
            *m.prep_stabilizer_state(n, list(random_bits(r, n)))))),
]


@pytest.mark.parametrize("case", SYM_CASES, ids=lambda c: c[0])
@pytest.mark.parametrize("n", [1, 2, 3])
def test_symplectic(case, n):
    _, fn = case
    for seed in range(3):
        a = fn(jsym, np.random.RandomState(seed), n)
        b = fn(tsym, np.random.RandomState(seed), n)
        assert same(a, b), (a, b)


def test_standard_gate_representations():
    """Every standard gate's (s, p), the one-qubit coset table, and the
    Clifford test of a few unitaries."""
    assert same(jsym.compute_internal_gate_symplectic_representations(),
                tsym.compute_internal_gate_symplectic_representations())
    assert jsym.one_q_clifford_symplectic_group_relations() == \
        tsym.one_q_clifford_symplectic_group_relations()
    from pygsti_tpu_torch.tools.internalgates import standard_gatename_unitaries
    std = standard_gatename_unitaries()
    for name in ('Gxpi2', 'Gcnot', 'Gt', 'Gc13', 'Gswap'):
        if name in std:
            assert jsym.unitary_is_clifford(std[name]) == tsym.unitary_is_clifford(std[name])
            if tsym.unitary_is_clifford(std[name]):
                assert same(jsym.unitary_to_symplectic(std[name]),
                            tsym.unitary_to_symplectic(std[name]))


@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_symplectic_rep_of_clifford_circuit(n):
    """(s, p) of random Clifford circuits, and of their layers, are equal."""
    for seed in range(4):
        jc = _random_clifford_circuit(JCircuit, np.random.RandomState(seed), n, 12)
        tc = _random_clifford_circuit(TCircuit, np.random.RandomState(seed), n, 12)
        assert jc.str == tc.str
        assert same(jsym.symplectic_rep_of_clifford_circuit(jc),
                    tsym.symplectic_rep_of_clifford_circuit(tc))
        assert same(jsym.symplectic_rep_of_clifford_layer(jc.layertup[0], n),
                    tsym.symplectic_rep_of_clifford_layer(tc.layertup[0], n))


@pytest.mark.parametrize("n, gates, geometry", [
    (1, ['Gxpi2', 'Gypi2'], 'line'), (2, ['Gxpi2', 'Gypi2', 'Gcnot'], 'line'),
    (3, ['Gxpi2', 'Gypi2', 'Gcnot'], 'line'), (2, ['Gxpi2', 'Gzpi2', 'Gcphase', 'Gi'], 'line'),
    (3, ['Gh', 'Gp', 'Gcnot', 'Gt'], 'ring')])
def test_processor_spec_clifford_reps(n, gates, geometry):
    """compute_clifford_symplectic_reps: the same gates (non-Cliffords and
    argument-taking gates left out) with the same (s, p), whole and by
    subset."""
    jp, tp = JQPS(n, gates, geometry=geometry), TQPS(n, gates, geometry=geometry)
    a, b = jp.compute_clifford_symplectic_reps(), tp.compute_clifford_symplectic_reps()
    assert same(a, b) and a
    sub = gates[:2]
    assert same(jp.compute_clifford_symplectic_reps(sub), tp.compute_clifford_symplectic_reps(sub))


@pytest.mark.parametrize("natives", [('Gxpi2', 'Gypi2'), ('Gh', 'Gp'), ('Gxpi2', 'Gzpi2'),
                                     ('Gc3', 'Gc17', 'Gc22')])
def test_word_for_1q(natives):
    """CompilationRules.word_for_1q: the shortest native word of each
    generator, equal in both packages, and one class under both module
    paths."""
    assert tcr.CompilationRules is tcomp.CompilationRules
    gates = list(natives) + ['Gcnot']
    jr = jcomp.CompilationRules(JQPS(2, gates, geometry='line'))
    tr = tcr.CompilationRules(TQPS(2, gates, geometry='line'))
    for gen in ('H', 'P', 'X', 'Y', 'Z'):
        for q in (0, 1):
            assert [str(x) for x in jr.word_for_1q(gen, q)] == \
                [str(x) for x in tr.word_for_1q(gen, q)]
    assert [str(x) for x in jr.word_for_cnot(1, 0)] == [str(x) for x in tr.word_for_cnot(1, 0)]
    s, p = tsym.compute_internal_gate_symplectic_representations(['Gh'])['Gh']
    word = tr.word_for_1q('H', 1)
    assert same(tsym.symplectic_rep_of_clifford_circuit(TCircuit(word, (1,))), (s, p))
