"""The port's elementary error generators, their bases and spaces against
the JAX package's: generators and duals of H, S, C and A at 1 and 2
qubits, the n-qudit and bulk builders, projections and coefficient
extraction, the complete and explicit errorgen bases and ErrorgenSpace
intersection and union (tests/test_baseobjs.py:124-160)."""

import itertools

import numpy as np
import pytest
import scipy.linalg as spl

import pygsti_tpu.baseobjs.errorgenbasis as jeb
import pygsti_tpu.baseobjs.errorgenspace as jes
import pygsti_tpu.tools.lindbladtools as jlt
import pygsti_tpu.tools.optools as jot
import pygsti_tpu_torch.baseobjs.errorgenbasis as teb
import pygsti_tpu_torch.baseobjs.errorgenspace as tes
import pygsti_tpu_torch.tools.lindbladtools as tlt
import pygsti_tpu_torch.tools.optools as tot
from pygsti_tpu_torch.baseobjs.basis import Basis

_PAULI = {'I': np.eye(2), 'X': np.array([[0, 1], [1, 0]], complex),
          'Y': np.array([[0, -1j], [1j, 0]]), 'Z': np.diag([1.0, -1.0])}


def _pauli(s):
    m = np.ones((1, 1), complex)
    for ch in s:
        m = np.kron(m, _PAULI[ch])
    return m


def _elementary_cases():
    out = []
    for nq in (1, 2):
        paulis = [''.join(p) for p in itertools.product('IXYZ', repeat=nq)][1:]
        picks = paulis[:2] + paulis[-1:]
        for typ in 'HS':
            out += [(typ, (p,)) for p in picks]
        for typ in 'CA':
            out += [(typ, (p, q)) for p, q in itertools.combinations(picks, 2)]
    return out


@pytest.mark.parametrize("typ,labels", _elementary_cases())
def test_elementary_errorgen_and_dual(typ, labels):
    """The std-basis generator, its dual and the pairing-normalized dual
    equal the JAX package's exactly; the pairing-normalized dual pairs to 1
    with its generator."""
    mats = [_pauli(s) for s in labels]
    for fn in ('create_elementary_errorgen', 'create_elementary_errorgen_dual',
               'create_pairing_normalized_errorgen_dual'):
        j, t = getattr(jlt, fn)(typ, *mats), getattr(tlt, fn)(typ, *mats)
        assert np.max(np.abs(t - j)) == 0, fn
    dual = tlt.create_pairing_normalized_errorgen_dual(typ, *mats)
    assert abs(np.vdot(dual, tlt.create_elementary_errorgen(typ, *mats)) - 1) < 1e-14


@pytest.mark.parametrize("typ", 'HSCA')
@pytest.mark.parametrize("basis,dim", [('pp', 4), ('pp', 16), ('gm', 9)])
def test_elementary_errorgens_dicts(typ, basis, dim):
    """optools.elementary_errorgens(_dual): the same labels and matrices;
    generators and duals pair to the identity."""
    j, t = jot.elementary_errorgens(dim, typ, basis), tot.elementary_errorgens(dim, typ, basis)
    jd, td = jot.elementary_errorgens_dual(dim, typ, basis), tot.elementary_errorgens_dual(dim, typ, basis)
    assert [str(k) for k in t] == [str(k) for k in j] == [str(k) for k in td]
    for (a, b), (c, e) in zip(zip(t.values(), j.values()), zip(td.values(), jd.values())):
        assert np.max(np.abs(a - b)) == 0 and np.max(np.abs(c - e)) == 0
    gram = np.array([[np.vdot(d, g) for g in t.values()] for d in td.values()])
    if typ in 'HS':
        assert np.max(np.abs(gram - np.eye(len(t)))) < 1e-12


@pytest.mark.parametrize("typ,labels", [('H', ('XY',)), ('S', ('ZI',)), ('C', ('XI', 'IZ')),
                                        ('A', ('XY', 'ZZ')), ('H', ('X',)), ('A', ('X', 'Y'))])
@pytest.mark.parametrize("normalize", [False, True])
def test_nqudit_builders(typ, labels, normalize):
    """create_elementary_errorgen_nqudit(_dual) and their bulk forms."""
    for fn in ('create_elementary_errorgen_nqudit', 'create_elementary_errorgen_nqudit_dual'):
        j = getattr(jot, fn)(typ, labels, 'pp', normalize)
        t = getattr(tot, fn)(typ, labels, 'pp', normalize)
        assert np.max(np.abs(t - j)) == 0
        tb = getattr(tot, 'bulk_' + fn)([typ, typ], [labels, labels], 'pp', normalize)
        assert len(tb) == 2 and np.max(np.abs(tb[1] - j)) == 0
    sp = tot.create_elementary_errorgen_nqudit(typ, labels, 'pp', normalize, sparse=True)
    assert np.max(np.abs(sp.toarray() - tot.create_elementary_errorgen_nqudit(
        typ, labels, 'pp', normalize))) == 0


def _random_errorgen(seed, nq=1):
    rates = tlt.random_CPTP_error_generator_rates(nq, seed=seed)
    dim = 4 ** nq
    L = np.zeros((dim, dim), complex)
    for lbl, r in rates.items():
        mats = [_pauli(p.to_str() if hasattr(p, 'to_str') else str(p)).reshape(2 ** nq, 2 ** nq)
                for p in lbl.basis_element_labels]
        L += r * tlt.create_elementary_errorgen(lbl.errorgen_type, *mats)
    from pygsti_tpu_torch.tools.basistools import change_basis
    return np.real(change_basis(L, 'std', 'pp'))


@pytest.mark.parametrize("nq", [1, 2])
def test_random_cptp_rates(nq):
    """The same rates from the same seed, keyed alike."""
    j = jlt.random_CPTP_error_generator_rates(nq, seed=5, error_metric='total_generator_error',
                                              error_metric_value=0.01)
    t = tlt.random_CPTP_error_generator_rates(nq, seed=5, error_metric='total_generator_error',
                                              error_metric_value=0.01)
    assert [str(k) for k in t] == [str(k) for k in j]
    assert max(abs(t[a] - j[b]) for a, b in zip(t, j)) == 0


@pytest.mark.parametrize("typ", 'HSCA')
def test_project_and_extract(typ):
    """project_errorgen and extract_elementary_errorgen_coefficients of an
    error generator of random rates: the same rates and projections."""
    L = _random_errorgen(3)
    j = jot.project_errorgen(L, typ, 'pp', 'pp', True, True)
    t = tot.project_errorgen(L, typ, 'pp', 'pp', True, True)
    assert [str(k) for k in t[0]] == [str(k) for k in j[0]]
    assert max(abs(t[0][a] - j[0][b]) for a, b in zip(t[0], j[0])) < 1e-15
    assert np.max(np.abs(t[2] - j[2])) < 1e-15
    je = jot.extract_elementary_errorgen_coefficients(L, list(j[0]), 'PP', 'pp', True)
    te = tot.extract_elementary_errorgen_coefficients(L, list(t[0]), 'PP', 'pp', True)
    assert max(abs(te[0][a] - je[0][b]) for a, b in zip(t[0], j[0])) < 1e-15
    assert np.max(np.abs(te[1] - je[1])) < 1e-15


def test_error_generator_round_trip_and_checks():
    """error_generator / operation_from_error_generator of each type, and
    is_trace_preserving / is_cptp, as in the JAX package."""
    from pygsti_tpu_torch.tools.optools import unitary_to_superop
    target = np.real(unitary_to_superop(spl.expm(-0.25j * np.pi * _PAULI['X']), 'pp'))
    gate = target @ spl.expm(_random_errorgen(8))
    for typ in ('logGTi', 'logTiG', 'logG-logT'):
        j, t = jot.error_generator(gate, target, 'pp', typ), tot.error_generator(gate, target, 'pp', typ)
        assert np.max(np.abs(t - j)) < 1e-15
        if typ != 'logG-logT':
            back = tot.operation_from_error_generator(t, target, typ)
            assert np.max(np.abs(back - gate)) < 1e-12
    with pytest.raises(ValueError):
        tot.error_generator(gate, target, 'pp', 'nope')
    for m in (gate, target, 1.1 * gate, gate - 0.2 * np.eye(4)):
        assert tot.is_trace_preserving(m) == jot.is_trace_preserving(m)
        assert tot.is_cptp(m) == jot.is_cptp(m)
    assert tot.is_cptp(gate) and not tot.is_trace_preserving(1.1 * gate)


def test_complete_basis():
    """tests/test_baseobjs.py's case: counts, labels, matrices and duals
    against the JAX package's, and the subbasis on qubit 0."""
    for kw in ({'num_qubits': 1}, {'num_qubits': 2},
               {'num_qubits': 2, 'elementary_errorgen_types': ('H', 'S'),
                'max_ham_weight': 1, 'max_other_weight': 1}):
        j, t = jeb.CompleteElementaryErrorgenBasis(**kw), teb.CompleteElementaryErrorgenBasis(**kw)
        assert [str(x) for x in t.labels] == [str(x) for x in j.labels]
        assert [str(x) for x in t.global_labels()] == [str(x) for x in j.global_labels()]
        dim = 4 ** kw['num_qubits']
        for fn in ('elemgen_matrices', 'elemgen_dual_matrices'):
            for a, b in zip(getattr(t, fn)(Basis.cast('pp', dim)), getattr(j, fn)('pp')):
                assert np.max(np.abs(a - b)) == 0
    assert len(teb.CompleteElementaryErrorgenBasis(num_qubits=1)) == 12
    b2 = teb.CompleteElementaryErrorgenBasis(num_qubits=2, elementary_errorgen_types=('H', 'S'),
                                             max_ham_weight=1, max_other_weight=1)
    assert len(b2) == 12
    sub = b2.create_subbasis([0])
    jsub = jeb.CompleteElementaryErrorgenBasis(
        num_qubits=2, elementary_errorgen_types=('H', 'S'), max_ham_weight=1,
        max_other_weight=1).create_subbasis([0])
    assert [str(x) for x in sub.labels] == [str(x) for x in jsub.labels]
    assert all(0 in l.support_indices() for l in sub.labels)
    assert sub.label_indices(sub.labels[:2]) == [0, 1]
    assert sub.label_index('nope', ok_if_missing=True) is None


def _space_pair(pkg_b, pkg_s):
    b = pkg_b.CompleteElementaryErrorgenBasis(num_qubits=1, elementary_errorgen_types=('H', 'S'))
    e = np.eye(len(b))
    return pkg_s.ErrorgenSpace(e[:, :3], b), pkg_s.ErrorgenSpace(e[:, 2:5], b), b


def test_errorgen_space_intersection_union():
    """tests/test_baseobjs.py's ErrorgenSpace case in both packages."""
    A, B, b = _space_pair(teb, tes)
    JA, JB, _ = _space_pair(jeb, jes)
    inter, jinter = A.intersection(B), JA.intersection(JB)
    assert inter.vectors.shape[1] == 1
    v = inter.vectors[:, 0] / np.linalg.norm(inter.vectors[:, 0])
    assert abs(abs(v[2]) - 1.0) < 1e-9
    assert np.max(np.abs(inter.vectors - jinter.vectors)) == 0
    uni, juni = A.union(B), JA.union(JB)
    assert uni.vectors.shape[1] == 5 and np.max(np.abs(uni.vectors - juni.vectors)) == 0
    A.normalize()
    JA.normalize()
    assert np.allclose(np.linalg.norm(A.vectors, axis=0), 1.0)
    assert np.max(np.abs(A.vectors - JA.vectors)) == 0
    assert A == tes.ErrorgenSpace(A.vectors.copy(), b) and not (A == B)


def test_errorgen_space_free_intersection_and_label_sets():
    """An intersection over bases that differ (free on the labels a space
    lacks), with nice null spaces, and the union / intersection /
    difference of label bases."""
    res = []
    for eb, es in ((jeb, jes), (teb, tes)):
        full = eb.CompleteElementaryErrorgenBasis(num_qubits=1, elementary_errorgen_types=('H', 'S'))
        hb = eb.ExplicitElementaryErrorgenBasis(None, full.labels[:3])
        sb = eb.ExplicitElementaryErrorgenBasis(None, full.labels[2:])
        rng = np.random.RandomState(1)
        X = es.ErrorgenSpace(rng.randn(3, 2), hb)
        Y = es.ErrorgenSpace(rng.randn(4, 3), sb)
        res.append((X.intersection(Y, free_on_unspecified_space=True, use_nice_nullspace=True),
                    [str(x) for x in eb.union_basis(hb, sb).labels],
                    [str(x) for x in eb.intersection_basis(hb, sb).labels],
                    [str(x) for x in eb.difference_basis(hb, sb).labels]))
    (ji, *jl), (ti, *tl) = res
    assert tl == jl and [str(x) for x in ti.elemgen_basis.labels] == \
        [str(x) for x in ji.elemgen_basis.labels]
    assert np.max(np.abs(ti.vectors - ji.vectors)) < 1e-14
