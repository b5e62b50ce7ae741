"""tools/optools.py of the port against the JAX package's on the same inputs:
the conversions, the eigenvalue, gate-set, POVM and instrument metrics, the
projections and the small helpers, at 1 and 2 qubits.

The models are the packs' 'full TP' targets depolarized (0.03 on the gates,
0.01 on SPAM), over-rotated at 1 qubit (JAX ``rotate``, max 0.02, seed 1)
and moved by a seeded 1e-3 perturbation of the vector at 2 qubits; the
port's model holds the JAX model's parameter vector.  Tolerances: 1e-12
absolute on matrices and metrics of host numpy arithmetic, 1e-10 where a
matrix logarithm or square root enters, 1e-8 for the diamond distance (the
tolerance of tests/test_torch_confidence.py, an SDP solve), and 1e-7 for a
fidelity of rank-deficient Choi matrices (a POVM map, an instrument's
members): scipy's sqrtm of a singular matrix turns the 1e-16 rounding by
which the two packages' dense forms differ into about 1e-8.
"""

import numpy as np
import pytest
import scipy.linalg as spl

import pygsti_tpu.modelpacks.smq1Q_XYI as jmp1
import pygsti_tpu.modelpacks.smq2Q_XYICNOT as jmp2
from pygsti_tpu.modelmembers import instruments as jinst
from pygsti_tpu.tools import optools as jot

import pygsti_tpu_torch.modelpacks.smq1Q_XYI as tmp1
import pygsti_tpu_torch.modelpacks.smq2Q_XYICNOT as tmp2
from pygsti_tpu_torch.convert import instrument_from_dense, model_from_vector
from pygsti_tpu_torch.tools import optools as tot
from pygsti_tpu_torch.tools.basistools import change_basis

PACKS = {1: (jmp1, tmp1), 2: (jmp2, tmp2)}
ALL_PROJECTIONS = ('H', 'S', 'H+S', 'LND', 'LNDF')


def noisy_pair(nq):
    """(JAX noisy, JAX target, port noisy, port target)."""
    jmp, tmp = PACKS[nq]
    jt = jmp.target_model('full TP')
    jm = jt.depolarize(op_noise=0.03, spam_noise=0.01)
    if nq == 1:
        jm = jm.rotate(max_rotate=0.02, seed=1)
    else:
        v = jm.to_vector()
        jm.from_vector(v + 1e-3 * np.random.default_rng(3).standard_normal(len(v)))
    tt = tmp.target_model('full TP')
    return jm, jt, model_from_vector(tt, jm.to_vector()), tt


@pytest.fixture(scope='module', params=[1, 2], ids=['1Q', '2Q'])
def pair(request):
    return (request.param,) + noisy_pair(request.param)


def dense_ops(jm, jt):
    """(label, noisy operation, target operation) of the JAX models."""
    return [(str(l), np.asarray(jm.operations[l].to_dense()),
             np.asarray(jt.operations[l].to_dense())) for l in jm.operations.keys()]


def random_unitary(d, seed):
    rng = np.random.default_rng(seed)
    q, r = np.linalg.qr(rng.standard_normal((d, d)) + 1j * rng.standard_normal((d, d)))
    return q * (np.diag(r) / np.abs(np.diag(r)))


@pytest.mark.parametrize('nq', [1, 2])
def test_conversions(nq):
    d = 2 ** nq
    u = random_unitary(d, nq)
    for name in ('unitary_to_pauligate', 'unitary_to_process_mx'):
        assert np.allclose(getattr(tot, name)(u), getattr(jot, name)(u), atol=1e-12, rtol=0)
    for basis in ('pp', 'gm', 'std'):
        assert np.allclose(tot.operation_from_unitary(u, basis),
                           jot.operation_from_unitary(u, basis), atol=1e-12, rtol=0)
        sup = jot.unitary_to_superop(u, basis)
        assert np.allclose(tot.process_mx_to_unitary(sup, basis),
                           jot.process_mx_to_unitary(sup, basis), atol=1e-10, rtol=0)
    psi = u[:, 0]
    dm = tot.state_to_dmvec(psi)
    assert np.allclose(dm, jot.state_to_dmvec(psi), atol=1e-12, rtol=0)
    assert np.allclose(tot.dmvec_to_state(dm), jot.dmvec_to_state(dm), atol=1e-10, rtol=0)
    for a, b in zip(tot.spam_from_state(psi), jot.spam_from_state(psi)):
        assert np.allclose(a, b, atol=1e-12, rtol=0)
    r = np.random.default_rng(nq).uniform(-1, 1, 4 ** nq - 1)
    assert np.allclose(tot.rotation_gate_mx(r), jot.rotation_gate_mx(r), atol=1e-12, rtol=0)


def test_gate_metrics(pair):
    nq, jm, jt, tm, tt = pair
    for lbl, a, b in dense_ops(jm, jt):
        for fn in ('generator_infidelity', 'fidelity_upper_bound'):
            args = (a, b) if fn == 'generator_infidelity' else (a,)
            assert abs(getattr(tot, fn)(*args) - getattr(jot, fn)(*args)) < 1e-10, (lbl, fn)
        # the eigenvalue fidelities of Hermitian PSD matrices: the Choi matrices
        from pygsti_tpu_torch.tools.jamiolkowski import jamiolkowski_iso
        ca, cb = jamiolkowski_iso(a), jamiolkowski_iso(b)
        for gi in (True, False):
            assert abs(tot.eigenvalue_fidelity(ca, cb, gi)
                       - jot.eigenvalue_fidelity(ca, cb, gi)) < 1e-10, (lbl, gi)
            assert abs(tot.eigenvalue_infidelity(ca, cb, gi)
                       - jot.eigenvalue_infidelity(ca, cb, gi)) < 1e-10, (lbl, gi)


def test_eigenvalue_entanglement_infidelity(pair):
    """Held to the JAX package where its sort_complex order pairs each
    eigenvalue with the nearest one: every gate at 1 qubit, the idle and the
    CNOT at 2.  The 2-qubit rotations have four eigenvalues near +i and four
    near -i whose real parts tie; there the JAX package's order mismatches
    them (ROADMAP.md section 3) and the port's matching gives the
    entanglement infidelity's value within the perturbation."""
    nq, jm, jt, tm, tt = pair
    for lbl, a, b in dense_ops(jm, jt):
        ours = tot.eigenvalue_entanglement_infidelity(a, b)
        if nq == 1 or lbl in ('[]', 'Gcnot:0:1'):
            assert abs(ours - jot.eigenvalue_entanglement_infidelity(a, b)) < 1e-12, lbl
        else:
            assert abs(ours - jot.entanglement_infidelity(a, b)) < 1e-5, lbl


def test_eigenvalue_entanglement_infidelity_of_a_depolarized_rotation():
    """A 2-qubit pi/2 rotation depolarized by p: every eigenvalue but the
    identity's scales by 1 - p, so the value is 15 p / 16 exactly."""
    jt = jmp2.target_model('full TP')
    g = np.asarray(jt.operations[('Gxpi2', 0)].to_dense())
    p = 0.01
    noisy = np.diag([1.0] + [1 - p] * 15) @ g
    assert abs(tot.eigenvalue_entanglement_infidelity(noisy, g) - 15 * p / 16) < 1e-12


def test_gateset_and_spam_metrics(pair):
    nq, jm, jt, tm, tt = pair
    weights = {l: 1.0 + i for i, l in enumerate(jt.operations.keys())}
    for itype in ('EI', 'AGI'):
        for w in (None, weights):
            assert abs(tot.gateset_infidelity(tm, tt, itype, w)
                       - jot.gateset_infidelity(jm, jt, itype, w)) < 1e-12, (itype, w)
    rho, rho_t = np.asarray(jm.preps['rho0'].to_dense()), np.asarray(jt.preps['rho0'].to_dense())
    assert np.allclose(tot.spam_error_generator(tm.preps['rho0'].dense(),
                                                tt.preps['rho0'].dense()),
                       jot.spam_error_generator(rho, rho_t), atol=1e-10, rtol=0)


def test_povm_metrics(pair):
    nq, jm, jt, tm, tt = pair
    assert np.allclose(tot.compute_povm_map(tm, 'Mdefault'),
                       jot.compute_povm_map(jm, 'Mdefault'), atol=1e-12, rtol=0)
    for fn, tol in (('povm_fidelity', 1e-7), ('povm_jtracedist', 1e-10),
                    ('povm_diamonddist', 1e-8)):
        ours = getattr(tot, fn)(tm, tt, 'Mdefault')
        assert abs(ours - getattr(jot, fn)(jm, jt, 'Mdefault')) < tol, fn
        assert np.isfinite(ours)


@pytest.mark.parametrize('nq', [1, 2])
def test_instrument_metrics(nq):
    """Two TPInstruments: a Z measurement of the first qubit, and the same
    with each member depolarized by 0.02 (the diamond distance at 1 qubit
    only: at 2 the joint map is 64 x 64, an SDP of 16 s in each package)."""
    from pygsti_tpu_torch.tools.basistools import change_basis as cb

    def members(depol):
        out = {}
        for k in (0, 1):
            P = np.kron(np.diag([1.0 - k, float(k)]), np.eye(2 ** (nq - 1)))
            mx = np.real(cb(np.kron(P, P.conj()), 'std', 'pp'))
            out['p%d' % k] = np.diag([1.0] + [1.0 - depol] * (mx.shape[0] - 1)) @ mx
        return out

    ta, tb = (instrument_from_dense('TP', members(x)) for x in (0.02, 0.0))
    ja, jb = (jinst.TPInstrument(members(x)) for x in (0.02, 0.0))
    assert abs(tot.instrument_infidelity(ta, tb, 'pp')
               - jot.instrument_infidelity(ja, jb, 'pp')) < 1e-7
    if nq == 1:
        dd = tot.instrument_diamonddist(ta, tb, 'pp')
        assert abs(dd - jot.instrument_diamonddist(ja, jb, 'pp')) < 1e-8 and dd > 0
    assert abs(tot.instrument_infidelity(tb, tb, 'pp')) < 1e-7


def test_project_model(pair):
    """Every projection type: the parameter counts and each projected
    operation (1e-10)."""
    nq, jm, jt, tm, tt = pair
    jmodels, jcounts = jot.project_model(jm, jt, ALL_PROJECTIONS)
    tmodels, tcounts = tot.project_model(tm, tt, ALL_PROJECTIONS)
    n = 4 ** nq - 1
    assert tcounts == jcounts == [len(jt.operations) * k for k in (n, n, 2 * n, n + n * n,
                                                                   n + n * n)]
    for jp, tp in zip(jmodels, tmodels):
        for lbl in jt.operations.keys():
            assert np.max(np.abs(tp.operations[lbl].dense()
                                 - np.asarray(jp.operations[lbl].to_dense()))) < 1e-10
        assert np.allclose(tp.preps['rho0'].dense(), tm.preps['rho0'].dense())


def test_target_eigenspace_and_best_case_gauge(pair):
    nq, jm, jt, tm, tt = pair
    jp, tp = jot.project_to_target_eigenspace(jm, jt), tot.project_to_target_eigenspace(tm, tt)
    for lbl in jt.operations.keys():
        assert np.max(np.abs(tp.operations[lbl].dense()
                             - np.asarray(jp.operations[lbl].to_dense()))) < 1e-10
    for lbl, a, b in dense_ops(jm, jt):
        Uj, (ej, fj) = jot.compute_best_case_gauge_transform(a, b, return_all=True)
        Ut, (et, ft) = tot.compute_best_case_gauge_transform(a, b, return_all=True)
        assert np.allclose(Ut, Uj, atol=1e-10, rtol=0) and np.allclose(et, ej) \
            and np.allclose(ft, fj), lbl


def test_small_helpers(pair):
    nq, jm, jt, tm, tt = pair
    d2 = 4 ** nq
    g = tm.operations[list(tm.operations.keys())[-1]].dense()
    rho = tm.preps['rho0'].dense()
    from pygsti_tpu_torch.baseobjs.basis import Basis
    from pygsti_tpu.baseobjs.basis import Basis as JBasis
    assert abs(tot.superket_trace(rho, Basis.cast('pp', d2))
               - jot.superket_trace(rho, JBasis.cast('pp', d2))) < 1e-12
    assert abs(tot.superket_trace(rho, 'pp') - jot.superket_trace(rho, 'pp')) < 1e-12
    for sup in (g, tt.operations[list(tt.operations.keys())[-1]].dense()):
        assert tot.superop_is_unitary(sup) == jot.superop_is_unitary(sup)
    for typ in ('GLND', 'CPTPLND', 'H+S', 'H+s', 'S+A', 'full', 'H+H'):
        assert tot.is_valid_lindblad_paramtype(typ) == jot.is_valid_lindblad_paramtype(typ)
    for lbl in ('Mdefault_0', 'Mdefault_11', None):
        assert tot.effect_label_to_outcome(lbl) == jot.effect_label_to_outcome(lbl)
        assert tot.effect_label_to_povm(lbl) == jot.effect_label_to_povm(lbl)
    dm = change_basis(rho, 'pp', 'std').reshape(2 ** nq, 2 ** nq)
    assert tot.fast_density_rank(dm) == jot.fast_density_rank(dm)
    kt, kj = tot.minimal_kraus_decomposition(g), jot.minimal_kraus_decomposition(g)
    assert len(kt) == len(kj)
    assert np.allclose(sum(tot.rootconj_superop(k) for k in kt), g, atol=1e-10, rtol=0)
    for k in kt[:3]:
        assert np.allclose(tot.rootconj_superop(k), jot.rootconj_superop(k), atol=1e-12, rtol=0)
    if nq == 1:
        assert np.allclose(tot.tensorized_with_eye(g, 'pp'), jot.tensorized_with_eye(g, 'pp'),
                           atol=1e-12, rtol=0)
    for a, b in ((1.0, 2.0), (1e-12, 0.0), (-3.0, 5e3)):
        assert tot.relaxed_scalar_tolerance(a, b) == jot.relaxed_scalar_tolerance(a, b)


def test_povm_map_refuses_more_outcomes_than_the_dimension():
    from pygsti_tpu_torch.models.explicitmodel import ExplicitOpModel
    tt = tmp1.target_model('full TP')
    m = ExplicitOpModel(4, 'pp', 'full', 'full', 'full')
    m.preps['rho0'] = tt.preps['rho0'].dense()
    e = np.array([1.0, 0, 0, 0]) / np.sqrt(2) / 3
    m.povms['M3'] = {'a': e, 'b': e, 'c': e}
    with pytest.raises(ValueError, match='outcomes'):
        tot.compute_povm_map(m, 'M3')
    assert spl.norm(tot.compute_povm_map(tt, 'Mdefault')) > 0
