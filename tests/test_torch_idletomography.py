"""The port's extras/idletomography against the JAX package's: the Pauli
objects, idttools, the analytic Jacobian elements (an exhaustive 2-qubit
sweep), fiducial pairs and experiment lists, the numerical design and
protocol, do_idle_tomography in both Jacobian modes, and the model bridges
(set_idle_errors, extract_idle_errors, predicted_*_rates).  Both packages
get the same counts (drawn by the port on the CPU); rates agree within
1e-10.  Cases from tests/test_extras.py and tests/test_idt_functional.py."""

import itertools

import numpy as np
import pytest
import scipy.linalg as spl
import torch

from pygsti_tpu.extras import idletomography as jidt
from pygsti_tpu.extras.idletomography import idttools as jtools, pauliobjs as jpo
from pygsti_tpu.circuits import Circuit as JCircuit
from pygsti_tpu.data.dataset import DataSet as JDataSet
from pygsti_tpu.protocols.protocol import ProtocolData as JData
import pygsti_tpu.modelpacks.smq1Q_XYI as jmp1
import pygsti_tpu.modelpacks.smq2Q_XYI as jmp2
from pygsti_tpu.baseobjs.label import Label as JLabel
from pygsti_tpu.modelmembers.operations import (ExpErrorgenOp as JExp,
                                                build_lindblad_errorgen as j_build)

from pygsti_tpu_torch.extras import idletomography as tidt
from pygsti_tpu_torch.extras.idletomography import idttools as ttools, pauliobjs as tpo
from pygsti_tpu_torch.baseobjs.label import Label
from pygsti_tpu_torch.data.datasetconstruction import simulate_data
from pygsti_tpu_torch.modelmembers.operations import (ExpErrorgenOp, StaticArbitraryOp,
                                                      build_lindblad_errorgen)
from pygsti_tpu_torch.protocols.protocol import ProtocolData
import pygsti_tpu_torch.modelpacks.smq1Q_XYI as tmp1
import pygsti_tpu_torch.modelpacks.smq2Q_XYI as tmp2
from pygsti_tpu_torch.tools.basistools import change_basis
from pygsti_tpu_torch.tools.lindbladtools import create_elementary_errorgen

PREP_DICT = {'X': ('Gypi2',), 'Y': ('Gxpi2',) * 3, 'Z': (),
             '-X': ('Gypi2',) * 3, '-Y': ('Gxpi2',), '-Z': ('Gxpi2', 'Gxpi2')}
MEAS_DICT = {'X': ('Gypi2',) * 3, 'Y': ('Gxpi2',), 'Z': (),
             '-X': ('Gypi2',), '-Y': ('Gxpi2',) * 3, '-Z': ('Gxpi2', 'Gxpi2')}
DICTS = (PREP_DICT, MEAS_DICT)
SZ = np.diag([1.0, -1.0]).astype(complex)


def _jax_ds(ds):
    """The port's counts as a JAX-package DataSet."""
    out = JDataSet()
    for c in ds.keys():
        out.add_count_dict(JCircuit(c.str), {o[0]: n for o, n in ds[c].counts.items()})
    return out


def _idle_model(nq, ham_z=0.0, sto_z=0.0, sto_zz=0.0):
    """The pack's static target whose global idle has H_Z/S_Z on qubit 0
    (and S_ZZ at 2 qubits)."""
    model = (tmp1 if nq == 1 else tmp2).target_model('static')
    L = ham_z * np.real(change_basis(create_elementary_errorgen('H', SZ), 'std', 'pp')) \
        + sto_z * np.real(change_basis(create_elementary_errorgen('S', SZ), 'std', 'pp'))
    idle = spl.expm(L) if nq == 1 else np.kron(spl.expm(L), np.eye(4))
    if sto_zz:
        idle = idle @ spl.expm(sto_zz * np.real(change_basis(
            create_elementary_errorgen('S', np.kron(SZ, SZ)), 'std', 'pp')))
    model.operations[Label(())] = StaticArbitraryOp(np.real(idle))
    return model


def _key(fp):
    return (fp[0].rep, tuple(fp[0].signs), fp[1].rep, tuple(fp[1].signs))


def test_jacobian_elements_match_jax_exhaustively():
    """Every Hamiltonian, stochastic and affine element over all 2-qubit
    preps, signs, errors, observables and outcomes."""
    lets, bases = 'IXYZ', 'XYZ'
    signs = list(itertools.product((1, -1), repeat=2))
    reps = [''.join(p) for p in itertools.product(lets, repeat=2) if p != ('I', 'I')]
    for basis in (''.join(b) for b in itertools.product(bases, repeat=2)):
        for ps in signs:
            tprep, jprep = tpo.NQPauliState(basis, ps), jpo.NQPauliState(basis, ps)
            for err in reps:
                te, je = tpo.NQPauliOp(err), jpo.NQPauliOp(err)
                for obs in reps:
                    to, jo = tpo.NQPauliOp(obs), jpo.NQPauliOp(obs)
                    assert tidt.hamiltonian_jac_element(tprep, te, to) == \
                        jidt.hamiltonian_jac_element(jprep, je, jo)
                    assert tidt.affine_jac_obs_element(tprep, te, to) == \
                        jidt.affine_jac_obs_element(jprep, je, jo)
                for ms in signs:
                    tm, jm = tpo.NQPauliState(basis, ms), jpo.NQPauliState(basis, ms)
                    assert str(tidt.stochastic_outcome(tprep, te, tm)) == \
                        str(jidt.stochastic_outcome(jprep, je, jm))
                    for out in ('00', '01', '10', '11'):
                        args_t = (tprep, te, tm, tpo.NQOutcome(out))
                        args_j = (jprep, je, jm, jpo.NQOutcome(out))
                        assert tidt.stochastic_jac_element(*args_t) == \
                            jidt.stochastic_jac_element(*args_j)
                        assert tidt.affine_jac_element(*args_t) == \
                            jidt.affine_jac_element(*args_j)


def test_pauli_objects_match_jax():
    rng = np.random.RandomState(0)
    for _ in range(200):
        a, b = (''.join(rng.choice(list('IXYZ'), 3)) for _ in range(2))
        sa, sb = rng.choice([1, -1], 2)
        ta, tb, ja, jb = tpo.NQPauliOp(a, sa), tpo.NQPauliOp(b, sb), \
            jpo.NQPauliOp(a, sa), jpo.NQPauliOp(b, sb)
        assert ta.commuteswith(tb) == ja.commuteswith(jb)
        assert str(ta.icommutator_over_2(tb)) == str(ja.icommutator_over_2(jb))
        assert ta.dot(tb) == ja.dot(jb) and str(ta.subpauli([0, 2])) == str(ja.subpauli([0, 2]))
        st = ''.join(rng.choice(list('XYZ'), 3))
        ss = tuple(rng.choice([1, -1], 3))
        assert ta.statedot(tpo.NQPauliState(st, ss)) == ja.statedot(jpo.NQPauliState(st, ss))
    basis = {'+X': ('Gypi2',), '-X': ('Gympi2',), '+Y': ('Gxmpi2',), '-Y': ('Gxpi2',),
             '+Z': (), '-Z': ('Gxpi',)}
    assert tpo.NQPauliState('XZ', (1, -1)).to_circuit(basis).str == \
        jpo.NQPauliState('XZ', (1, -1)).to_circuit(basis).str
    assert str(tpo.NQOutcome('010').flip(0, 1)) == str(jpo.NQOutcome('010').flip(0, 1)) == '100'


@pytest.mark.parametrize("mw", [1, 2])
def test_idttools_match_jax(mw):
    assert [str(e) for e in ttools.allerrors(4, mw)] == [str(e) for e in jtools.allerrors(4, mw)]
    p, m = ('XYZX', (1, 1, -1, 1)), ('XYZX', (1, -1, -1, 1))
    assert [str(o) for o in ttools.alloutcomes(tpo.NQPauliState(*p), tpo.NQPauliState(*m), mw)] \
        == [str(o) for o in jtools.alloutcomes(jpo.NQPauliState(*p), jpo.NQPauliState(*m), mw)]
    assert [str(o) for o in ttools.allobservables(tpo.NQPauliState('XZYY'), mw)] == \
        [str(o) for o in jtools.allobservables(jpo.NQPauliState('XZYY'), mw)]
    assert ttools.nontrivial_paulis(mw) == jtools.nontrivial_paulis(mw)
    base_t = [(tpo.NQPauliState('XY'[:mw], (1,) * mw), tpo.NQPauliState('XY'[:mw], (-1,) * mw))]
    base_j = [(jpo.NQPauliState('XY'[:mw], (1,) * mw), jpo.NQPauliState('XY'[:mw], (-1,) * mw))]
    assert [_key(f) for f in ttools.tile_pauli_fidpairs(base_t, 4, mw)] == \
        [_key(f) for f in jtools.tile_pauli_fidpairs(base_j, 4, mw)]
    with pytest.raises(NotImplementedError):
        ttools.allerrors(2, 3)


@pytest.mark.parametrize("nq,mw", [(1, 1), (2, 1), (2, 2), (3, 2)])
def test_fidpairs_and_lists_match_jax(nq, mw):
    assert [_key(f) for f in tidt.idle_tomography_fidpairs(nq, mw)] == \
        [_key(f) for f in jidt.idle_tomography_fidpairs(nq, mw)]
    assert tidt.preferred_signs_from_paulidict(PREP_DICT) == \
        jidt.preferred_signs_from_paulidict(PREP_DICT)
    mine = tidt.make_idle_tomography_list(nq, [0, 1, 4], DICTS, maxweight=mw)
    ref = jidt.make_idle_tomography_list(nq, [0, 1, 4], DICTS, maxweight=mw)
    assert [c.str for c in mine] == [c.str for c in ref]
    lists = tidt.make_idle_tomography_lists(nq, [0, 2], DICTS, maxweight=mw,
                                            include_affine=False)
    assert [[c.str for c in l] for l in lists] == \
        [[c.str for c in l] for l in jidt.make_idle_tomography_lists(
            nq, [0, 2], DICTS, maxweight=mw, include_affine=False)]
    circ_pairs = [(tpo.NQPauliState(p.rep, p.signs).to_circuit(PREP_DICT),
                   tpo.NQPauliState(m.rep, m.signs).to_circuit(MEAS_DICT))
                  for p, m in tidt.idle_tomography_fidpairs(nq, mw)]
    back = tidt.fidpairs_to_pauli_fidpairs(circ_pairs, DICTS, nq)
    jback = jidt.fidpairs_to_pauli_fidpairs(
        [(JCircuit(a.str), JCircuit(b.str)) for a, b in circ_pairs], DICTS, nq)
    assert [_key(f) for f in back] == [_key(f) for f in jback]


def test_determine_paulidicts_matches_jax():
    assert tidt.determine_paulidicts(tmp1.target_model('static')) == \
        jidt.determine_paulidicts(jmp1.target_model('static'))
    assert tidt.determine_paulidicts(tmp2.target_model('static')) is None


@pytest.mark.parametrize("nq,mw,kw", [
    (1, 1, {}), (1, 1, {'advanced_options': {'jacobian mode': 'together'}}),
    (2, 2, {}), (2, 1, {'include_hamiltonian': False, 'include_affine': False})])
def test_do_idle_tomography_matches_jax(nq, mw, kw):
    """The same counts through both packages: every intrinsic and observed
    rate within 1e-10 (the cases of tests/test_idt_functional.py)."""
    max_lengths = [0, 1, 2, 4]
    list_kw = {k: v for k, v in kw.items() if k != 'advanced_options'}
    circuits = tidt.make_idle_tomography_list(nq, max_lengths, DICTS, maxweight=mw, **list_kw)
    ds = simulate_data(_idle_model(nq, ham_z=0.01, sto_z=0.005, sto_zz=0.004 * (nq > 1)),
                       circuits, 20000, seed=7, device='cpu')
    t = tidt.do_idle_tomography(nq, ds, max_lengths, DICTS, maxweight=mw, **kw)
    j = jidt.do_idle_tomography(nq, _jax_ds(ds), max_lengths, DICTS, maxweight=mw, **kw)
    assert sorted(t.intrinsic_rates) == sorted(j.intrinsic_rates)
    for typ in t.intrinsic_rates:
        assert np.max(np.abs(t.intrinsic_rates[typ] - j.intrinsic_rates[typ])) < 1e-10
    for typ in t.observed_rate_infos:
        for ti, ji in zip(t.observed_rate_infos[typ], j.observed_rate_infos[typ]):
            assert [str(k) for k in ti] == [str(k) for k in ji]
            assert max(abs(a['rate'] - b['rate']) for a, b in zip(ti.values(), ji.values())) \
                < 1e-10
    assert [str(e) for e in t.error_list] == [str(e) for e in j.error_list]
    assert "Intrinsic" in str(t)
    if nq == 1 and not kw:
        rates = dict(zip([str(e) for e in t.error_list], t.intrinsic_rates['hamiltonian']))
        assert abs(rates['Z'] - 2 * 0.01) < 0.004, rates


@pytest.mark.parametrize("nq,mw", [(1, 1), (2, 2)])
def test_idle_tomography_protocol_matches_jax(nq, mw):
    """The numerical design's circuits and the protocol's per-qubit and
    pair rates on the same counts within 1e-10."""
    qubits = tuple(range(nq))
    td = tidt.IdleTomographyDesign(qubits, max_lengths=(0, 1, 2, 4), maxweight=mw)
    jd = jidt.IdleTomographyDesign(qubits, max_lengths=(0, 1, 2, 4), maxweight=mw)
    assert [c.str for c in td.all_circuits_needing_data] == \
        [c.str for c in jd.all_circuits_needing_data]
    ds = simulate_data(_idle_model(nq, ham_z=0.01, sto_z=0.006, sto_zz=0.005 * (nq > 1)),
                       td.all_circuits_needing_data, 50000, seed=3, device='cpu')
    t = tidt.IdleTomography().run(ProtocolData(td, ds))
    j = jidt.IdleTomography().run(JData(jd, _jax_ds(ds)))
    for q in qubits:
        assert list(t.intrinsic_rates[q]) == list(j.intrinsic_rates[q])
        assert max(abs(t.intrinsic_rates[q][k] - j.intrinsic_rates[q][k])
                   for k in t.intrinsic_rates[q]) < 1e-10
    for pair in t.pair_rates:
        assert max(abs(v - j.pair_rates[pair][k]) for k, v in t.pair_rates[pair].items()) < 1e-10
    assert list(t.pair_rates) == list(j.pair_rates)
    if nq == 2:
        pr = t.pair_rates[(0, 1)]
        assert np.isclose(pr[('S', ('Z', 'Z'))], 0.005, rtol=0.3), pr
    via = tidt.run_idle_tomography_protocol(nq, ds, (0, 1, 2, 4), maxweight=mw)
    assert via.intrinsic_rates[0] == t.intrinsic_rates[0]
    assert "Idle tomography" in str(t)


def _bridged_models(nq, mw):
    t = (tmp1 if nq == 1 else tmp2).target_model('static')
    j = (jmp1 if nq == 1 else jmp2).target_model('static')
    t.operations[Label(())] = ExpErrorgenOp(build_lindblad_errorgen('pp', 'H+s', dim=4 ** nq,
                                                                    max_weight=mw))
    j.operations[JLabel(())] = JExp(j_build('pp', 'H+s', dim=4 ** nq, max_weight=mw))
    return t, j


def test_model_bridges_match_jax():
    t, j = _bridged_models(2, 2)
    rates = {"H(ZI)": 0.02, "S(IX)": 0.01, "S(ZI)": 0.004, "S(ZZ)": 0.003, "H(XY)": -0.002}
    ttools.set_idle_errors(2, t, rates)
    jtools.set_idle_errors(2, j, rates)
    np.testing.assert_allclose(t.to_vector(), np.asarray(j.to_vector()), rtol=0, atol=1e-15)
    th, ts, _ = ttools.extract_idle_errors(2, t)
    jh, js, _ = jtools.extract_idle_errors(2, j)
    assert th == pytest.approx(jh, abs=1e-14) and ts == pytest.approx(js, abs=1e-14)
    assert abs(th['ZI'] - 0.02) < 1e-10 and abs(ts['ZZ'] - 0.003) < 1e-10
    for a, b in zip(ttools.predicted_intrinsic_rates(2, 2, t),
                    jtools.predicted_intrinsic_rates(2, 2, j)):
        if a is None:
            assert b is None
        else:
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-14)
    np.random.seed(5)
    r_t = ttools.set_idle_errors(2, t, {}, rand_default=0.01)
    np.random.seed(5)
    r_j = jtools.set_idle_errors(2, j, {}, rand_default=0.01)
    np.testing.assert_array_equal(r_t, r_j)


def test_predicted_observable_rates_match_jax():
    t, j = _bridged_models(1, 1)
    ttools.set_idle_errors(1, t, {"S(Z)": 0.01, "H(X)": 0.005})
    jtools.set_idle_errors(1, j, {"S(Z)": 0.01, "H(X)": 0.005})
    max_lengths = [0, 1, 2, 4]
    circuits = tidt.make_idle_tomography_list(1, max_lengths, DICTS, maxweight=1)
    ds = simulate_data(t, circuits, 100000, seed=13, device='cpu')
    res_t = tidt.do_idle_tomography(1, ds, max_lengths, DICTS, maxweight=1)
    res_j = jidt.do_idle_tomography(1, _jax_ds(ds), max_lengths, DICTS, maxweight=1)
    for typ in ('samebasis', 'diffbasis'):
        pt = ttools.predicted_observable_rates(res_t, typ, 1, 1, t)
        pj = jtools.predicted_observable_rates(res_j, typ, 1, 1, j)
        vt = [v for d in pt.values() for v in d.values()]
        vj = [v for d in pj.values() for v in d.values()]
        np.testing.assert_allclose(vt, vj, rtol=0, atol=1e-14)
        obs = [info['rate'] for infos in res_t.observed_rate_infos[typ] for info in infos.values()]
        assert np.max(np.abs(np.array(obs) - np.array(vt))) < 0.003
    with pytest.raises(ValueError):
        ttools.predicted_observable_rates(res_t, 'other', 1, 1, t)
