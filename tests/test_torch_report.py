"""The port's reports against the JAX package's, on the CPU in float64:
the reportable functions, the tables behind the standard report with their
confidence-region error bars, the two HTML pages, the PDF summary and the
notebook (smq1Q_XYI 'full TP', maxL [1, 2], the same model parameters and
counts in both packages; no GST fit in either).

Tolerances: reportable values 1e-10 (the half diamond norm, an optimizer's
maximum, 1e-8; the POVM entanglement infidelity of a POVM whose map is not
CP, 1e-8); error bars 1e-4 relative, the half diamond norm's 1e-3
against the JAX package's: the JAX package differences the full diamond
norm, whose optimizer stops at a gradient of about 1e-5, and its bar is off
a precise one (central differences of the polished maximum) by up to 4e-4;
the port's, from its linearization at the polished maximizer (ROADMAP.md
section 3), is held to the precise one at 1e-4.  Page numbers within one
unit of their last printed digit.  The JAX package's
reportables.generator_infidelity projects onto the generators of the
normalized 'pp' elements and disagrees with its own
optools.generator_infidelity, which the port's reportable calls (ROADMAP.md
section 3): the comparisons hold the port against the latter.
"""

import json
import re

import numpy as np
import pytest
import scipy.linalg as spl
import scipy.stats
import torch

import pygsti_tpu.modelpacks.smq1Q_XYI as jmp
from pygsti_tpu.circuits import Circuit as JCircuit
from pygsti_tpu.data import simulate_data as j_simulate
from pygsti_tpu.protocols.confidenceregionfactory import ConfidenceRegionFactory as JCRF
from pygsti_tpu.protocols.estimate import Estimate as JEstimate
from pygsti_tpu.protocols.gst import ModelEstimateResults as JResults
from pygsti_tpu.protocols.gst import StandardGSTDesign as JDesign
from pygsti_tpu.protocols.protocol import Protocol as JProtocol
from pygsti_tpu.protocols.protocol import ProtocolData as JData
from pygsti_tpu.report import factory as jfactory
from pygsti_tpu.report import reportables as jr
from pygsti_tpu.tools import optools as jot

import pygsti_tpu_torch.modelpacks.smq1Q_XYI as tmp
from pygsti_tpu_torch.circuits.circuit import Circuit
from pygsti_tpu_torch.data.dataset import DataSet
from pygsti_tpu_torch.objectivefns.objectivefns import (RawPoissonPicDeltaLogLFunction,
                                                        TimeIndependentMDCObjectiveFunction)
from pygsti_tpu_torch.protocols.confidenceregionfactory import ConfidenceRegionFactory as TCRF
from pygsti_tpu_torch.protocols.estimate import Estimate as TEstimate
from pygsti_tpu_torch.protocols.gst import ModelEstimateResults as TResults
from pygsti_tpu_torch.protocols.gst import StandardGSTDesign as TDesign
from pygsti_tpu_torch.protocols.protocol import Protocol as TProtocol
from pygsti_tpu_torch.protocols.protocol import ProtocolData as TData
from pygsti_tpu_torch.report import factory as tfactory
from pygsti_tpu_torch.report import reportables as tr
from pygsti_tpu_torch.tools import optools as tot
from pygsti_tpu_torch.tools import sdptools

TOL = 1e-10
POVM_TOL = 1e-8
EB_RTOL = 1e-4
DIAMOND_EB_RTOL = 1e-3
METRICS = ('entanglement_infidelity', 'avg_gate_infidelity', 'half_diamond_norm',
           'jtrace_diff', 'frobenius_diff', 'eigenvalue_entanglement_infidelity',
           'nonunitary_entanglement_infidelity', 'generator_infidelity', 'unitarity')


@pytest.fixture(scope='module', autouse=True)
def one_thread():
    """torch on one thread in this module, beside the other test processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def jax_optools_geninf(monkeypatch):
    """The JAX package's reports with its optools' generator infidelity."""
    monkeypatch.setattr(jr, 'generator_infidelity', jot.generator_infidelity)


def close(a, b, tol=TOL):
    """Values (scalars, arrays, dicts of them) equal within `tol` relative
    to max(1, |b|); nan where the other is nan."""
    if isinstance(b, dict):
        return set(a) == set(b) and all(close(a[k], b[k], tol) for k in b)
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape:
        return False
    if b.dtype.kind not in 'fc':
        return bool(np.all(a == b))
    both_nan = np.isnan(a) & np.isnan(b)
    diff = np.where(both_nan, 0.0, np.abs(a - b))
    scale = np.abs(np.where(both_nan, 0.0, b))
    return bool(np.all(diff <= tol * max(1.0, float(np.max(scale, initial=0.0)))))


# -- reportable functions on seeded channels ---------------------------------

def _channels(d2, seed):
    """(a, b): b a random unitary channel, a = b after a small random
    rotation and a depolarization (the 'pp' basis)."""
    rng = np.random.RandomState(seed)
    d = int(np.sqrt(d2))
    b = tot.unitary_to_superop(scipy.stats.unitary_group.rvs(d, random_state=rng), 'pp').real
    h = rng.randn(d, d) + 1j * rng.randn(d, d)
    small = tot.unitary_to_superop(spl.expm(-0.05j * (h + h.conj().T)), 'pp').real
    dep = np.diag([1.0] + [0.97] * (d2 - 1))
    return dep @ small @ b, b


AB_FNS = ['entanglement_fidelity', 'entanglement_infidelity', 'avg_gate_infidelity',
          'process_fidelity', 'frobenius_diff', 'jtrace_diff', 'std_unitarity',
          'nonunitary_entanglement_infidelity', 'nonunitary_avg_gate_infidelity',
          'eigenvalue_nonunitary_entanglement_infidelity',
          'eigenvalue_nonunitary_avg_gate_infidelity', 'eigenvalue_entanglement_infidelity',
          'eigenvalue_avg_gate_infidelity', 'eigenvalue_diamondnorm',
          'eigenvalue_nonunitary_diamondnorm', 'rel_eigenvalues', 'rel_gate_eigenvalues',
          'rel_log_tig_eigenvalues', 'rel_log_gti_eigenvalues', 'rel_log_diff_eigenvalues',
          'closest_unitary_fidelity', 'model_model_angles_btwn_axes', 'error_generator',
          'log_tig_and_projections', 'log_gti_and_projections', 'log_diff_and_projections']
A_FNS = ['eigenvalues', 'choi_matrix', 'choi_eigenvalues', 'choi_trace',
         'upper_bound_fidelity', 'closest_ujmx', 'maximum_fidelity', 'maximum_trace_dist',
         'unitarity', 'decomposition', 'gate_rotation_angle']


@pytest.mark.parametrize("d2", [4, 16])
@pytest.mark.parametrize("name", AB_FNS + A_FNS + ['eigenvalue_unitarity'])
def test_gate_reportables_match_jax(name, d2):
    a, b = _channels(d2, 7 + d2)
    if name in A_FNS:
        args = (a,) if name == 'decomposition' else (a, 'pp')
    elif name == 'eigenvalue_unitarity':
        args = (a, b)
    else:
        args = (a, b, 'pp')
    assert close(getattr(tr, name)(*args), getattr(jr, name)(*args)), name


@pytest.mark.parametrize("d2", [4, 16])
def test_generator_infidelity_is_optools(d2):
    """The port's reportable is optools.generator_infidelity, equal to the
    JAX package's optools one; the JAX package's reportable projects onto
    generators of the normalized 'pp' elements, which scales H by 2 and S by
    2 per qubit (ROADMAP.md section 3)."""
    a, b = _channels(d2, 3 + d2)
    t = tr.generator_infidelity(a, b, 'pp')
    assert abs(t - jot.generator_infidelity(a, b, 'pp')) < TOL
    assert abs(t - jr.generator_infidelity(a, b, 'pp')) > 0.3 * abs(t)


def test_half_diamond_norm_matches_jax():
    a, b = _channels(4, 11)
    assert abs(tr.half_diamond_norm(a, b, 'pp') - jr.half_diamond_norm(a, b, 'pp')) < 1e-8


def test_circuit_and_model_reportables_match_jax(pair, jax_optools_geninf):
    """Every circuit metric on a germ power, the model-level metrics, the
    rotation-axis angles and the general decomposition on the pair's
    fitted and target models."""
    jm, tm = pair['jmodels']['stdgaugeopt'], pair['tmodels']['stdgaugeopt']
    jt, tt = pair['jmodels']['target'], pair['tmodels']['target']
    cstr = 'Gxpi2:0Gypi2:0Gxpi2:0Gxpi2:0@(0)'
    names = [n for n in dir(tr) if n.startswith('circuit_') and callable(getattr(tr, n))]
    assert len(names) == 14
    for n in names:
        tol = 1e-8 if 'half_diamond' in n else TOL
        assert close(getattr(tr, n)(tm, tt, Circuit(cstr)),
                     getattr(jr, n)(jm, jt, JCircuit(cstr)), tol), n
    assert close(tr.rel_circuit_eigenvalues(tm, tt, Circuit(cstr)),
                 jr.rel_circuit_eigenvalues(jm, jt, JCircuit(cstr)))
    for n in ('average_gateset_infidelity', 'predicted_rb_number', 'general_decomposition'):
        assert close(getattr(tr, n)(tm, tt), getattr(jr, n)(jm, jt)), n
    assert close(tr.angles_btwn_rotn_axes(tm), jr.angles_btwn_rotn_axes(jm))
    assert close(tr.CircuitEigenvalues(tm, Circuit(cstr)).evaluate(tm),
                 jr.CircuitEigenvalues(jm, JCircuit(cstr)).evaluate(jm))
    assert abs(tr.CircuitHalfDiamondNorm(tm, tt, Circuit(cstr)).evaluate(tm)
               - jr.CircuitHalfDiamondNorm(jm, jt, JCircuit(cstr)).evaluate(jm)) < 1e-8
    for lbl in tm.operations:
        assert close(tr.GateEigenvalues(tm, lbl).evaluate(tm),
                     jr.GateEigenvalues(jm, lbl).evaluate(jm))
    idles = ['Gxpi2:0' * 4 + '@(0)', 'Gypi2:0' * 4 + '@(0)',
             'Gxpi2:0Gxpi2:0Gypi2:0Gypi2:0' * 2 + '@(0)']
    rt = tr.robust_log_gti_and_projections(tm, tt, [Circuit(s) for s in idles])
    rj = jr.robust_log_gti_and_projections(jm, jt, [JCircuit(s) for s in idles])
    assert close(rt, rj, 1e-9)


def test_spam_reportables_match_jax(pair):
    jm, tm = pair['jmodels']['stdgaugeopt'], pair['tmodels']['stdgaugeopt']
    jt, tt = pair['jmodels']['target'], pair['tmodels']['target']
    ra, rb = tm.preps['rho0'].dense(), tt.preps['rho0'].dense()
    for n in ('vec_fidelity', 'vec_infidelity', 'vec_trace_diff'):
        assert close(getattr(tr, n)(ra, rb, 'pp'), getattr(jr, n)(ra, rb, 'pp')), n
    for n in ('vec_as_stdmx', 'vec_as_stdmx_eigenvalues'):
        assert close(getattr(tr, n)(ra, 'pp'), getattr(jr, n)(ra, 'pp')), n
    assert close(tr.spam_dotprods(list(tm.preps.values()), list(tm.povms.values())),
                 jr.spam_dotprods(list(jm.preps.values()), list(jm.povms.values())))
    # the fitted POVM's map has a Choi matrix with negative eigenvalues (1e-3),
    # where sqrtm in the fidelity turns the one-ulp difference of its last
    # effect (the identity less the others, summed in another order) into 5e-9
    for n, tol in (('povm_entanglement_infidelity', POVM_TOL), ('povm_jtrace_diff', TOL)):
        assert close(getattr(tr, n)(tm, tt, 'Mdefault'), getattr(jr, n)(jm, jt, 'Mdefault'),
                     tol), n
    for n in ('povm_half_diamond_norm', 'POVM_half_diamond_norm'):
        assert abs(getattr(tr, n)(tm, tt, 'Mdefault')
                   - getattr(jr, n)(jm, jt, 'Mdefault')) < 1e-8, n


def test_instrument_reportables_match_jax():
    from test_torch_instruments import models as instrument_models
    jm, tm = instrument_models(1, depol=0.02)
    jt, tt = instrument_models(1)
    for n in ('instrument_infidelity', 'instrument_half_diamond_norm'):
        tol = 1e-8 if 'diamond' in n else TOL
        assert abs(getattr(tr, n)(tm, tt, ('Iz', 0)) - getattr(jr, n)(jm, jt, ('Iz', 0))) < tol
        short = n.replace('instrument_', '').replace('_', ' ')
        assert abs(tr.evaluate_instrumentfn_by_name(short, tm, tt, ('Iz', 0))
                   - jr.evaluate_instrumentfn_by_name(short, jm, jt, ('Iz', 0))) < tol


@pytest.mark.parametrize("theta", [0.0, 0.2])
def test_leakage_reportables_match_jax(theta):
    """On a 3-level gate coupling |1> and |2>: the subspace metrics in 'gm'
    and the leak and seep rates in the leakage basis 'l2p1'."""
    from test_torch_leakage import _leaky_x
    from pygsti_tpu_torch.tools.basistools import change_basis
    g = np.real(tot.unitary_to_superop(_leaky_x(theta), 'gm'))
    t = np.real(tot.unitary_to_superop(_leaky_x(0.0), 'gm'))
    assert close(tr.leaky_entanglement_infidelity(g, t, 'gm'),
                 jr.leaky_entanglement_infidelity(g, t, 'gm'))
    assert close(tr.leaky_maximum_trace_dist(g, 'gm'), jr.leaky_maximum_trace_dist(g, 'gm'))
    gl = np.real(change_basis(g, 'gm', 'l2p1'))
    for n in ('pergate_leakrate_max', 'pergate_leakrate_min', 'pergate_seeprate'):
        for basis, mx in (('l2p1', gl), ('gm', g)):      # 'gm' implies no leakage: nan
            assert close(getattr(tr, n)(mx, None, basis), getattr(jr, n)(mx, None, basis)), n
    assert np.isnan(tr.pergate_leakrate_max(g, None, 'gm'))
    if theta:
        assert tr.pergate_leakrate_max(gl, None, 'l2p1') > 1e-3
    with pytest.raises(ImportError):
        tr.diamonddist_to_leakfree_cptp(g, None, 'gm')


# -- results of both packages, the confidence region, the tables ---------------

def _models(pkg, theta):
    f, g = pkg.target_model('full TP'), pkg.target_model('full TP')
    f.from_vector(theta)
    g.from_vector(theta + 1e-3 * np.random.RandomState(1).randn(len(theta)))
    return {'target': pkg.target_model('full TP'), 'seed': pkg.target_model('full TP'),
            'iteration 0 estimate': f, 'iteration 1 estimate': f,
            'final iteration estimate': f, 'stdgaugeopt': g}


@pytest.fixture(scope='module')
def pair():
    """Both packages' GST results of one estimate built from the same
    parameters (no fit): counts of the depolarized target, 'final iteration
    estimate' 1e-3 away from that model, 'stdgaugeopt' 1e-3 further."""
    jd = JDesign(jmp.target_model('full TP'), jmp.prep_fiducials(), jmp.meas_fiducials(),
                 jmp.germs(), [1, 2])
    td = TDesign(tmp.target_model('full TP'), tmp.prep_fiducials(), tmp.meas_fiducials(),
                 tmp.germs(), [1, 2])
    datagen = jmp.target_model('full TP').depolarize(op_noise=0.03, spam_noise=0.01)
    jds = j_simulate(datagen, jd.all_circuits_needing_data, 1000, seed=3)
    tds = DataSet()
    for jc, tc in zip(jd.all_circuits_needing_data, td.all_circuits_needing_data):
        assert jc.str == tc.str
        tds.add_count_dict(tc, dict(jds[jc].counts))
    theta = datagen.to_vector() + 1e-3 * np.random.RandomState(0).randn(datagen.num_params)
    jmodels, tmodels = _models(jmp, theta), _models(tmp, theta)
    final = list(td.circuit_lists[-1])
    obj = TimeIndependentMDCObjectiveFunction(RawPoissonPicDeltaLogLFunction(),
                                              tmodels['final iteration estimate'], tds, final,
                                              device='cpu')
    params = {'final_objfn_value': 2 * obj.fn(),
              'final_dof': tds.degrees_of_freedom(final) - len(theta),
              'raw_objective_values': [[41.5, 40.25], [80.125]]}
    jres = JResults(JData(jd, jds), JProtocol('GST'))
    jres.add_estimate(JEstimate(jres, jmodels, dict(params)), 'GST')
    tres = TResults(TData(td, tds), TProtocol('GST'))
    tres.add_estimate(TEstimate(tres, tmodels, dict(params), device='cpu'), 'GST')
    return dict(jres=jres, tres=tres, jmodels=jmodels, tmodels=tmodels, jds=jds, tds=tds,
                params=params)


@pytest.fixture(scope='module')
def views(pair):
    """95% views of each package's Gauss-Newton Hessian, 'std' projected."""
    out = []
    for res, cls in ((pair['jres'], JCRF), (pair['tres'], TCRF)):
        crf = res.estimates['GST'].create_confidence_region_factory()
        crf.compute_hessian(approximate=True)
        crf.project_hessian('std')
        out.append(crf.view(95))
    return tuple(out)


@pytest.fixture(scope='module')
def tables(pair, views):
    """gate_metrics_table and spam_metrics_table with error bars in both
    packages (the JAX package's with its optools' generator infidelity)."""
    jm, tm = pair['jmodels'], pair['tmodels']
    saved = jr.generator_infidelity
    jr.generator_infidelity = jot.generator_infidelity
    try:
        jg = jr.gate_metrics_table(jm['stdgaugeopt'], jm['target'], METRICS, views[0])
    finally:
        jr.generator_infidelity = saved
    tg = tr.gate_metrics_table(tm['stdgaugeopt'], tm['target'], METRICS, views[1])
    js = jr.spam_metrics_table(jm['stdgaugeopt'], jm['target'], views[0])
    ts = tr.spam_metrics_table(tm['stdgaugeopt'], tm['target'], views[1])
    return jg, tg, js, ts


def _same_cell(t, j, eb_rtol=EB_RTOL):
    if isinstance(j, tuple):
        return isinstance(t, tuple) and close(t[0], j[0]) and t[1] > 0 \
            and abs(t[1] - j[1]) <= eb_rtol * abs(j[1])
    return not isinstance(t, tuple) and close(t, j)


@pytest.mark.parametrize("metric", METRICS)
def test_gate_metrics_table_with_error_bars(tables, metric):
    """Values within 1e-10, error bars within 1e-4 relative; every metric
    but unitarity carries one."""
    jg, tg = tables[0], tables[1]
    assert [str(k) for k in tg] == [str(k) for k in jg]
    for (lbl, trow), jrow in zip(tg.items(), jg.values()):
        assert list(trow) == list(jrow)
        assert isinstance(trow[metric], tuple) == (metric != 'unitarity')
        rtol = DIAMOND_EB_RTOL if metric == 'half_diamond_norm' else EB_RTOL
        assert _same_cell(trow[metric], jrow[metric], rtol), (lbl, trow[metric], jrow[metric])


def test_spam_metrics_table_with_error_bars(tables):
    js, ts = tables[2], tables[3]
    assert [(k, str(lbl)) for k, lbl in ts] == [(k, str(lbl)) for k, lbl in js]
    for (kind, _), trow, jrow in zip(ts, ts.values(), js.values()):
        assert list(trow) == list(jrow)
        if kind == 'povm':    # as in test_spam_reportables_match_jax
            assert close(trow['entanglement_infidelity'], jrow['entanglement_infidelity'],
                         POVM_TOL)
            assert close(trow['frobenius_diff'], jrow['frobenius_diff'])
        else:
            assert all(_same_cell(trow[m], jrow[m]) for m in jrow)


def test_other_tables_match_jax(pair):
    jm, tm = pair['jmodels'], pair['tmodels']
    germs_t, germs_j = tmp.germs(), jmp.germs()
    for n, args in (('errorgen_projections_table', ()), ('gate_decomposition_table', ())):
        a = getattr(tr, n)(tm['stdgaugeopt'], tm['target'], *args)
        b = getattr(jr, n)(jm['stdgaugeopt'], jm['target'], *args)
        assert [str(k) for k in a] == [str(k) for k in b]
        assert all(close(x, y) for x, y in zip(a.values(), b.values())), n
    a = tr.germ_amplified_metrics_table(tm['stdgaugeopt'], tm['target'], germs_t)
    b = jr.germ_amplified_metrics_table(jm['stdgaugeopt'], jm['target'], germs_j)
    assert [g.str for g in a] == [g.str for g in b]
    assert all(close(x, y) for x, y in zip(a.values(), b.values()))
    assert tr.model_violation_table(pair['tres']) == jr.model_violation_table(pair['jres'])
    for name in ('inf', 'agi', 'trace', 'nuinf', 'evinf', 'evdiamond', 'frob'):
        assert close(tr.evaluate_opfn_by_name(name, tm['stdgaugeopt'], tm['target'],
                                              Circuit('Gxpi2:0Gypi2:0@(0)')),
                     jr.evaluate_opfn_by_name(name, jm['stdgaugeopt'], jm['target'],
                                              JCircuit('Gxpi2:0Gypi2:0@(0)'))), name
        assert tr.info_of_opfn_by_name(name)[1] == jr.info_of_opfn_by_name(name)[1]


# -- (a) dependency-restricted differences, (b) the diamond norm's linearization --

@pytest.mark.parametrize("metric", [m for m in METRICS if m != 'unitarity'])
def test_model_function_error_bar_is_the_all_parameter_one(pair, views, metric):
    """A ModelFunction differences only its gate's parameters; the plain
    callable of the same function differences all of them: the same error
    bar, bit for bit."""
    tm = pair['tmodels']
    model, target, view = tm['stdgaugeopt'], tm['target'], views[1]
    lbl = ('Gxpi2', 0)
    mfn = tr.HalfDiamondNorm(model, target, lbl) if metric == 'half_diamond_norm' else \
        tr._GateMetric(model, tr._GATE_METRICS[metric], target.operations[lbl].dense(), lbl,
                       model.basis)
    mfn.evaluate(model)
    assert len(mfn.parameter_indices(model)) == model.operations[lbl].num_params < model.num_params
    restricted = view.compute_uncertainty(mfn, model)
    everything = view.compute_uncertainty(lambda m: mfn.evaluate_nearby(m), model)
    assert restricted == everything and restricted > 0


def test_diamond_norm_error_bar(pair, views, tables):
    """(b) at 1 qubit, Gxpi2:0: HalfDiamondNorm's error bar, from forward
    differences of the trace norm at the maximizer, within 1e-4 of the bar
    from central differences (h 1e-5) of the polished maximum; the JAX
    package's forward differences of the full maximization within 1e-3 of
    both (its optimizer's noise)."""
    tm, view = pair['tmodels'], views[1]
    model, target, lbl = tm['stdgaugeopt'], tm['target'], ('Gxpi2', 0)
    v0, work = model.to_vector(), model.copy()
    grad = np.zeros(len(v0))
    for i in np.arange(len(v0))[model.operations[lbl].gpindices]:
        ends = []
        for h in (1e-5, -1e-5):
            v = v0.copy()
            v[i] += h
            work.from_vector(v)
            ends.append(0.5 * maximum(work.operations[lbl].dense()
                                      - target.operations[lbl].dense()))
        grad[i] = (ends[0] - ends[1]) / 2e-5
    precise = np.sqrt(view._C1 * grad @ view._inv_hessian() @ grad)
    t = dict(zip(map(str, tables[1]), tables[1].values()))['Gxpi2:0']['half_diamond_norm'][1]
    j = dict(zip(map(str, tables[0]), tables[0].values()))['Gxpi2:0']['half_diamond_norm'][1]
    assert abs(t - precise) <= EB_RTOL * precise, (t, precise)
    assert abs(j - precise) <= DIAMOND_EB_RTOL * precise and abs(t - j) <= DIAMOND_EB_RTOL * j


def maximum(L):
    """The diamond norm of L maximized and polished: the trace norm at the
    polished input."""
    _, psi = sdptools.diamond_norm(L, 'pp', return_x=True)
    return sdptools.trace_norm_at_input(L, psi, 'pp')


def test_diamond_norm_linearization_derivatives_at_d16():
    """Danskin: along 3 seeded directions the derivative of the trace norm
    at the fixed maximizer equals central differences (h 1e-5) of the full
    maximization, polished, within 1e-4 relative.  (The unpolished
    maximum's noise, up to 1e-4 of the norm at d 16, would swamp them.)"""
    a, b = _channels(16, 5)
    dist, psi = tot.diamonddist(a, b, 'pp', return_x=True)
    assert dist == tot.diamonddist(a, b, 'pp')
    assert 0 <= sdptools.trace_norm_at_input(a - b, psi, 'pp') - dist < 1e-6 * dist
    rng = np.random.RandomState(2026)
    h = 1e-5
    for _ in range(3):
        u = rng.randn(16, 16)
        u /= np.linalg.norm(u)
        lin = (sdptools.trace_norm_at_input(a + h * u - b, psi, 'pp')
               - sdptools.trace_norm_at_input(a - h * u - b, psi, 'pp')) / (2 * h)
        full = (maximum(a + h * u - b) - maximum(a - h * u - b)) / (2 * h)
        assert abs(lin - full) <= 1e-4 * abs(full), (lin, full)


# -- the pages ------------------------------------------------------------------

_NUMBER = re.compile(r'(-?\d+(?:\.\d+)?(?:e[+-]?\d+)?)')


def _unit(s):
    """One unit of the last printed digit of the number string `s`."""
    mant, _, exp = s.partition('e')
    decimals = len(mant.partition('.')[2])
    return 10.0 ** (int(exp or 0) - decimals)


def same_page(t, j):
    """The same text, with each number within one unit of its last printed
    digit (or equal where one page prints more digits)."""
    ta, ja = _NUMBER.split(t), _NUMBER.split(j)
    if len(ta) != len(ja):
        return False
    for i, (x, y) in enumerate(zip(ta, ja)):
        if i % 2 == 0:
            if x != y:
                return False
        elif x != y and abs(float(x) - float(y)) > max(_unit(x), _unit(y)) * (1 + 1e-9):
            return False
    return True


def _sections(page):
    """The page split at its headings, the Metadata section left out."""
    body = page[:page.index('<h2>Metadata</h2>')]
    return re.split(r'(?=<h[1-4]>)', body)


@pytest.fixture(scope='module')
def pages(pair, tmp_path_factory):
    d = tmp_path_factory.mktemp('pages')
    saved = jr.generator_infidelity
    jr.generator_infidelity = jot.generator_infidelity
    try:
        jfactory.construct_standard_report(pair['jres'], "R", confidence_level=95) \
            .write_html(str(d / 'j.html'))
    finally:
        jr.generator_infidelity = saved
    report = tfactory.construct_standard_report(pair['tres'], "R", confidence_level=95)
    report.write_html(str(d / 't.html'))
    return (d / 't.html').read_text(), (d / 'j.html').read_text(), report


def test_pages_match_jax(pages):
    """The same sections, headers and rows in the same order, each printed
    number within one unit of its last digit; error bars in every gate
    metric but unitarity."""
    t, j, _ = pages
    ts, js = _sections(t), _sections(j)
    assert [s[:60] for s in ts] == [s[:60] for s in js]
    for a, b in zip(ts, js):
        assert same_page(a, b), (a[:300], b[:300])
    assert 'unavailable' not in t
    gates = t[t.index('Per-gate metrics'):]
    gates = gates[:gates.index('</table>')]
    for row in re.findall(r'<tr><td class="lbl">.*?</tr>', gates):
        cells = re.findall(r'<td[^>]*>(.*?)</td>', row)[1:]
        assert ['&plusmn;' in c for c in cells] == [True] * 8 + [False]
    assert 'pygsti_tpu_torch version' in t and 'pygsti_tpu version' not in t


def test_report_records_its_steps(pages, pair):
    """Report.seconds has each step; the box plot's values sum to the
    table's 2*DeltaLogL (the fixture's value is that objective's)."""
    report = pages[2]
    assert set(report.seconds) == {'box plot', 'hessian', 'projection', 'error bars', 'rest'}
    vals = report.box_values['GST']
    assert abs(sum(vals.values()) - pair['params']['final_objfn_value']) \
        <= 1e-9 * pair['params']['final_objfn_value']


def test_confidence_region_failure_raises(pair, tmp_path, monkeypatch, jax_optools_geninf):
    """Where the Hessian fails, the JAX package writes the report without
    error bars and without a word; the port raises."""
    def fail(self, *args, **kwargs):
        raise RuntimeError("no Hessian")
    monkeypatch.setattr(JCRF, 'compute_hessian', fail)
    monkeypatch.setattr(TCRF, 'compute_hessian', fail)
    path = jfactory.construct_standard_report(pair['jres'], "R", confidence_level=95) \
        .write_html(str(tmp_path / 'j.html'))
    page = open(path).read()
    assert 'Per-gate metrics' in page and '&plusmn;' not in page
    with pytest.raises(RuntimeError, match="no Hessian"):
        tfactory.construct_standard_report(pair['tres'], "R", confidence_level=95) \
            .write_html(str(tmp_path / 't.html'))


def test_generator_infidelity_of_a_singular_target_raises():
    """The JAX package's reportable returns nan where the error generator
    cannot be taken; the port's raises."""
    a, _ = _channels(4, 1)
    singular = np.diag([1.0, 1.0, 1.0, 0.0])
    assert np.isnan(jr.generator_infidelity(a, singular, 'pp'))
    with pytest.raises(np.linalg.LinAlgError):
        tr.generator_infidelity(a, singular, 'pp')


def test_pdf_summary(pair, tmp_path, jax_optools_geninf):
    """write_pdf writes a PDF whose text lines are the JAX package's."""
    t = tfactory.construct_standard_report(pair['tres'], "PDF Report")
    j = jfactory.construct_standard_report(pair['jres'], "PDF Report")
    assert t._text_summary_lines() == j._text_summary_lines()
    raw = open(t.write_pdf(str(tmp_path / 'r.pdf')), 'rb').read()
    assert raw.startswith(b'%PDF') and raw.rstrip().endswith(b'%%EOF')


def test_notebook_imports_only_the_port(pair, tmp_path):
    path = tfactory.create_report_notebook(pair['tres'], str(tmp_path / 'r.ipynb'),
                                           confidence_level=95)
    nb = json.load(open(path))
    code = "\n".join(c['source'] for c in nb['cells'] if c['cell_type'] == 'code')
    imports = re.findall(r'^(?:from|import) (\S+)', code, re.M)
    assert imports and all(m.split('.')[0] == 'pygsti_tpu_torch' for m in imports)
    assert 'jax' not in code
    from pygsti_tpu_torch.protocols.gst import ModelEstimateResults
    back = ModelEstimateResults.from_dir(str(tmp_path / 'r_results'))
    assert np.array_equal(back.estimates['GST'].models['stdgaugeopt'].to_vector(),
                          pair['tmodels']['stdgaugeopt'].to_vector())


def test_small_factory_functions(pair, tmp_path):
    tm = pair['tmodels']['target']
    got = tfactory.find_std_clifford_compilation(tm)
    want = jfactory.find_std_clifford_compilation(pair['jmodels']['target'])
    assert {k: str(v) for k, v in got.items()} == {k: str(v) for k, v in want.items()}
    assert len(got) == 24
    assert tfactory.basis_aware_display(tm, 'x', 'ord', 'leak') == \
        jfactory.basis_aware_display(pair['jmodels']['target'], 'x', 'ord', 'leak') == 'ord'
    (tmp_path / 'a.html').write_text('<html></html>')
    import zipfile
    with zipfile.ZipFile(tfactory.create_offline_zip(str(tmp_path))) as z:
        assert z.namelist() == ['a.html']
    assert tfactory.construct_nqnoise_report(pair['tres']).title == "N-Qubit Noise Report"
