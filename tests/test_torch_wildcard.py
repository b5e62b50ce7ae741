"""Wildcard budgets, their optimizers, robust re-weighting and the bad-fit
actions of GateSetTomography in the port against the JAX package, on the
CPU in float64, on the same counts.

Tolerances: the batched water-fill 1e-13 per element (the JAX package fills
one circuit at a time in numpy; sums in another order); the one-parameter
alpha 1e-12 relative (the same bisection on the same values); the
Nelder-Mead, barrier and LP budgets 1e-6 relative; robust weights 1e-12;
the 'Robust+' re-fit's 2DeltaLogL 1e-3 relative (the parity bar: LM stops
within its tolerances of the optimum, not on it).
"""

import numpy as np
import pytest
import scipy.stats as st
import torch
from hypothesis import given, settings, strategies as hst

import pygsti_tpu.modelpacks.smq1Q_XYI as jmp
from pygsti_tpu.circuits.gstcircuits import create_lsgst_circuit_lists as j_lists
from pygsti_tpu.data import simulate_data as j_simulate
from pygsti_tpu.objectivefns import wildcardbudget as jwb
from pygsti_tpu.objectivefns.objectivefns import (
    RawPoissonPicDeltaLogLFunction as JRaw, TimeIndependentMDCObjectiveFunction as JObj)
from pygsti_tpu.optimize import wildcardopt as jwo
from pygsti_tpu.protocols import gst as jgst
from pygsti_tpu.protocols.protocol import ProtocolData as JProtocolData

import pygsti_tpu_torch.modelpacks.smq1Q_XYI as tmp
from pygsti_tpu_torch.circuits.gstcircuits import create_lsgst_circuit_lists as t_lists
from pygsti_tpu_torch.data.dataset import DataSet
from pygsti_tpu_torch.objectivefns import wildcardbudget as twb
from pygsti_tpu_torch.objectivefns.objectivefns import (
    RawPoissonPicDeltaLogLFunction as TRaw, TimeIndependentMDCObjectiveFunction as TObj)
from pygsti_tpu_torch.optimize import wildcardopt as two
from pygsti_tpu_torch.protocols import gst as tgst
from pygsti_tpu_torch.protocols.protocol import ProtocolData as TProtocolData


@pytest.fixture(scope='module', autouse=True)
def one_thread():
    """torch on one thread in this module, beside the other test processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _fill_both(q, f, W):
    pj, dj = jwb._waterfill(q, f, W, return_deriv=True)
    pt, dt = twb._waterfill(q, f, W, return_deriv=True)
    return pj, dj, pt, dt


def _random_case(rng, kind):
    n = int(rng.integers(2, 9))
    q = rng.dirichlet(np.ones(n))
    f = rng.multinomial(int(rng.integers(5, 300)), rng.dirichlet(0.5 * np.ones(n)))
    f = f / f.sum()
    if kind == 'zero q':
        q[rng.integers(0, n)] = 0.0
        q /= q.sum()
    elif kind == 'q = f = 0':
        i = int(rng.integers(0, n))
        f = f.copy()
        q[i], f[i] = 0.0, 0.0
        q, f = q / q.sum(), f / f.sum() if f.sum() > 0 else f
    elif kind == 'tied ratios':
        q = f.copy()
        q[0] += 0.01 * f[0]
        q[1] += 0.01 * f[1]
        q[-1] = max(q[-1] - 0.01 * (f[0] + f[1]), 0.0)
        q /= q.sum()
    tvd0 = 0.5 * np.abs(q - f).sum()
    W = {'W = 0': 0.0, 'W = tvd0': tvd0, 'W > tvd0': 1.5 * tvd0 + 0.01}.get(
        kind, float(rng.uniform(0, 1.2)) * tvd0)
    return q, f, W


@pytest.mark.parametrize("kind", ['random', 'zero q', 'q = f = 0', 'W = 0', 'W = tvd0',
                                  'W > tvd0', 'tied ratios'])
def test_waterfill_matches_the_jax_package(kind):
    """Per circuit, p and dp/dW of the batched water-fill against the JAX
    package's _waterfill, and every case of the kind at once in one
    batched call against the same."""
    rng = np.random.default_rng(abs(hash(kind)) % 2 ** 32)
    cases = [_random_case(rng, kind) for _ in range(200)]
    for q, f, W in cases:
        pj, dj, pt, dt = _fill_both(q, f, W)
        assert np.max(np.abs(pt - pj)) < 1e-13
        assert np.max(np.abs(dt - dj)) < 1e-13
    n = 8
    Q, F = np.zeros((len(cases), n)), np.zeros((len(cases), n))
    valid = np.zeros((len(cases), n), bool)
    for i, (q, f, _) in enumerate(cases):
        Q[i, :len(q)], F[i, :len(f)], valid[i, :len(q)] = q, f, True
    P, D = twb.waterfill(torch.as_tensor(Q), torch.as_tensor(F),
                         torch.as_tensor([c[2] for c in cases]), torch.as_tensor(valid), True)
    for i, (q, f, W) in enumerate(cases):
        pj, dj = jwb._waterfill(q, f, W, return_deriv=True)
        assert np.max(np.abs(P[i, :len(q)].numpy() - pj)) < 1e-13
        assert np.max(np.abs(D[i, :len(q)].numpy() - dj)) < 1e-13


@settings(max_examples=60, deadline=None)
@given(hst.lists(hst.integers(0, 40), min_size=2, max_size=8),
       hst.lists(hst.floats(0.0, 1.0), min_size=8, max_size=8),
       hst.floats(0.0, 1.2))
def test_waterfill_hypothesis(counts, qraw, wfrac):
    """Counts, probabilities and budget drawn by hypothesis (ties and zeros
    included): the port's water-fill equals the JAX package's."""
    n = len(counts)
    f = np.array(counts, float)
    if f.sum() == 0:
        f[0] = 1.0
    f /= f.sum()
    q = np.array(qraw[:n]) + 1e-3
    q /= q.sum()
    W = wfrac * 0.5 * np.abs(q - f).sum()
    pj, dj, pt, dt = _fill_both(q, f, W)
    assert np.max(np.abs(pt - pj)) < 1e-13
    assert np.max(np.abs(dt - dj)) < 1e-13


def _misfit(rotation, maxls, shots, seed, gate_type='full TP'):
    """The JAX package's bad-fit cases: the target scored on data from a
    rotated target, both packages on the same counts."""
    jt, tt = jmp.target_model(gate_type), tmp.target_model(gate_type)
    jl = j_lists(jt, jmp.prep_fiducials(), jmp.meas_fiducials(), jmp.germs(), maxls)
    tl = t_lists(tt, tmp.prep_fiducials(), tmp.meas_fiducials(), tmp.germs(), maxls)
    jds = j_simulate(jmp.target_model('full TP').rotate(rotation), list(jl[-1]), shots,
                     seed=seed)
    tds = DataSet()
    for jc, tc in zip(jl[-1], tl[-1]):
        tds.add_count_dict(tc, dict(jds[jc].counts))
    jc, tc = list(jl[-1]), list(tl[-1])
    return dict(jt=jt, tt=tt, jc=jc, tc=tc, jds=jds, tds=tds,
                jobj=JObj(JRaw(), jt, jds, jc), tobj=TObj(TRaw(), tt, tds, tc, device='cpu'))


@pytest.fixture(scope='module')
def misfit_124():
    return _misfit((0.05, 0.02, 0.0), [1, 2, 4], 2000, 9)


@pytest.fixture(scope='module')
def misfit_12():
    return _misfit((0.06, 0.03, 0.0), [1, 2], 2000, 11)


def test_update_probs_and_budget_matrix(misfit_124):
    """update_probs over a layout (one batched water-fill) against the JAX
    package's loop, and each circuit's budget."""
    s = misfit_124
    labels = list(s['jt'].operations.keys()) + ['SPAM']
    jb, tb = jwb.PrimitiveOpsWildcardBudget(labels), twb.PrimitiveOpsWildcardBudget(
        list(s['tt'].operations.keys()) + ['SPAM'])
    vec = np.array([0.002, 0.004, 0.001, 0.003])
    jb.from_vector(vec)
    tb.from_vector(vec)
    jo, to = s['jobj'], s['tobj']
    pj, dj = jb.update_probs(np.asarray(jo.probs()), jo.freqs, jo.counts, jo.total_counts,
                             jo.layout.element_slices, jo.layout.circuits, return_deriv=True)
    pt, dt = tb.update_probs(to.probs(), to.freqs, to.counts, to.total_counts,
                             to.layout.element_slices, to.layout.circuits, return_deriv=True,
                             device='cpu')
    assert np.max(np.abs(pt - pj)) < 1e-13 and np.max(np.abs(dt - dj)) < 1e-13
    assert np.allclose([tb.circuit_budget(c) for c in s['tc']],
                       [jb.circuit_budget(c) for c in s['jc']], rtol=0, atol=1e-15)
    assert np.array_equal(tb.precompute_for_same_circuits(s['tc']),
                          jb.precompute_for_same_circuits(s['jc']))


def test_wildcard1d_alpha(misfit_124):
    """optimize_wildcard_budget_1d on the JAX package's own case: alpha
    within 1e-12 relative, and the adjusted 2DeltaLogL at the threshold."""
    s = misfit_124
    k = s['jds'].degrees_of_freedom(s['jc'])
    threshold = st.chi2.ppf(0.95, k)
    labels = list(s['tt'].operations.keys())
    jb = jwb.optimize_wildcard_budget_1d(
        s['jobj'], jwb.PrimitiveOpsSingleScaleWildcardBudget(list(s['jt'].operations.keys()),
                                                             [0.05] * 3), threshold)
    tb = twb.optimize_wildcard_budget_1d(
        s['tobj'], twb.PrimitiveOpsSingleScaleWildcardBudget(labels, [0.05] * 3), threshold)
    assert tb.alpha > 0 and abs(tb.alpha - jb.alpha) < 1e-12 * jb.alpha
    assert tb.evaluations > 10


@pytest.mark.parametrize("method", ['neldermead', 'barrier', 'cvxpy_noagg'])
def test_multiparameter_budgets(misfit_12, method):
    """The Nelder-Mead, barrier and red-box LP budgets of the JAX package's
    barrier case, within 1e-6 relative; the critical budgets too."""
    s = misfit_12
    k = max(s['jds'].degrees_of_freedom(s['jc']) - s['jt'].num_params, 1)
    threshold = st.chi2.ppf(0.95, k)
    redbox = st.chi2.ppf(1 - 0.05 / len(s['jc']), 1)
    jb = jwb.PrimitiveOpsWildcardBudget(list(s['jt'].operations.keys()) + ['SPAM'])
    tb = twb.PrimitiveOpsWildcardBudget(list(s['tt'].operations.keys()) + ['SPAM'])
    L1 = np.ones(jb.num_params)
    if method == 'neldermead':
        jb = jwb.optimize_wildcard_budget_neldermead(s['jobj'], jb, threshold)
        tb = twb.optimize_wildcard_budget_neldermead(s['tobj'], tb, threshold)
    elif method == 'barrier':
        jb = jwo.optimize_wildcard_budget_barrier(jb, L1, s['jobj'], threshold, redbox)
        tb = two.optimize_wildcard_budget_barrier(tb, L1, s['tobj'], threshold, redbox)
        crit_j = jwo._get_critical_circuit_budgets(s['jobj'], redbox)
        crit_t = two._get_critical_circuit_budgets(s['tobj'], redbox)
        assert np.max(np.abs(crit_t - crit_j)) < 1e-12
    else:
        jb = jwo.optimize_wildcard_budget_percircuit_only_cvxpy(jb, L1, s['jobj'], redbox)
        tb = two.optimize_wildcard_budget_percircuit_only_cvxpy(tb, L1, s['tobj'], redbox)
    xj, xt = jb.to_vector(), tb.to_vector()
    assert np.max(np.abs(xt - xj)) < 1e-6 * np.max(np.abs(xj))


@pytest.mark.parametrize("action", ['robust', 'robust+'])
def test_robust_weights(misfit_124, action, monkeypatch):
    """_compute_robust_scaling: the same circuits reweighted, weights within
    1e-12.  The '+' forms assign chi2 percentiles by sorting the per-circuit
    values, where every outlier ties at the expected value: which tied
    circuit gets which percentile depends on every comparison of the sort,
    and per-circuit values equal in one package differ in the last bit in
    the other, so there both packages sort the JAX package's values."""
    s = misfit_124
    if action == 'robust+':
        values = np.asarray(s['jobj'].percircuit())
        monkeypatch.setattr(TObj, 'percircuit', lambda self, paramvec=None: values.copy())
    wj = jgst._compute_robust_scaling(action, s['jt'], s['jds'], s['jc'])
    wt = tgst._compute_robust_scaling(action, s['tt'], s['tds'], s['tc'], device='cpu')
    jpos, tpos = {c: i for i, c in enumerate(s['jc'])}, {c: i for i, c in enumerate(s['tc'])}
    wj = {jpos[c]: w for c, w in wj.items()}
    wt = {tpos[c]: w for c, w in wt.items()}
    assert len(wj) > 0 and sorted(wt) == sorted(wj)
    assert all(abs(wt[i] - wj[i]) < 1e-12 * wj[i] for i in wj)


def _run_both(actions, methods=('neldermead',)):
    """GateSetTomography with the bad-fit actions in both packages on the
    same counts (a 1-qubit design at maxL 1 from a rotated target)."""
    jt, tt = jmp.target_model('full TP'), tmp.target_model('full TP')
    jd = jgst.StandardGSTDesign(jt, jmp.prep_fiducials(), jmp.meas_fiducials(), jmp.germs(), [1])
    td = tgst.StandardGSTDesign(tt, tmp.prep_fiducials(), tmp.meas_fiducials(), tmp.germs(), [1])
    jds = j_simulate(jmp.target_model('full TP').rotate((0.05, 0.02, 0.0)),
                     jd.all_circuits_needing_data, 2000, seed=6)
    tds = DataSet()
    for jc, tc in zip(jd.all_circuits_needing_data, td.all_circuits_needing_data):
        tds.add_count_dict(tc, dict(jds[jc].counts))
    opts = dict(threshold=-1, actions=actions, wildcard_methods=methods)
    jres = jgst.GateSetTomography(badfit_options=jgst.GSTBadFitOptions(**opts),
                                  gaugeopt_suite=None, verbosity=0, name='GST').run(
        JProtocolData(jd, jds), disable_checkpointing=True)
    tres = tgst.GateSetTomography(badfit_options=tgst.GSTBadFitOptions(**opts),
                                  gaugeopt_suite=None, verbosity=0, name='GST',
                                  device='cpu').run(TProtocolData(td, tds),
                                                    disable_checkpointing=True)
    return jres, tres, tds


@pytest.mark.parametrize("actions", [('wildcard1d', 'robust', 'Robust+'),
                                     ('wildcard', 'robust+', 'Robust')])
def test_gst_badfit_actions_in_both_packages(actions):
    """The same estimates; the budgets within 1e-6; each 'Robust' re-fit's
    2DeltaLogL on its scaled data within 1e-3 of the JAX package's model
    scored by the port on the same scaled data."""
    jres, tres, tds = _run_both(actions)
    assert list(tres.estimates) == list(jres.estimates)
    jb = jres.estimates['GST'].parameters['unmodeled_error']
    tb = tres.estimates['GST'].parameters['unmodeled_error']
    assert np.max(np.abs(tb.to_vector() - jb.to_vector())) <= 1e-6 * np.max(np.abs(jb.to_vector()))
    stats = tres.estimates['GST'].parameters['badfit_stats']
    assert set(stats) == set(actions) and all(v['seconds'] >= 0 for v in stats.values())
    for action in actions:
        if action not in ('Robust', 'Robust+'):
            continue
        jest, test = jres.estimates['GST.' + action], tres.estimates['GST.' + action]
        weights = test.parameters['weights']
        assert len(weights) == len(jest.parameters['weights'])
        scaled = tgst._scale_dataset(tds, weights, list(tres.circuit_lists['final']))
        port_jax_model = tres.estimates['GST'].models['final iteration estimate'].copy()
        port_jax_model.from_vector(jest.models['final iteration estimate'].to_vector())
        jax_value = 2 * TObj(TRaw(), port_jax_model, scaled, list(tres.circuit_lists['final']),
                             device='cpu').fn()
        assert abs(test.parameters['reoptimized_objfn_value'] - jax_value) < 1e-3 * jax_value


@pytest.mark.parametrize("methods", [('barrier',), ('cvxpy_noagg', 'none')])
def test_gst_wildcard_method_chains(methods):
    jres, tres, _ = _run_both(('wildcard',), methods)
    jb = jres.estimates['GST'].parameters['unmodeled_error']
    tb = tres.estimates['GST'].parameters['unmodeled_error']
    assert tb.num_params > 1 and np.all(tb.to_vector() >= 0)
    assert np.max(np.abs(tb.to_vector() - jb.to_vector())) <= 1e-6 * np.max(np.abs(jb.to_vector()))
