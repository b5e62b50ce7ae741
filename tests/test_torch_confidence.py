"""Confidence regions, the Hessians behind them, the optools metrics and the
likelihood and chi2 functions of the port against the JAX package, on the
CPU in float64, on the same counts (smq1Q_XYI, maxL 1-2).

Tolerances: Hessians 1e-9 relative to their largest entry (the port's exact
Hessian is a hand-written forward-over-reverse of the scan, the JAX
package's jax.jacfwd of a vjp); non-gauge projectors ng ng^T 1e-10 (the
bases are not unique, their projectors are); projected inverses 1e-8
('std', 'none', 'intrinsic error'); intervals 1e-8; error bars and the
linear-response solve 1e-6; likelihood and chi2 functions 1e-9 relative;
metrics 1e-12, the diamond distance 1e-8.  'optimal gate CIs' is an
L-BFGS-B search whose optimum is not unique (M moves along directions that
leave the objective flat), and the JAX package's stops short of it: the
port's search, with an exact gradient, must end below the JAX package's
objective value, which is below 'std''s.
"""

import types

import numpy as np
import pytest
import torch

import pygsti_tpu.modelpacks.smq1Q_XYI as jmp
from pygsti_tpu.circuits.gstcircuits import create_lsgst_circuit_lists as j_lists
from pygsti_tpu.data import simulate_data as j_simulate
from pygsti_tpu.models.nongauge import compute_nongauge_and_gauge_spaces as j_spaces
from pygsti_tpu.protocols.confidenceregionfactory import ConfidenceRegionFactory as JCRF
from pygsti_tpu.tools import chi2fns as jchi
from pygsti_tpu.tools import likelihoodfns as jlf
from pygsti_tpu.tools import optools as jot

import pygsti_tpu_torch.modelpacks.smq1Q_XYI as tmp
from pygsti_tpu_torch.circuits.gstcircuits import create_lsgst_circuit_lists as t_lists
from pygsti_tpu_torch.data.dataset import DataSet
from pygsti_tpu_torch.data.datasetconstruction import simulate_data
from pygsti_tpu_torch.models.nongauge import compute_nongauge_and_gauge_spaces as t_spaces
from pygsti_tpu_torch.objectivefns.objectivefns import (RawPoissonPicDeltaLogLFunction,
                                                        TimeIndependentMDCObjectiveFunction)
from pygsti_tpu_torch.protocols.confidenceregionfactory import ConfidenceRegionFactory as TCRF
from pygsti_tpu_torch.protocols.gst import GateSetTomography, StandardGSTDesign
from pygsti_tpu_torch.protocols.protocol import ProtocolData
from pygsti_tpu_torch.tools import chi2fns as tchi
from pygsti_tpu_torch.tools import likelihoodfns as tlf
from pygsti_tpu_torch.tools import optools as tot

GXPI2 = ('Gxpi2', 0)


@pytest.fixture(scope='module', autouse=True)
def one_thread():
    """torch on one thread in this module, beside the other test processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel(a, b):
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))) / np.max(np.abs(b)))


def _setup(gate_type):
    jt, tt = jmp.target_model(gate_type), tmp.target_model(gate_type)
    jl = j_lists(jt, jmp.prep_fiducials(), jmp.meas_fiducials(), jmp.germs(), [1, 2])
    tl = t_lists(tt, tmp.prep_fiducials(), tmp.meas_fiducials(), tmp.germs(), [1, 2])
    jds = j_simulate(jmp.target_model('full TP').depolarize(op_noise=0.03, spam_noise=0.01),
                     list(jl[-1]), 1000, seed=3)
    tds = DataSet()   # the same counts in both packages
    for jc, tc in zip(jl[-1], tl[-1]):
        tds.add_count_dict(tc, dict(jds[jc].counts))
    theta = jt.to_vector() + 0.01 * np.random.RandomState(0).randn(jt.num_params)
    jt.from_vector(theta)
    tt.from_vector(theta)
    ns = types.SimpleNamespace
    jcrf = JCRF(ns(models={'final iteration estimate': jt},
                   parent=ns(dataset=jds, circuit_lists={'final': list(jl[-1])})))
    tcrf = TCRF(ns(models={'final iteration estimate': tt},
                   parent=ns(dataset=tds, circuit_lists={'final': list(tl[-1])})), device='cpu')
    return dict(jt=jt, tt=tt, jl=jl, tl=tl, jds=jds, tds=tds, jcrf=jcrf, tcrf=tcrf)


@pytest.fixture(scope='module')
def full_tp():
    s = _setup('full TP')
    s['jcrf'].compute_hessian()
    s['tcrf'].compute_hessian()
    return s


@pytest.fixture(scope='module')
def cptp():
    return _setup('CPTPLND')


@pytest.mark.parametrize("approximate", [False, True])
@pytest.mark.parametrize("setup", ['full_tp', 'cptp'])
def test_hessians_match_the_jax_package(setup, approximate, request):
    """ConfidenceRegionFactory.compute_hessian, exact and Gauss-Newton, and
    the gradient beside it, on 'full TP' (Tv constant) and 'CPTPLND' (the
    d2 T / dv2 term of the exponentiated generators)."""
    s = request.getfixturevalue(setup)
    jcrf, tcrf = JCRF(s['jcrf'].parent), TCRF(s['tcrf'].parent, device='cpu')
    Hj = jcrf.compute_hessian(approximate=approximate)
    Ht = tcrf.compute_hessian(approximate=approximate)
    assert Ht.shape == Hj.shape
    assert _rel(Ht, Hj) < 1e-9
    assert _rel(tcrf.jacobian, jcrf.jacobian) < 1e-9


@pytest.mark.parametrize("gate_type", ['full TP', 'full', 'CPTPLND'])
def test_nongauge_projector(gate_type):
    """compute_nongauge_and_gauge_spaces: the same dimensions and the same
    projector onto the non-gauge space."""
    jm, tm = jmp.target_model(gate_type), tmp.target_model(gate_type)
    theta = jm.to_vector() + 0.01 * np.random.RandomState(1).randn(jm.num_params)
    jm.from_vector(theta)
    tm.from_vector(theta)
    jn, jg = j_spaces(jm)
    tn, tg = t_spaces(tm, device='cpu')
    assert tn.shape == jn.shape and tg.shape == jg.shape
    assert np.max(np.abs(tn @ tn.T - jn @ jn.T)) < 1e-10
    assert np.max(np.abs(tg @ tg.T - jg @ jg.T)) < 1e-10


@pytest.mark.parametrize("projection", ['std', 'none', 'intrinsic error'])
def test_projected_inverses(full_tp, projection):
    inv_j = full_tp['jcrf'].project_hessian(projection)
    inv_t = full_tp['tcrf'].project_hessian(projection)
    assert full_tp['tcrf'].nGaugeParams == full_tp['jcrf'].nGaugeParams
    assert _rel(inv_t, inv_j) < 1e-8


def test_optimal_gate_cis(full_tp):
    """'optimal gate CIs': the sum of the gates' interval half-widths the
    port's search reaches, against the JAX package's and 'std''s.  The JAX
    package's L-BFGS-B differences the objective over all n_nongauge x
    n_gauge entries of M (373 evaluations per gradient here) and stops at
    scipy's 15,000 evaluations, about 40 iterations, well above the
    optimum: the port's exact gradient goes lower (ROADMAP.md section 3)."""
    jcrf, tcrf = full_tp['jcrf'], full_tp['tcrf']
    gates = np.concatenate([np.arange(tcrf.model.num_params)[op.gpindices]
                            for op in tcrf.model.operations.values()])

    def ci_sum(inv):
        return np.sum(np.sqrt(np.abs(np.diag(inv)[gates])))

    opt_t = ci_sum(tcrf.project_hessian('optimal gate CIs'))
    opt_j = ci_sum(jcrf.project_hessian('optimal gate CIs'))
    std = ci_sum(tcrf.project_hessian('std'))
    assert opt_t < opt_j < std


def test_profile_likelihood_intervals(full_tp):
    vj, vt = full_tp['jcrf'].view(95, hessian_projection='std'), \
        full_tp['tcrf'].view(95, hessian_projection='std')
    assert _rel(vt.profile_likelihood_confidence_intervals(),
                vj.profile_likelihood_confidence_intervals()) < 1e-8
    for lbl in (GXPI2, ('Gypi2', 0)):
        assert _rel(vt.retrieve_profile_likelihood_confidence_intervals(lbl),
                    vj.retrieve_profile_likelihood_confidence_intervals(lbl)) < 1e-8


def _infidelity_fns(s):
    jtgt, ttgt = jmp.target_model('full TP'), tmp.target_model('full TP')
    return (lambda m: jot.entanglement_infidelity(m.operations[GXPI2].to_dense(),
                                                  jtgt.operations[GXPI2].to_dense()),
            lambda m: tot.entanglement_infidelity(m.operations[GXPI2].dense(),
                                                  ttgt.operations[GXPI2].dense()))


def test_compute_uncertainty(full_tp):
    fj, ft = _infidelity_fns(full_tp)
    ej = full_tp['jcrf'].view(95, hessian_projection='std').compute_uncertainty(fj)
    et = full_tp['tcrf'].view(95, hessian_projection='std').compute_uncertainty(ft)
    assert et > 0 and abs(et - ej) < 1e-6 * ej


def test_linear_response(full_tp):
    """The linear-response error bar (CG on the non-gauge subspace) against
    the JAX package's, and against the 'std' projected inverse's."""
    fj, ft = _infidelity_fns(full_tp)
    jcrf, tcrf = JCRF(full_tp['jcrf'].parent), TCRF(full_tp['tcrf'].parent, device='cpu')
    jcrf.enable_linear_response_errorbars()
    tcrf.enable_linear_response_errorbars()
    vj, vt = jcrf.view(95), tcrf.view(95)
    assert vt.errorbar_type == 'linear response'
    lj, lt = vj.compute_uncertainty(fj), vt.compute_uncertainty(ft)
    assert abs(lt - lj) < 1e-6 * lj
    std = full_tp['tcrf'].view(95, hessian_projection='std').compute_uncertainty(ft)
    assert abs(lt - std) < 1e-6 * std


def test_likelihood_functions(full_tp):
    jt, tt, jds, tds = full_tp['jt'], full_tp['tt'], full_tp['jds'], full_tp['tds']
    jc, tc = list(full_tp['jl'][-1]), list(full_tp['tl'][-1])
    for name in ('logl_jacobian', 'logl_hessian', 'logl_approximate_hessian',
                 'two_delta_logl_per_circuit', 'logl_per_circuit', 'logl_max_per_circuit'):
        assert _rel(getattr(tlf, name)(tt, tds, tc, device='cpu'),
                    getattr(jlf, name)(jt, jds, jc)) < 1e-9, name
    for method in ('modeltest', 'nongauge'):
        a = tlf.two_delta_logl_nsigma(tt, tds, tc, dof_calc_method=method, device='cpu')
        b = jlf.two_delta_logl_nsigma(jt, jds, jc, dof_calc_method=method)
        assert abs(a - b) < 1e-9 * abs(b)
    assert abs(tlf.logl(tt, tds, tc, device='cpu') - jlf.logl(jt, jds, jc)) \
        < 1e-9 * abs(jlf.logl(jt, jds, jc))
    n, p, f = np.array([0., 3, 7]), np.array([0.05, 0.3, 0.65]), np.array([0., 0.3, 0.7])
    assert np.allclose(tlf.two_delta_logl_term(n, p, f), jlf.two_delta_logl_term(n, p, f),
                       rtol=1e-12, atol=0)


def test_chi2_functions(full_tp):
    jt, tt, jds, tds = full_tp['jt'], full_tp['tt'], full_tp['jds'], full_tp['tds']
    jc, tc = list(full_tp['jl'][-1]), list(full_tp['tl'][-1])
    for name in ('chi2_per_circuit', 'chi2_jacobian', 'chi2_hessian',
                 'chi2_approximate_hessian'):
        assert _rel(getattr(tchi, name)(tt, tds, tc, device='cpu'),
                    getattr(jchi, name)(jt, jds, jc)) < 1e-9, name
    assert abs(tchi.chi2(tt, tds, tc, device='cpu') - jchi.chi2(jt, jds, jc)) \
        < 1e-9 * jchi.chi2(jt, jds, jc)
    assert abs(tchi.chialpha(1, tt, tds, tc, device='cpu') - jchi.chialpha(1, jt, jds, jc)) \
        < 1e-9 * abs(jchi.chialpha(1, jt, jds, jc))
    n, p, f = np.array([10., 30]), np.array([0.2, 0.5]), np.array([0.3, 0.4])
    for name in ('chi2fn_2outcome', 'chi2fn_2outcome_wfreqs', 'chi2fn', 'chi2fn_wfreqs'):
        assert np.allclose(getattr(tchi, name)(n, p, f), getattr(jchi, name)(n, p, f),
                           rtol=1e-12, atol=0)


def _random_channels(d2, seed):
    """Two CPTP superoperators in the 'pp' basis (random unitaries mixed
    with depolarization)."""
    import scipy.stats
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(2):
        u = scipy.stats.unitary_group.rvs(int(np.sqrt(d2)), random_state=rng)
        s = tot.unitary_to_superop(u, 'pp').real
        dep = np.diag([1.0] + [0.9] * (d2 - 1))
        out.append(dep @ s)
    return out


@pytest.mark.parametrize("d2", [4, 16])
def test_optools_metrics(d2):
    a, b = _random_channels(d2, 7 + d2)
    for name in ('frobeniusdist', 'frobeniusdist_squared', 'tracenorm'):
        args = (a - b,) if name == 'tracenorm' else (a, b)
        assert abs(getattr(tot, name)(*args) - getattr(jot, name)(*args)) < 1e-12
    for name in ('jtracedist', 'entanglement_fidelity', 'entanglement_infidelity',
                 'process_fidelity', 'average_gate_fidelity', 'average_gate_infidelity'):
        assert abs(getattr(tot, name)(a, b) - getattr(jot, name)(a, b)) < 1e-12, name
    assert abs(tot.unitarity(a) - jot.unitarity(a)) < 1e-12
    rho = np.diag([0.7, 0.3]).astype(complex)
    sig = np.array([[0.5, 0.2], [0.2, 0.5]], dtype=complex)
    for name in ('fidelity', 'tracedist'):
        assert abs(getattr(tot, name)(rho, sig) - getattr(jot, name)(rho, sig)) < 1e-12
    if d2 == 4:
        assert abs(tot.diamonddist(a, b) - jot.diamonddist(a, b)) < 1e-8


def test_error_bars_scale_with_shots():
    """The JAX package's own test, in the port: error bars from the 'std'
    projected Hessian of a GST estimate shrink about as 1/sqrt(N)."""
    target = tmp.target_model('full TP')
    design = StandardGSTDesign(target, tmp.prep_fiducials(), tmp.meas_fiducials(),
                               tmp.germs(), [1, 2])
    datagen = tmp.target_model('full TP').depolarize(op_noise=0.02)
    ebs = []
    for N in (300, 3000):
        ds = simulate_data(datagen, design.all_circuits_needing_data, N, seed=3, device='cpu')
        results = GateSetTomography(gaugeopt_suite=None, verbosity=0, name='GST',
                                    device='cpu').run(ProtocolData(design, ds),
                                                      disable_checkpointing=True)
        est = results.estimates['GST']
        crf = est.create_confidence_region_factory()
        assert crf.device.type == 'cpu'
        assert est.confidence_region_factories[('final iteration estimate', 'final')] is crf
        crf.compute_hessian(approximate=True)
        crf.project_hessian()
        eb = crf.view(95).compute_uncertainty(
            lambda m: tot.entanglement_infidelity(m.operations[GXPI2].dense(),
                                                  target.operations[GXPI2].dense()))
        assert eb > 0
        ebs.append(eb)
    assert 1.5 < ebs[0] / ebs[1] < 7


@pytest.mark.parametrize("jac_mode", ['blocked', 'linearize'])
def test_weighted_gram_against_jacfwd(full_tp, jac_mode):
    """The weighted Gram Tv^T (sum over blocks of Jt^T diag(w) Jt) Tv, with
    signed weights, against J^T diag(w) J from torch.func.jacfwd of the
    probabilities, within 1e-12 relative; and the probability Jacobian and
    the Hessian sum sum_e w_e d2 p_e against jacfwd."""
    tt, tds, tc = full_tp['tt'], full_tp['tds'], list(full_tp['tl'][-1])
    obj = TimeIndependentMDCObjectiveFunction(RawPoissonPicDeltaLogLFunction(), tt, tds, tc,
                                              jac_mode=jac_mode, device='cpu')
    assert obj.jac_mode == jac_mode
    w = np.random.RandomState(5).randn(obj.num_elements)
    v = torch.as_tensor(tt.to_vector())
    J = torch.func.jacfwd(obj._fns['probs'])(v).numpy()
    assert _rel(obj.probs_jacobian(), J) < 1e-12
    assert _rel(obj.weighted_gram(w), (J.T * w[None, :]) @ J) < 1e-12
    wt = torch.as_tensor(w)
    H2 = torch.func.jacfwd(lambda x: torch.func.vjp(obj._fns['probs'], x)[1](wt)[0])(v).numpy()
    assert _rel(obj.probs_hessian_sum(w), H2) < 1e-12
