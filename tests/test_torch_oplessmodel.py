"""Op-less (error-rates) models in the port against the JAX package: the
cases of tests/test_oplessmodels.py, each held to the JAX package's values
(probabilities and analytic derivatives within 1e-14, as both evaluate the
same closed forms in numpy on the host)."""

import numpy as np
import pytest

from pygsti_tpu.circuits import Circuit as JCircuit
from pygsti_tpu.models import oplessmodel as jom

from pygsti_tpu_torch.circuits.circuit import Circuit as TCircuit
from pygsti_tpu_torch.models import oplessmodel as tom

RATES = {'gates': {'Gx': 0.01, 'Gy': 0.02, 'Gcnot': 0.05, 'Gi': 0.001},
         'readout': {0: 0.03, 1: 0.04}}
LAYERS = [[('Gx', 0), ('Gcnot', 0, 1), ('Gy', 1)], [('Gx', 0)], [],
          [('Gx', 0), ('Gx', 0), ('Gy', 1), ('Gcnot', 0, 1)]]
CLASSES = ['TwirledLayersModel', 'TwirledGatesModel', 'AnyErrorCausesFailureModel',
           'AnyErrorCausesRandomOutputModel']
TOL = 1e-14


def pair(name, rates=RATES, idle_name='Gi'):
    return getattr(jom, name)(rates, 2, idle_name=idle_name), \
        getattr(tom, name)(rates, 2, idle_name=idle_name)


@pytest.mark.parametrize('name', CLASSES)
@pytest.mark.parametrize('idle_name', ['Gi', None])
def test_probabilities_and_dprobs_equal(name, idle_name):
    jm, tm = pair(name, idle_name=idle_name)
    assert tm.num_params == jm.num_params and np.array_equal(tm.to_vector(), jm.to_vector())
    for layers in LAYERS:
        jc, tc = JCircuit(layers, (0, 1)), TCircuit(layers, (0, 1))
        jp, tp = jm.probabilities(jc), tm.probabilities(tc)
        assert list(jp.keys()) == list(tp.keys())
        assert all(abs(jp[k] - tp[k]) < TOL for k in jp)
        assert abs(tp[('success',)] + tp[('fail',)] - 1.0) < 1e-12
        jd, td = jm.sim.dprobs(jc), tm.sim.dprobs(tc)
        assert all(np.abs(np.asarray(jd[k]) - np.asarray(td[k])).max() < TOL for k in jd)


@pytest.mark.parametrize('name', CLASSES)
def test_analytic_dprob_matches_central_differences(name):
    """The analytic _success_dprob against central differences (step 1e-6)
    within 1e-9, and the JAX package's finite-difference default."""
    _, tm = pair(name)
    tc = TCircuit(LAYERS[0], (0, 1))
    cache = tm._circuit_cache(tc)
    analytic = tm._success_dprob(tc, None, cache)
    v0 = tm.to_vector().copy()
    fd = np.empty_like(analytic)
    for i in range(tm.num_params):
        vp, vm = v0.copy(), v0.copy()
        vp[i] += 1e-6
        vm[i] -= 1e-6
        tm.from_vector(vp)
        up = tm._success_prob(tc, cache)
        tm.from_vector(vm)
        fd[i] = (up - tm._success_prob(tc, cache)) / 2e-6
    tm.from_vector(v0)
    assert np.abs(analytic - fd).max() < 1e-9
    base = tom.SuccessFailModel._success_dprob(tm, tc, None, cache)
    jm, _ = pair(name)
    jbase = jom.SuccessFailModel._success_dprob(jm, JCircuit(LAYERS[0], (0, 1)), None,
                                                jm._circuit_cache(JCircuit(LAYERS[0], (0, 1))))
    assert np.abs(base - jbase).max() < 1e-12


def test_zero_noise_idles_and_serialization_of_rates():
    """Zero rates give success 1; an idle error lowers success; to_dict and
    str equal."""
    zero = {'gates': {k: 0.0 for k in RATES['gates']},
            'readout': {k: 0.0 for k in RATES['readout']}}
    _, tm = pair('TwirledLayersModel', zero)
    assert abs(tm.probabilities(TCircuit(LAYERS[0], (0, 1)))[('success',)] - 1.0) < 1e-12
    c1 = TCircuit([('Gx', 0)], (0, 1))
    with_idle = tom.AnyErrorCausesFailureModel(RATES, 2, idle_name='Gi')
    without = tom.AnyErrorCausesFailureModel(RATES, 2, idle_name=None)
    assert with_idle.probabilities(c1)[('success',)] < without.probabilities(c1)[('success',)]
    jm, tm = pair('TwirledGatesModel')
    assert str(jm) == str(tm)
    jd, td = jm.to_dict(), tm.to_dict()
    assert jd['alias_dict'] == td['alias_dict']
    for kind in ('gates', 'readout'):
        assert {str(k): v for k, v in jd['error_rates'][kind].items()} == \
            pytest.approx({str(k): v for k, v in td['error_rates'][kind].items()}, abs=1e-15)
    sims = tm.sim.bulk_probs([TCircuit(l, (0, 1)) for l in LAYERS], clip_to=(0.9, 0.95))
    assert all(0.9 <= p[('success',)] <= 0.95 for p in sims.values())
