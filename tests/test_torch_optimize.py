"""LogLWildcardFunction, EvaluatedModelDatasetCircuitsStore and
optimize/optimize.py (minimize, check_jac, create_objfn_printer) of the port
against the JAX package's.

Data are drawn by each package's simulate_data from the same seed, which
gives the same counts.  Tolerances: the wildcard objective 1e-10 relative
(the terms agree to rounding, and the water-fill is the JAX package's
element for element); a minimize result 1e-6 (both run scipy's method on
the same function); check_jac's forward differences 1e-5 of max |J| (the
truncation is about eps times the curvature, the rounding about 1e-16
|lsvec| / eps).
"""

import numpy as np
import pytest

import pygsti_tpu.modelpacks.smq1Q_XYI as jmp1
from pygsti_tpu.circuits.gstcircuits import create_lsgst_circuit_lists as j_lists
from pygsti_tpu.data import simulate_data as j_simulate
from pygsti_tpu.objectivefns import objectivefns as jof
from pygsti_tpu.objectivefns.wildcardbudget import PrimitiveOpsWildcardBudget as JBudget
from pygsti_tpu.optimize import optimize as jopt

import pygsti_tpu_torch.modelpacks.smq1Q_XYI as tmp1
from pygsti_tpu_torch.circuits.circuit import Circuit
from pygsti_tpu_torch.convert import model_from_vector
from pygsti_tpu_torch.data.datasetconstruction import simulate_data
from pygsti_tpu_torch.objectivefns import objectivefns as tof
from pygsti_tpu_torch.objectivefns.wildcardbudget import PrimitiveOpsWildcardBudget
from pygsti_tpu_torch.optimize import optimize as topt

CPU = 'cpu'


def wildcard_case(n_circuits):
    """tests/test_api_surface.py:835-865's case, widened to the maxL-1
    design: (port objective, JAX objective, port budget, JAX budget)."""
    jt = jmp1.target_model('full TP')
    jcircs = list(j_lists(jt, jmp1.prep_fiducials(), jmp1.meas_fiducials(), jmp1.germs(),
                          [1])[-1])[:n_circuits]
    tcircs = [Circuit(c.str) for c in jcircs]
    jnoisy = jt.depolarize(op_noise=0.05)
    jds = j_simulate(jnoisy, jcircs, 500, seed=3)
    tt = tmp1.target_model('full TP')
    tds = simulate_data(model_from_vector(tt, jnoisy.to_vector()), tcircs, 500, seed=3,
                        device=CPU)
    for jc, tc in zip(jcircs, tcircs):
        assert dict(jds[jc].counts) == dict(tds[tc].counts)
    tobj = tof.PoissonPicDeltaLogLFunction(tt, tds, tcircs, device=CPU)
    jobj = jof.PoissonPicDeltaLogLFunction(jt, jds, jcircs)
    labels = list(jt.operations.keys())
    return (tobj, jobj, PrimitiveOpsWildcardBudget(list(tt.operations.keys())), JBudget(labels))


@pytest.mark.parametrize('n_circuits', [2, 20])
def test_wildcard_function(n_circuits):
    tobj, jobj, tb, jb = wildcard_case(n_circuits)
    tw, jw = tof.LogLWildcardFunction(tobj, None, tb), jof.LogLWildcardFunction(jobj, None, jb)
    assert tw.description == jw.description
    w0 = np.zeros(tb.num_params)
    assert abs(tw.fn(w0) - tobj.fn()) <= 1e-12 * abs(tobj.fn())
    assert abs(tw.fn(w0) - float(np.sum(tobj.terms()))) <= 1e-12 * abs(tobj.fn())
    prev = tw.fn(w0)
    rng = np.random.default_rng(n_circuits)
    for scale in (1e-3, 1e-2, 0.1, 1.0):
        w = scale * rng.uniform(0.5, 1.5, tb.num_params)
        ours, theirs = tw.terms(w), jw.terms(w)
        assert np.max(np.abs(ours - theirs)) <= 1e-10 * max(np.max(np.abs(theirs)), 1e-12)
        # lsvec is the square root of the clipped terms (where p meets f the
        # terms are rounding, ~1e-14, whose root differs by ~1e-7)
        assert np.array_equal(tw.lsvec(w), np.sqrt(np.clip(ours, 0.0, None)))
        assert tw.fn(w) <= prev + 1e-9
        prev = tw.fn(w)
    # any other attribute is the objective's
    assert tw.num_elements == tobj.num_elements and tw.layout is tobj.layout
    assert tw.chi2k_distributed_qty(3.0) == tobj.chi2k_distributed_qty(3.0)


def test_evaluated_store():
    tobj, jobj, _, _ = wildcard_case(20)
    store = tof.ModelDatasetCircuitsStore(tobj.model, tobj.dataset, tobj.circuits, device=CPU)
    ev = tof.EvaluatedModelDatasetCircuitsStore(store)
    jev = jof.EvaluatedModelDatasetCircuitsStore(
        jof.ModelDatasetCircuitsStore(jobj.model, jobj.dataset, jobj.circuits))
    assert ev.probs.shape == (ev.layout.num_elements,) and ev.layout is store.layout
    assert np.max(np.abs(ev.probs - np.asarray(jev.probs))) < 1e-12
    assert np.max(np.abs(ev.probs - tobj.probs())) < 1e-14


def rosenbrock(x):
    return float(np.sum(100 * (x[1:] - x[:-1] ** 2) ** 2 + (1 - x[:-1]) ** 2))


@pytest.mark.parametrize('method', ['cg', 'L-BFGS-B', 'Nelder-Mead', 'supersimplex',
                                    'customcg', 'evolve'])
def test_minimize(method):
    x0 = np.array([-0.5, 0.8, 0.3])
    kw = dict(maxiter=2000, tol=1e-10)
    if method == 'evolve':
        kw['bounds'] = [(-2, 2)] * 3
    ours, theirs = topt.minimize(rosenbrock, x0, method, **kw), \
        jopt.minimize(rosenbrock, x0, method, **kw)
    assert np.allclose(ours.x, theirs.x, atol=1e-6) and abs(ours.fun - theirs.fun) < 1e-6
    assert ours.success == theirs.success and ours.fun < 1e-3
    capped = topt.minimize(rosenbrock, x0, 'Nelder-Mead', maxfev=50)
    assert np.allclose(capped.x, jopt.minimize(rosenbrock, x0, 'Nelder-Mead', maxfev=50).x)


def test_check_jac_contract():
    """The case of tests/test_api_surface.py:866 and a Jacobian with one
    wrong entry: (err_sum, errs largest first, fd_jac) as in the JAX
    package."""
    xs = np.linspace(0, 2, 20)

    def f(p):
        return np.exp(-p[0] * xs) * p[1]

    def jac(p):
        return np.stack([-xs * np.exp(-p[0] * xs) * p[1], np.exp(-p[0] * xs)], axis=1)

    x0 = np.array([1.3, 0.7])
    bad = jac(x0)
    bad[3, 1] += 0.5
    for J in (jac(x0), bad):
        ours, theirs = topt.check_jac(f, x0, J), jopt.check_jac(f, x0, J)
        assert abs(ours[0] - theirs[0]) <= 1e-9 * theirs[0]
        assert [e[:2] for e in ours[1]] == [e[:2] for e in theirs[1]]
        assert np.allclose(ours[2], theirs[2], rtol=0, atol=1e-12)
    assert topt.check_jac(f, x0, bad)[1][0][:2] == (3, 1)


def test_objfn_printer(capsys):
    for mod in (topt, jopt):
        printer = mod.create_objfn_printer(lambda x: float(np.sum(x ** 2)), start_time=0.0)
        printer(np.array([1.0, 2.0]))
        printer(None, f=3.5, accepted=False)
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 4
    for a, b in zip(out[:2], out[2:]):
        assert a.split()[1:] == b.split()[1:]
    assert out[0].split()[1] == '5.0000000000' and out[1].endswith('not accepted')


def test_check_jac_of_the_blocked_jacobian():
    """smq1Q_XYI 'full TP' at maxL 1 (92 circuits, 'chi2'): the blocked
    dlsvec on the CPU path (the kernel's plain version) against forward
    differences of lsvec, beside the JAX package's on the same data."""
    jt = jmp1.target_model('full TP')
    jcircs = list(j_lists(jt, jmp1.prep_fiducials(), jmp1.meas_fiducials(), jmp1.germs(),
                          [1])[-1])
    tcircs = [Circuit(c.str) for c in jcircs]
    jnoisy = jt.depolarize(op_noise=0.02, spam_noise=0.01)
    tt = tmp1.target_model('full TP')
    jds = j_simulate(jnoisy, jcircs, 1000, seed=5)
    tds = simulate_data(model_from_vector(tt, jnoisy.to_vector()), tcircs, 1000, seed=5,
                        device=CPU)
    theta = jnoisy.to_vector() + 1e-3 * np.random.default_rng(5).standard_normal(jt.num_params)
    tobj = tof.ObjectiveFunctionBuilder('chi2').build(tt, tds, tcircs, device=CPU)
    jobj = jof.ObjectiveFunctionBuilder('chi2').build(jt, jds, jcircs)
    assert tobj.jac_mode == 'blocked'
    J = tobj.dlsvec(theta)
    err_sum, errs, fd = topt.check_jac(tobj.lsvec, theta, J, eps=1e-7)
    jerr_sum, jerrs, jfd = jopt.check_jac(jobj.lsvec, theta, np.asarray(jobj.dlsvec(theta)),
                                          eps=1e-7)
    scale = np.max(np.abs(J))
    assert fd.shape == J.shape == (tobj.num_elements, jt.num_params)
    assert np.max(np.abs(J - fd)) <= 1e-5 * scale
    assert np.max(np.abs(fd - jfd)) <= 1e-5 * scale
    assert np.max(np.abs(J - np.asarray(jobj.dlsvec(theta)))) <= 1e-10 * scale
    assert np.isfinite(err_sum) and np.isfinite(jerr_sum)
