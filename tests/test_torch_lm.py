"""The port's Levenberg-Marquardt loops against the JAX package's: the host
loop with its damping modes, uphill steps, x_limits and out-of-bounds
modes (the cases of tests/test_customlm_knobs.py and
tests/test_device_lm_oob.py), the device loop's out-of-bounds protocol and
CG solve, the routing between the loops, find_closest_unitary_opmx and
validate_and_extend_optimizer."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import pygsti_tpu.modelpacks.smq1Q_XYI as jmp
from pygsti_tpu.algorithms import core as jcore
from pygsti_tpu.circuits.gstcircuits import create_lsgst_circuit_lists as j_lists
from pygsti_tpu.data import simulate_data as j_simulate
from pygsti_tpu.objectivefns import objectivefns as jof
from pygsti_tpu.optimize import customlm as jcl
from pygsti_tpu.optimize import device_lm as jdl
from pygsti_tpu.optimize import simplerlm as jsl

import pygsti_tpu_torch.modelpacks.smq1Q_XYI as tmp
from pygsti_tpu_torch.algorithms import core as tcore
from pygsti_tpu_torch.circuits.gstcircuits import create_lsgst_circuit_lists as t_lists
from pygsti_tpu_torch.data.dataset import DataSet
from pygsti_tpu_torch.objectivefns import objectivefns as tof
from pygsti_tpu_torch.optimize import customlm as tcl
from pygsti_tpu_torch.optimize import device_lm as tdl
from pygsti_tpu_torch.optimize import simplerlm as tsl


def residual_problem():
    """y = exp(-a t) + b, optimum a = 1.3, b = 0.4."""
    t = np.linspace(0, 2, 30)
    y = np.exp(-1.3 * t) + 0.4

    def obj(x, oob_check=False):
        return np.exp(-x[0] * t) + x[1] - y

    def jac(x):
        return np.stack([-t * np.exp(-x[0] * t), np.ones_like(t)], axis=1)

    return obj, jac


def wiggly_problem():
    t = np.linspace(0, 1, 8)

    def obj(x, oob_check=False):
        return np.sin(3 * x[0]) * t + (x[0] - 0.7) * np.ones_like(t)

    def jac(x):
        return (3 * np.cos(3 * x[0]) * t + 1.0).reshape(-1, 1)

    return obj, jac


def same_result(j, t, tol=1e-12):
    """x, converged, msg, mu, nu, norm_f, f of the two host loops."""
    assert np.max(np.abs(np.asarray(j[0]) - t[0])) <= tol
    assert j[1] == t[1] and j[2] == t[2]
    assert abs(j[5] - t[5]) <= tol * max(1.0, abs(j[5]))


KNOBS = [dict(damping_mode='identity'), dict(damping_mode='JTJ', damping_clip=(1e-6, 1e6)),
         dict(damping_mode='invJTJ', damping_clip=(1e-6, 1e6)),
         dict(uphill_step_threshold=1.5), dict(x_limits=[[0.0, 1.0], [-1.0, 1.0]]),
         dict(init_munu=(10.0, 2)), dict(max_dx_scale=0.1)]


@pytest.mark.parametrize("knobs", KNOBS, ids=lambda k: '-'.join(map(str, k)))
def test_custom_leastsq_knobs(knobs):
    """custom_leastsq with each knob: the same result as the JAX package's
    (with 'JTJ' and 'invJTJ' damping mu starts elsewhere, so there both
    reach the optimum instead); the fit reaches the optimum unless x_limits
    keep it out (the sum of squares and J^T f tolerances are set below the
    default 1e-6, at which a fit may stop 2e-3 off the optimum)."""
    obj, jac = residual_problem()
    kw = dict(knobs, rel_ftol=1e-12, rel_xtol=1e-12, f_norm2_tol=1e-14, jac_norm_tol=1e-14)
    j = jcl.custom_leastsq(obj, jac, np.array([0.5, 0.0]), **kw)
    t = tcl.custom_leastsq(obj, jac, np.array([0.5, 0.0]), **kw)
    if knobs.get('damping_mode', 'identity') == 'identity':
        same_result(j, t)
    else:
        assert j[1] and np.allclose(j[0], [1.3, 0.4], atol=1e-3)
    assert t[1]
    if 'x_limits' in knobs:
        assert t[0][0] <= 1.0 + 1e-12 and t[0][1] <= 1.0 + 1e-12 and t[0][0] >= -1e-12
    else:
        assert np.allclose(t[0], [1.3, 0.4], atol=1e-3)


@pytest.mark.parametrize("mode", ['JTJ', 'invJTJ'])
def test_multiplicative_damping_start(mode):
    """A stiff residual s (x - a), s = 1e4, started 1e-3 from its minimum:
    the JAX package starts 'JTJ' damping at mu = 1e-3 max diag(J^T J) =
    1e5, whose first step is below the relative-change tolerance, and
    stops where it started; the port starts at min(1e5, max diag(J^T J) /
    max |J^T f|) = 1e3, as the reference does, and reaches the minimum
    (ROADMAP.md section 3).  'invJTJ' damping is small here in both."""
    s, a = 1e4, np.array([0.8, -0.6, 0.3])

    def obj(x, oob_check=False):
        return s * (x - a)

    def jac(x):
        return s * np.eye(3)

    j = jcl.custom_leastsq(obj, jac, a + 1e-3, damping_mode=mode)
    t = tcl.custom_leastsq(obj, jac, a + 1e-3, damping_mode=mode)
    assert t[1] and np.max(np.abs(t[0] - a)) < 1e-6
    if mode == 'JTJ':
        assert j[1] and np.max(np.abs(j[0] - a)) > 0.9e-3
    else:
        assert np.max(np.abs(j[0] - a)) < 1e-6


def test_uphill_step_on_a_wiggly_residual():
    obj, jac = wiggly_problem()
    j = jcl.custom_leastsq(obj, jac, np.array([0.0]), uphill_step_threshold=1.9, max_iter=200)
    t = tcl.custom_leastsq(obj, jac, np.array([0.0]), uphill_step_threshold=1.9, max_iter=200)
    same_result(j, t)
    assert t[1]


def test_what_raises():
    """The same errors in both packages."""
    obj, jac = residual_problem()
    x0 = np.array([0.5, 0.0])
    for mod in (jcl, tcl):
        with pytest.raises(ValueError):
            mod.custom_leastsq(obj, jac, x0, damping_mode='identity', damping_clip=(0.1, 10))
        for kw in (dict(damping_mode='adaptive'), dict(damping_basis='singular_values'),
                   dict(use_acceleration=True)):
            with pytest.raises(NotImplementedError):
                mod.custom_leastsq(obj, jac, x0, **kw)
    for mod in (jsl, tsl):
        for kw in (dict(damping_mode='adaptive'), dict(use_acceleration=True),
                   dict(damping_basis='singular_values')):
            with pytest.raises(NotImplementedError):
                mod.CustomLMOptimizer(**kw)
        with pytest.raises(ValueError):
            mod.SimplerLMOptimizer.cast([1])


A = np.array([3.0, 0.5])      # the unconstrained minimum, out of bounds
R2 = 1.0                      # in bounds: |x|^2 <= 1
TOLS = dict(f_norm2_tol=1e-10, jac_norm_tol=1e-10, rel_ftol=1e-9, rel_xtol=1e-9,
            max_dx_scale=1.0)


def host_oob(mod, interval, action='reject', mode=0, maxiter=200):
    def obj_fn(x, oob_check=False):
        if oob_check and float(np.dot(x, x)) > R2:
            raise ValueError("out of bounds")
        return x - A

    def jtj_jtf(x):
        return x - A, np.eye(2), x - A

    return mod.simplish_leastsq(obj_fn, jtj_jtf, np.zeros(2), max_iter=maxiter,
                                oob_check_interval=interval, oob_action=action,
                                oob_check_mode=mode, **TOLS)


@pytest.mark.parametrize("interval,action,mode", [(0, 'reject', 0), (1, 'reject', 0),
                                                  (2, 'reject', 0), (3, 'reject', 0),
                                                  (1, 'stop', 0), (2, 'stop', 0),
                                                  (1, 'reject', 1), (2, 'reject', 1)])
def test_host_loop_oob_modes(interval, action, mode):
    """The host loop's out-of-bounds modes and intervals: the same result
    as the JAX package's, in bounds whenever checked."""
    j, t = host_oob(jsl, interval, action, mode), host_oob(tsl, interval, action, mode)
    same_result(j, t)
    if interval:
        assert float(np.dot(t[0], t[0])) <= R2 + 1e-9


def device_oob(interval, with_oob_fn=True, solver='cholesky', maxiter=200):
    """The port's device loop on the out-of-bounds problem, on the CPU."""
    a = torch.as_tensor(A)
    init, run, fin = tdl.make_device_lm(
        lambda x: (x - a, torch.eye(2, dtype=x.dtype), x - a), lambda x: x - a,
        oob_fn=(lambda x: torch.dot(x, x) > R2) if with_oob_fn else None, solver=solver)
    tols = (TOLS['f_norm2_tol'], TOLS['jac_norm_tol'], TOLS['rel_ftol'], TOLS['rel_xtol'],
            TOLS['max_dx_scale'] ** 2 * 2)
    x, f, norm_f, mu, nu, code, k = fin(run(init(torch.zeros(2, dtype=torch.float64),
                                                 oob_interval=interval), maxiter, tols), maxiter)
    return x, norm_f, code


def jax_device_oob(interval, with_oob_fn=True, maxiter=200):
    a = jnp.asarray(A)
    init, chunk, fin = jdl.make_device_lm(
        lambda x, a: (x - a, jnp.eye(2), x - a), lambda x, a: x - a, num_params=2,
        oob_fn=(lambda x, a: jnp.dot(x, x) > R2) if with_oob_fn else None)
    tols = jnp.asarray([TOLS['f_norm2_tol'], TOLS['jac_norm_tol'], TOLS['rel_ftol'],
                        TOLS['rel_xtol'], TOLS['max_dx_scale'] ** 2 * 2])
    st = init(jnp.zeros(2), a, oob_interval=interval)
    while int(st.exit_code) == 0 and int(st.k) < maxiter:
        st = chunk(st, jnp.asarray(min(int(st.k) + 25, maxiter)), tols, a)
    x, f, norm_f, mu, nu, code, k = fin(st, jnp.asarray(maxiter))
    return np.asarray(x), float(norm_f), int(code)


@pytest.mark.parametrize("interval", [0, 1, 2])
def test_device_loop_oob(interval):
    """The device loop's reject protocol against the JAX package's device
    loop and the host loop: unchecked it reaches the minimum; checked it
    stops on the boundary; at interval 2 it returns to the best point in
    bounds."""
    x, norm_f, code = device_oob(interval)
    jx, jnorm, jcode = jax_device_oob(interval)
    assert np.max(np.abs(x - jx)) < 1e-9 and code == jcode
    if interval == 0:
        assert np.allclose(x, A, atol=1e-4) and norm_f < 1e-8
    else:
        assert float(np.dot(x, x)) <= R2 + 1e-9
        hx = host_oob(tsl, interval)[0]
        assert float(np.dot(hx, hx)) <= R2 + 1e-9
        if interval == 1:
            assert np.allclose(x, hx, atol=1e-6)


def test_device_loop_interval_without_predicate():
    """With no predicate an interval changes nothing, bit for bit."""
    for solver in ('cholesky', 'cg'):
        x0, nf0, _ = device_oob(0, with_oob_fn=False, solver=solver)
        x1, nf1, _ = device_oob(1, with_oob_fn=False, solver=solver)
        assert np.array_equal(x0, x1) and nf0 == nf1


def test_cg_solve_against_cholesky_and_jax():
    """The damped CG solve: within 1e-10 of the JAX package's CG and of the
    Cholesky solve on a well-conditioned system, and an all-zero right
    side gives zero."""
    rng = np.random.RandomState(6)
    J = rng.randn(60, 20)
    JTJ, b = J.T @ J, rng.randn(20)
    d, mu = np.diag(JTJ).copy(), 0.3
    t = tdl._solve_damped_cg(torch.as_tensor(JTJ), torch.as_tensor(d), torch.as_tensor(mu),
                             torch.as_tensor(b)).numpy()
    j = np.asarray(jdl._solve_damped_cg(jnp.asarray(JTJ), jnp.asarray(d), jnp.asarray(mu),
                                        jnp.asarray(b)))
    c = tdl._solve_damped(torch.as_tensor(JTJ), torch.as_tensor(d), torch.as_tensor(mu),
                          torch.as_tensor(b)).numpy()
    assert np.max(np.abs(t - j)) < 1e-10 and np.max(np.abs(t - c)) < 1e-10
    z = tdl._solve_damped_cg(torch.as_tensor(JTJ), torch.as_tensor(d), torch.as_tensor(mu),
                             torch.zeros(20, dtype=torch.float64))
    assert not z.any()
    with pytest.raises(ValueError):
        tdl.make_device_lm(None, None, solver='lu')


@pytest.fixture(scope='module')
def gst_problem():
    jt, tt = jmp.target_model('full TP'), tmp.target_model('full TP')
    jl = j_lists(jt, jmp.prep_fiducials(), jmp.meas_fiducials(), jmp.germs(), [1])
    tl = t_lists(tt, tmp.prep_fiducials(), tmp.meas_fiducials(), tmp.germs(), [1])
    jds = j_simulate(jmp.target_model('full TP').depolarize(op_noise=0.02, spam_noise=0.01),
                     list(jl[-1]), 1000, seed=7)
    tds = DataSet()
    for jc, tc in zip(jl[-1], tl[-1]):
        tds.add_count_dict(tc, dict(jds[jc].counts))
    return jt, tt, list(jl[-1]), list(tl[-1]), jds, tds


def test_gst_objective_oob_and_solvers(gst_problem):
    """On a GST objective the device loop gives the same x with interval 0
    and 1 (bit for bit) and with the CG solve (within 1e-6); the JAX
    package's intervals agree with each other (within 1e-9)."""
    jt, tt, jc, tc, jds, tds = gst_problem
    xs = {}
    for key, opt in (('0', {}), ('1', {'oob_check_interval': 1}), ('cg', {'solver': 'cg'})):
        mdl = tt.copy()
        obj = tof.ObjectiveFunctionBuilder('chi2').build(mdl, tds, tc, device='cpu')
        r = tsl.SimplerLMOptimizer(maxiter=15, **opt).run(obj, printer=0)
        assert r.optimizer_specific_qtys['loop'] == 'device'
        xs[key] = r.x
    assert np.array_equal(xs['0'], xs['1'])
    assert np.max(np.abs(xs['cg'] - xs['0'])) < 1e-6
    jx = []
    for interval in (0, 1):
        mdl = jt.copy()
        obj = jof.ObjectiveFunctionBuilder('chi2').build(mdl, jds, jc)
        jx.append(np.asarray(jsl.SimplerLMOptimizer(maxiter=15, oob_check_interval=interval)
                             .run(obj, printer=0).x))
    np.testing.assert_allclose(jx[1], jx[0], rtol=1e-9, atol=1e-12)
    assert np.max(np.abs(xs['0'] - jx[0])) < 1e-6


@pytest.mark.parametrize("opt", [dict(damping_mode='JTJ', damping_clip=(1e-6, 1e6),
                                      uphill_step_threshold=1.5),
                                 dict(damping_mode='invJTJ', damping_clip=(1e-6, 1e6)),
                                 dict(fditer=1), dict(oob_check_interval=1, oob_check_mode=1)])
def test_routing_to_the_host_loop(gst_problem, opt):
    """Damping knobs, fditer and out-of-bounds mode 1 send a fit to the host
    loop in both packages; the fits agree within 1e-6 of the objective."""
    jt, tt, jc, tc, jds, tds = gst_problem
    cls = 'CustomLMOptimizer' if 'damping_mode' in opt else 'SimplerLMOptimizer'
    mdl = tt.copy()
    tr, tobj = tcore.run_gst_fit_simple(tds, mdl, tc, getattr(tsl, cls)(maxiter=100, **opt),
                                        'chi2', device='cpu')
    jr, _ = jcore.run_gst_fit_simple(jds, jt.copy(), jc, getattr(jsl, cls)(maxiter=100, **opt),
                                     jof.ObjectiveFunctionBuilder('chi2'))
    q = tr.optimizer_specific_qtys
    assert q['loop'] == 'host' and q['evaluations'] >= q['iterations'] >= 1
    assert not np.allclose(mdl.to_vector(), tt.to_vector())
    assert abs(tr.f - jr.f) <= 1e-6 * jr.f


@pytest.mark.parametrize("nq", [1, 2])
def test_find_closest_unitary_opmx(nq):
    """Near-unitary and depolarized operations, within 1e-10."""
    from pygsti_tpu_torch.tools.optools import unitary_to_superop
    rng = np.random.RandomState(nq)
    d = 2 ** nq
    u = np.linalg.qr(rng.randn(d, d) + 1j * rng.randn(d, d))[0]
    op = np.real(unitary_to_superop(u, 'pp')) @ np.diag([1.0] + [0.97] * (d * d - 1))
    op = op + 1e-3 * rng.randn(d * d, d * d)
    j = np.asarray(jcore.find_closest_unitary_opmx(op))
    t = tcore.find_closest_unitary_opmx(op)
    assert np.max(np.abs(j - t)) < 1e-10


def test_validate_and_extend_optimizer():
    """Single optimizers, dicts and None repeated; lists of 1 or of the
    size; the same refusals (the JAX package asserts the length)."""
    o = tsl.SimplerLMOptimizer()
    for arg, n in ((o, 3), ({'maxiter': 5}, 2), (None, 2), ([o], 4), ([o, o], 2)):
        t = tcore.validate_and_extend_optimizer(arg, n)
        j = jcore.validate_and_extend_optimizer(arg if arg is None or isinstance(arg, dict)
                                                else _jax_twin(arg), n)
        assert len(t) == len(j) == n
    with pytest.raises(ValueError):
        tcore.validate_and_extend_optimizer('lm', 2)
    with pytest.raises(ValueError):
        jcore.validate_and_extend_optimizer('lm', 2)
    with pytest.raises(ValueError):
        tcore.validate_and_extend_optimizer([o, o], 3)
    with pytest.raises(AssertionError):
        jcore.validate_and_extend_optimizer([jsl.SimplerLMOptimizer()] * 2, 3)


def _jax_twin(arg):
    if isinstance(arg, list):
        return [jsl.SimplerLMOptimizer() for _ in arg]
    return jsl.SimplerLMOptimizer()


def test_per_iteration_optimizers(gst_problem):
    """run_iterative_gst with one optimizer per circuit list: the list of
    one equals the single optimizer's fit; the JAX package casts the
    argument to one optimizer and refuses a list (ROADMAP.md section 3)."""
    jt, tt, jc, tc, jds, tds = gst_problem
    tl = t_lists(tt, tmp.prep_fiducials(), tmp.meas_fiducials(), tmp.germs(), [1, 2])
    gen = tmp.target_model('full TP').depolarize(op_noise=0.02, spam_noise=0.01)
    from pygsti_tpu_torch.data.datasetconstruction import simulate_data
    ds = simulate_data(gen, list(tl[-1]), 1000, seed=3, device='cpu')
    single = tcore.run_iterative_gst(ds, tt, tl, {'maxiter': 50}, ['chi2'], ['logl'],
                                     device='cpu')
    per = tcore.run_iterative_gst(ds, tt, tl, [tsl.SimplerLMOptimizer(maxiter=50),
                                               tsl.CustomLMOptimizer(damping_mode='JTJ')],
                                  ['chi2'], ['logl'], device='cpu')
    assert per[1][0][0].optimizer_specific_qtys['loop'] == 'device'
    assert per[1][1][0].optimizer_specific_qtys['loop'] == 'host'
    assert np.array_equal(per[0][0].to_vector(), single[0][0].to_vector())
    assert abs(per[1][-1][-1].f - single[1][-1][-1].f) <= 1e-6 * single[1][-1][-1].f
    with pytest.raises(ValueError):
        jcore.run_iterative_gst(jds, jt, [jc], [jsl.SimplerLMOptimizer()], ['chi2'], ['logl'])


def test_jac_guarded():
    """The finite-difference Jacobian of the first iterations, then the
    analytic one, as in the JAX package."""
    obj, jac = residual_problem()
    x = np.array([0.7, 0.1])
    f = obj(x)
    for k in (0, 1):
        j = jsl.jac_guarded(k, 1, obj, jac, f, None, x, None)
        t = tsl.jac_guarded(k, 1, obj, jac, f, None, x, None)
        assert np.array_equal(np.asarray(j), t)
