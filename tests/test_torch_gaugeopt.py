"""The port's gauge groups, gauge objective and gaugeopt_to_target against
the JAX package's, on the CPU in float64: the same inputs, made with numpy
from a seed, through both."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pygsti_tpu.modelpacks.smq1Q_XYI as jmp1
import pygsti_tpu.modelpacks.smq2Q_XYICNOT as jmp2
from pygsti_tpu.algorithms import gaugeopt as jgo
from pygsti_tpu.baseobjs.statespace import QubitSpace
from pygsti_tpu.modelmembers import operations as jops, povms as jpovms, states as jstates
from pygsti_tpu.models import gaugegroup as jgg
from pygsti_tpu.objectivefns.objectivefns import _sum_neg_evals as j_sum_neg_evals
from pygsti_tpu.protocols.gst import GSTGaugeOptSuite as JSuite

import pygsti_tpu_torch.modelpacks.smq1Q_XYI as tmp1
import pygsti_tpu_torch.modelpacks.smq2Q_XYICNOT as tmp2
from pygsti_tpu_torch.algorithms import gaugeopt as tgo
from pygsti_tpu_torch.convert import (gauge_element_from_params, gauge_group_from_name,
                                      model_from_vector)
from pygsti_tpu_torch.forwardsims.forwardsim import SimpleForwardSimulator
from pygsti_tpu_torch.modelmembers import operations as tops, povms as tpovms, states as tstates
from pygsti_tpu_torch.models import gaugegroup as tgg
from pygsti_tpu_torch.objectivefns.objectivefns import _sum_neg_evals as t_sum_neg_evals
from pygsti_tpu_torch.protocols.gst import GSTGaugeOptSuite as TSuite

GROUPS = ['Trivial', 'Full', 'TP', 'Diag', 'TP Diag', 'Unitary', 'Spam', 'TP Spam']
JGROUP = {'Trivial': jgg.TrivialGaugeGroup, 'Full': jgg.FullGaugeGroup,
          'TP': jgg.TPGaugeGroup, 'Diag': jgg.DiagGaugeGroup,
          'TP Diag': jgg.TPDiagGaugeGroup, 'Unitary': jgg.UnitaryGaugeGroup,
          'Spam': jgg.SpamGaugeGroup, 'TP Spam': jgg.TPSpamGaugeGroup}
METRICS = ['frobenius', 'frobeniussquared', 'fidelity', 'tracedist']


def _groups(name, nq):
    return JGROUP[name](QubitSpace(nq)), gauge_group_from_name(name, 4 ** nq)


def _random_params(group, rng, scale=0.1):
    return np.asarray(group.initial_params()) + scale * rng.randn(group.num_params)


# -- gauge groups ----------------------------------------------------------------

@pytest.mark.parametrize("nq", [1, 2])
@pytest.mark.parametrize("name", GROUPS)
def test_element_matrix(name, nq):
    """Every group's element matrix at random parameters: 1e-12 of the JAX
    package's, both from the pure map and from compute_element, whose
    inverse is the matrix inverse."""
    jg, tg = _groups(name, nq)
    assert (tg.name, tg.num_params, tg.dim) == (jg.name, jg.num_params, jg.dim)
    assert np.array_equal(tg.initial_params(), jg.initial_params())
    v = _random_params(jg, np.random.RandomState(11 + nq))
    ref = np.asarray(jg.element_matrix_jax(jnp.asarray(v)))
    mx = tg.element_matrix(torch.as_tensor(v))
    assert mx.dtype == torch.float64 and mx.shape == ref.shape
    assert np.max(np.abs(mx.numpy() - ref)) < 1e-12
    jel, tel = jg.compute_element(v), tg.compute_element(v)
    assert type(tel).__name__ == type(jel).__name__
    assert np.max(np.abs(tel.transform_matrix - jel.transform_matrix)) < 1e-12
    assert np.max(np.abs(tel.transform_matrix_inverse - jel.transform_matrix_inverse)) < 1e-10
    inv = tel.inverse()
    assert np.array_equal(inv.transform_matrix, tel.transform_matrix_inverse)
    assert inv.inverse() is tel


def test_unitary_element_keeps_its_unitary():
    jg, tg = _groups('Unitary', 2)
    v = _random_params(jg, np.random.RandomState(5))
    jel, tel = jg.compute_element(v), tg.compute_element(v)
    assert np.max(np.abs(tel.unitary - jel.unitary)) < 1e-12
    assert np.max(np.abs(tel.unitary @ tel.unitary.conj().T - np.eye(4))) < 1e-12


def test_default_gauge_group_for_model():
    for gate_type, name in (('full', 'Full'), ('full TP', 'TP')):
        assert tgg.default_gauge_group_for_model(tmp1.target_model(gate_type)).name == name \
            == jgg.default_gauge_group_for_model(jmp1.target_model(gate_type)).name


# -- eigenvalue sums at a degenerate spectrum --------------------------------------

def _degenerate_hermitian(rng, complex_):
    n = 4
    X = rng.randn(n, n) + (1j * rng.randn(n, n) if complex_ else 0)
    Q, _ = np.linalg.qr(X)
    return Q @ np.diag([-0.5, -0.5, 0.3, 0.3]) @ Q.conj().T


@pytest.mark.parametrize("complex_", [False, True], ids=['real', 'complex'])
@pytest.mark.parametrize("which", ['sum_neg_evals', 'tracenorm_herm'])
def test_spectral_sums_at_repeated_eigenvalues(which, complex_):
    """Value and gradient at a matrix with two double eigenvalues: finite,
    and 1e-10 of the JAX package's custom-JVP versions.  (JAX's gradient of
    a real function of a complex matrix is the conjugate of torch's.)"""
    jfn, tfn = {'sum_neg_evals': (j_sum_neg_evals, t_sum_neg_evals),
                'tracenorm_herm': (jgo._tracenorm_herm, tgo._tracenorm_herm)}[which]
    A = _degenerate_hermitian(np.random.RandomState(3), complex_)
    jval, jgrad = jax.value_and_grad(lambda a: jfn((a + a.conj().T) / 2))(jnp.asarray(A))
    a = torch.tensor(A, requires_grad=True)
    tval = tfn((a + a.conj().transpose(-1, -2)) / 2)
    tval.backward()
    grad = a.grad.numpy()
    assert np.isfinite(float(tval.detach())) and np.all(np.isfinite(grad))
    assert abs(float(tval.detach()) - float(jval)) < 1e-10
    assert np.max(np.abs(grad - np.conj(np.asarray(jgrad)))) < 1e-10
    assert tval.dtype == torch.float64


def test_spectral_sums_batched():
    """A batch gives each matrix's own value and gradient."""
    rng = np.random.RandomState(4)
    mats = np.stack([_degenerate_hermitian(rng, True) for _ in range(3)])
    mats = (mats + mats.conj().transpose(0, 2, 1)) / 2
    a = torch.tensor(mats, requires_grad=True)
    vals = tgo._tracenorm_herm(a)
    vals.sum().backward()
    for k in range(3):
        b = torch.tensor(mats[k], requires_grad=True)
        v = tgo._tracenorm_herm(b)
        v.backward()
        assert abs(float(v.detach()) - float(vals[k].detach())) < 1e-13
        assert np.max(np.abs(b.grad.numpy() - a.grad[k].numpy())) < 1e-13


# -- the gauge objective -----------------------------------------------------------

def _objective_arrays(jmp, rng, noise):
    """numpy arrs of the gauge objective: a model's dense members with
    random noise (so Choi and density matrices have negative eigenvalues and
    the penalties' gradients are not zero) against the target's."""
    target = jmp.target_model('full')
    ops = np.stack([o.to_dense() for o in target.operations.values()])
    preps = np.stack([p.to_dense() for p in target.preps.values()])
    effects = np.concatenate([p.to_dense() for p in target.povms.values()], axis=0)
    return (ops + noise * rng.randn(*ops.shape), ops, rng.uniform(0.5, 1.5, len(ops)),
            preps + noise * rng.randn(*preps.shape), preps, rng.uniform(0.5, 1.5, len(preps)),
            effects + noise * rng.randn(*effects.shape), effects,
            rng.uniform(0.5, 1.5, len(effects)))


def _both_value_and_grad(group_name, nq, jmp, tmp, gates_metric, spam_metric, pen, seed):
    rng = np.random.RandomState(seed)
    arrs = _objective_arrays(jmp, rng, 0.05) + (np.asarray(pen, dtype=float),)
    jg, tg = _groups(group_name, nq)
    v = _random_params(jg, rng, 0.05)
    dim = 4 ** nq
    cptp_on, spam_on = pen[0] > 0, pen[1] > 0
    basis = jmp.target_model('full').basis
    M = np.asarray(basis.create_transform_matrix('std')).astype(complex)
    jconsts = (M, np.linalg.inv(M), np.asarray(basis.elements).astype(complex))
    jobj = jgo._make_objective(jg, dim, gates_metric, spam_metric, cptp_on, spam_on, jconsts)
    jval, jgrad = jax.value_and_grad(jobj)(jnp.asarray(v), tuple(jnp.asarray(a) for a in arrs))

    tmodel = tmp.target_model('full')
    tobj = tgo._make_objective(tg, dim, gates_metric, spam_metric, cptp_on, spam_on,
                               tgo._basis_consts(tmodel, 'cpu'))
    tv = torch.tensor(v, requires_grad=True)
    tval = tobj(tv, tuple(torch.as_tensor(a) for a in arrs))
    tgrad, = torch.autograd.grad(tval, tv)
    assert tval.dtype == torch.float64 and tgrad.dtype == torch.float64
    return float(jval), np.asarray(jgrad), float(tval.detach()), tgrad.numpy()


OBJECTIVE_CASES = [(g, s, pen) for g in METRICS for s in METRICS
                   for pen in ((0.0, 0.0), (0.7, 1.3))] + \
    [('frobenius', 'frobenius', (0.7, 0.0)), ('frobenius', 'frobenius', (0.0, 1.3))]


@pytest.mark.parametrize("gates_metric,spam_metric,pen", OBJECTIVE_CASES)
def test_objective_value_and_gradient_1q(gates_metric, spam_metric, pen):
    """Value and gradient at random parameters near the identity, all four
    gates metrics x all four spam metrics, penalties off and on: 1e-10
    relative of jax.value_and_grad of the JAX package's objective."""
    jval, jgrad, tval, tgrad = _both_value_and_grad(
        'Full', 1, jmp1, tmp1, gates_metric, spam_metric, pen, seed=21)
    assert np.all(np.isfinite(tgrad))
    assert abs(tval - jval) <= 1e-10 * abs(jval)
    assert np.max(np.abs(tgrad - jgrad)) <= 1e-10 * np.max(np.abs(jgrad))


@pytest.mark.parametrize("group_name,pen", [('Unitary', (0.0, 0.0)), ('Full', (0.0, 0.0)),
                                            ('Spam', (0.0, 1.0))])
def test_objective_value_and_gradient_2q(group_name, pen):
    """The 2-qubit frobenius objective (d = 16) under the groups of
    stdgaugeopt, the last with its SPAM penalty: 1e-10 relative."""
    jval, jgrad, tval, tgrad = _both_value_and_grad(
        group_name, 2, jmp2, tmp2, 'frobenius', 'frobenius', pen, seed=22)
    assert abs(tval - jval) <= 1e-10 * abs(jval)
    assert np.max(np.abs(tgrad - jgrad)) <= 1e-10 * np.max(np.abs(jgrad))


def test_objective_refuses_a_tensor_on_another_device():
    """The objective's first call checks that the group's matrix lies where
    the model's tensors lie."""
    tg = gauge_group_from_name('Full', 4)
    obj = tgo._make_objective(tg, 4, 'frobenius', 'frobenius', False, False, None)
    arrs = tuple(torch.as_tensor(a) for a in _objective_arrays(
        jmp1, np.random.RandomState(0), 0.0)) + (torch.zeros(2, dtype=torch.float64),)
    meta = tuple(a.to('meta') for a in arrs)
    with pytest.raises(RuntimeError, match="gauge objective"):
        obj(torch.as_tensor(tg.initial_params()), meta)


# -- gaugeopt_to_target --------------------------------------------------------------

@pytest.fixture(scope='module')
def noisy_models():
    """A depolarized, rotated smq1Q_XYI model moved off the target's gauge
    by a random Full-group element near the identity, in both packages.

    Its state and effects are mixed (eigenvalues 0.1 and 0.9), so the SPAM
    penalty of stdgaugeopt's last stage is smooth around the optimum.  With
    rank-deficient effects the penalty has a kink of slope ~500 at the
    start, Adam's 0.03 steps bounce across it, and two correct
    implementations part after a few hundred steps (seen in both
    packages): nothing a parity test can hold to 1e-6."""
    jtarget, ttarget = jmp1.target_model('full'), tmp1.target_model('full')
    jm = jmp1.target_model('full').depolarize(op_noise=0.03, spam_noise=0.2) \
        .rotate((0.04, 0.02, -0.03))
    identity = np.array([np.sqrt(2), 0, 0, 0])
    jm.povms['Mdefault'] = jpovms.UnconstrainedPOVM(
        {ol: 0.8 * ev + 0.1 * identity for ol, ev in jm.povms['Mdefault'].items()})
    jg = jgg.FullGaugeGroup(QubitSpace(1))
    jm.transform_inplace(jg.compute_element(_random_params(jg, np.random.RandomState(8), 0.05)))
    return jtarget, ttarget, jm, model_from_vector(ttarget, jm.to_vector())


def _stage_kwargs(index):
    """(JAX kwargs, port kwargs) of the default call (index 0) or of
    stdgaugeopt's stage index-1."""
    if index == 0:
        return {}, {}
    jstage = JSuite.cast('stdgaugeopt').to_dictionary(
        jmp1.target_model('full'))['stdgaugeopt']['stages'][index - 1]
    tstage = TSuite.cast('stdgaugeopt').to_dictionary(
        tmp1.target_model('full'))['stdgaugeopt']['stages'][index - 1]
    assert sorted(jstage) == sorted(tstage)
    for key in jstage:
        if key == 'gauge_group':
            assert tstage[key].name == jstage[key].name
        else:
            assert tstage[key] == jstage[key]
    return dict(jstage), dict(tstage)


def _objective_at_identity(jmodel_dense, jtarget, jkwargs):
    """The JAX package's objective of a model (given as a JAX model) at the
    group's identity: the final objective of a gauge optimization that
    returned this model."""
    group = jkwargs.get('gauge_group') or jgg.default_gauge_group_for_model(jtarget)
    w = jkwargs.get('item_weights', {})
    gw, sw = w.get('gates', 1.0), w.get('spam', 1.0)
    ops = [o.to_dense() for o in jmodel_dense.operations.values()]
    effects = np.concatenate([p.to_dense() for p in jmodel_dense.povms.values()], axis=0)
    arrs = (np.stack(ops), np.stack([o.to_dense() for o in jtarget.operations.values()]),
            np.full(len(ops), gw),
            np.stack([p.to_dense() for p in jmodel_dense.preps.values()]),
            np.stack([p.to_dense() for p in jtarget.preps.values()]), np.full(1, sw),
            effects, np.concatenate([p.to_dense() for p in jtarget.povms.values()], axis=0),
            np.full(len(effects), sw),
            np.asarray([0.0, jkwargs.get('spam_penalty_factor', 0.0)]))
    spam_on = jkwargs.get('spam_penalty_factor', 0) > 0
    M = np.asarray(jtarget.basis.create_transform_matrix('std')).astype(complex)
    consts = (M, np.linalg.inv(M), np.asarray(jtarget.basis.elements).astype(complex))
    obj = jgo._make_objective(group, 4, 'frobenius', 'frobenius', False, spam_on, consts)
    return float(obj(jnp.asarray(group.initial_params()),
                     tuple(jnp.asarray(a) for a in arrs)))


@pytest.fixture(scope='module')
def staged(noisy_models):
    """Default call and the three stdgaugeopt stages in both packages.
    Each stage starts, in both, from the JAX package's result of the stage
    before, so a stage's comparison does not inherit the last one's
    difference."""
    jtarget, ttarget, jm, tm = noisy_models
    out = {}
    jcur = jm
    for index in range(4):
        jkw, tkw = _stage_kwargs(index)
        jin = jm if index == 0 else jcur
        tin = model_from_vector(ttarget, jin.to_vector())
        stats = {}
        jout = jgo.gaugeopt_to_target(jin, jtarget, **jkw)
        tout = tgo.gaugeopt_to_target(tin, ttarget, device="cpu", stats=stats, **tkw)
        out[index] = (jin, tin, jout, tout, jkw, stats)
        if index > 0:
            jcur = jout
    return out


@pytest.mark.parametrize("index", range(4), ids=['default', 'stage1-Full', 'stage2-Unitary',
                                                 'stage3-Spam'])
def test_gaugeopt_to_target_reaches_the_jax_optimum(noisy_models, staged, index):
    """Final objective within 1e-6 relative, frobeniusdist to the target
    within 1e-6, and the model's probabilities unchanged within 1e-10 (a
    gauge transformation changes none).  The optimum is held, not the
    parameter vector: two Adam runs of a thousand steps agree to many digits
    but not to the last."""
    jtarget, ttarget, _, _ = noisy_models
    jin, tin, jout, tout, jkw, stats = staged[index]
    jmodel_of_port = jtarget.copy()
    jmodel_of_port.from_vector(tout.to_vector())
    f_j = _objective_at_identity(jout, jtarget, jkw)
    f_t = _objective_at_identity(jmodel_of_port, jtarget, jkw)
    assert abs(f_t - f_j) <= 1e-6 * abs(f_j)
    assert abs(stats['objective_after'] - f_t) <= 1e-9 * abs(f_t)
    assert stats['objective_after'] <= stats['objective_before']
    assert stats['adam_steps'] == 1000
    assert abs(tout.frobeniusdist(ttarget) - jout.frobeniusdist(jtarget)) < 1e-6
    circuits = tmp1.germs() + tmp1.prep_fiducials()
    p_in = SimpleForwardSimulator(tin, "cpu").bulk_probs(circuits)
    p_out = SimpleForwardSimulator(tout, "cpu").bulk_probs(circuits)
    assert max(abs(p_in[c][o] - p_out[c][o]) for c in circuits for o in p_in[c]) < 1e-10


def test_gaugeopt_moves_the_model_toward_the_target(noisy_models, staged):
    _, ttarget, _, tm = noisy_models
    assert staged[0][3].frobeniusdist(ttarget) < 0.5 * tm.frobeniusdist(ttarget)


def test_gaugeopt_options(noisy_models):
    """check_jac passes on a consistent gradient; return_all gives the
    element that was applied; a trivial group returns a copy; n_leak and an
    unknown metric raise as in the JAX package; maxfev bounds L-BFGS-B."""
    _, ttarget, _, tm = noisy_models
    stats = {}
    out, x, el = tgo.gaugeopt_to_target(tm, ttarget, device="cpu", check_jac=True,
                                        return_all=True, maxiter=50, maxfev=5, stats=stats)
    assert stats['adam_steps'] == 50 and stats['lbfgs_evaluations'] <= 6
    again = tm.copy()
    again.transform_inplace(el)
    assert np.array_equal(again.to_vector(), out.to_vector())
    assert x.shape == (16,) and isinstance(el, tgg.FullGaugeGroupElement)
    same = tgo.gaugeopt_to_target(tm, ttarget, gauge_group=tgg.TrivialGaugeGroup(4),
                                  device="cpu")
    assert np.array_equal(same.to_vector(), tm.to_vector()) and same is not tm
    with pytest.raises(NotImplementedError):
        tgo.gaugeopt_to_target(tm, ttarget, n_leak=1, device="cpu")
    with pytest.raises(ValueError, match="Invalid gates_metric"):
        tgo.gaugeopt_to_target(tm, ttarget, gates_metric='nope', device="cpu")
    assert tgo.GaugeoptToTargetArgs(device="cpu", maxiter=5).run(tm, ttarget) is not None
    assert tgo.gates_with_instruments(tm) == list(tm.operations.keys())


def test_gaugeopt_custom(noisy_models):
    """The derivative-free form lowers a custom objective over the
    two-parameter spam group."""
    _, ttarget, _, tm = noisy_models
    out = tgo.gaugeopt_custom(tm, lambda m: m.frobeniusdist(ttarget),
                              gauge_group=tgg.SpamGaugeGroup(4), maxiter=200)
    assert out.frobeniusdist(ttarget) <= tm.frobeniusdist(ttarget)


# -- transform_inplace ---------------------------------------------------------------

def _member_pairs():
    rng = np.random.RandomState(13)
    mx = np.eye(4) + 0.1 * rng.randn(4, 4)
    tp_mx = mx.copy()
    tp_mx[0] = [1, 0, 0, 0]
    vec = 0.3 * rng.randn(4)
    tp_vec = vec.copy()
    tp_vec[0] = 1 / np.sqrt(2)
    e0 = 0.2 * rng.randn(4)
    effects = {'0': e0, '1': np.array([np.sqrt(2), 0, 0, 0]) - e0}
    return {
        'StaticArbitraryOp': (jops.StaticArbitraryOp(mx), tops.StaticArbitraryOp(mx)),
        'FullArbitraryOp': (jops.FullArbitraryOp(mx), tops.FullArbitraryOp(mx)),
        'FullTPOp': (jops.FullTPOp(tp_mx), tops.FullTPOp(tp_mx)),
        'StaticState': (jstates.StaticState(vec), tstates.StaticState(vec)),
        'FullState': (jstates.FullState(vec), tstates.FullState(vec)),
        'TPState': (jstates.TPState(tp_vec), tstates.TPState(tp_vec)),
        'UnconstrainedPOVM': (jpovms.UnconstrainedPOVM(effects),
                              tpovms.UnconstrainedPOVM(effects)),
        'TPPOVM': (jpovms.TPPOVM(effects), tpovms.TPPOVM(effects)),
    }


@pytest.mark.parametrize("group_name", ['Unitary', 'TP Spam'])
@pytest.mark.parametrize("member", sorted(_member_pairs()))
def test_member_transform_inplace(member, group_name):
    """Every member under the same gauge element (carried from the JAX
    group's parameter vector by convert.py): dense forms within 1e-12.  The
    groups fix the identity vector, so the TP members' asserts hold."""
    jm, tm = _member_pairs()[member]
    jg, _ = _groups(group_name, 1)
    v = _random_params(jg, np.random.RandomState(17), 0.2)
    jel = jg.compute_element(v)
    tel = gauge_element_from_params(group_name, v, 4)
    jm.transform_inplace(jel.transform_matrix, jel.transform_matrix_inverse)
    tm.transform_inplace(tel.transform_matrix, tel.transform_matrix_inverse)
    assert np.max(np.abs(tm.dense() - np.asarray(jm.to_dense()))) < 1e-12
    assert np.allclose(tm.to_vector(), jm.to_vector(), rtol=0, atol=1e-12)


def test_tp_members_refuse_a_transform_that_breaks_tp():
    _, tp_op = _member_pairs()['FullTPOp']
    _, tp_state = _member_pairs()['TPState']
    el = gauge_element_from_params('Full', np.eye(4).reshape(-1)
                                   + 0.1 * np.random.RandomState(1).randn(16), 4)
    with pytest.raises(AssertionError):
        tp_op.transform_inplace(el.transform_matrix, el.transform_matrix_inverse)
    with pytest.raises(AssertionError):
        tp_state.transform_inplace(el.transform_matrix, el.transform_matrix_inverse)


@pytest.mark.parametrize("gate_type,group_name", [('full', 'Full'), ('full', 'Spam'),
                                                  ('full TP', 'TP'), ('full TP', 'Unitary')])
def test_model_transform_inplace_and_frobeniusdist(gate_type, group_name):
    """A whole model under one element: the same parameter vector within
    1e-12, the same distance to the target, probabilities unchanged."""
    jm = jmp1.target_model(gate_type).depolarize(op_noise=0.05, spam_noise=0.02)
    tm = tmp1.target_model(gate_type).depolarize(op_noise=0.05, spam_noise=0.02)
    before = tm.copy()
    jg, _ = _groups(group_name, 1)
    v = _random_params(jg, np.random.RandomState(19), 0.1)
    jm.transform_inplace(jg.compute_element(v))
    tm.transform_inplace(gauge_element_from_params(group_name, v, 4))
    assert np.max(np.abs(tm.to_vector() - jm.to_vector())) < 1e-12
    jt, tt = jmp1.target_model(gate_type), tmp1.target_model(gate_type)
    assert abs(tm.frobeniusdist(tt) - jm.frobeniusdist(jt)) < 1e-12
    circuits = tmp1.germs()
    p0 = SimpleForwardSimulator(before, "cpu").bulk_probs(circuits)
    p1 = SimpleForwardSimulator(tm, "cpu").bulk_probs(circuits)
    assert max(abs(p0[c][o] - p1[c][o]) for c in circuits for o in p0[c]) < 1e-12


def test_gauge_element_from_params_checks_its_input():
    with pytest.raises(ValueError, match="no gauge group named"):
        gauge_element_from_params('Op gauge group', np.zeros(3), 4)
    with pytest.raises(ValueError, match="params has shape"):
        gauge_element_from_params('Full', np.zeros(3), 4)
