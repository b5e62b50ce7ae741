"""Sparse observed-outcome layouts, the omitted-probability correction, the
forward-mode Jacobian, the penalty rows and the standalone objective
functions of the port, against the JAX package on the same inputs
(tests/test_sparse_outcomes.py and tests/test_jacmode_consistency.py
without their reference-pyGSTi and 5-qubit cases)."""

import numpy as np
import pytest
import torch

import pygsti_tpu.modelpacks.smq1Q_XYI as jmp1
import pygsti_tpu.modelpacks.smq2Q_XYICNOT as jmp
from pygsti_tpu.circuits.gstcircuits import create_lsgst_circuit_lists as j_lists
from pygsti_tpu.data import simulate_data as j_simulate
from pygsti_tpu.objectivefns import objectivefns as jof

import pygsti_tpu_torch.modelpacks.smq1Q_XYI as tmp1
import pygsti_tpu_torch.modelpacks.smq2Q_XYICNOT as tmp
from pygsti_tpu_torch.circuits.gstcircuits import create_lsgst_circuit_lists as t_lists
from pygsti_tpu_torch.convert import model_from_dense
from pygsti_tpu_torch.data.dataset import DataSet
from pygsti_tpu_torch.forwardsims.forwardsim import SimpleForwardSimulator
from pygsti_tpu_torch.objectivefns import objectivefns as tof


def _same_counts(jds, jcircuits, tcircuits):
    tds = DataSet()
    for jc, tc in zip(jcircuits, tcircuits):
        tds.add_count_dict(tc, dict(jds[jc].counts))
    return tds


def _rel(a, b):
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


@pytest.fixture(scope='module')
def sparse_setup():
    """The JAX test's 2-qubit design and data (40 shots, so many circuits
    have outcomes with no counts); the objectives take a quarter of its
    circuits, the LM test the JAX test's sixth."""
    jt, tt = jmp.target_model('full TP'), tmp.target_model('full TP')
    jgen = jt.copy().depolarize(op_noise=0.02, spam_noise=0.01)
    jall = list(j_lists(jt, jmp.prep_fiducials(), jmp.meas_fiducials(), jmp.germs(),
                        [1, 2])[-1])[::4]
    tall = list(t_lists(tt, tmp.prep_fiducials(), tmp.meas_fiducials(), tmp.germs(),
                        [1, 2])[-1])[::4]
    jds = j_simulate(jgen, jall, 40, seed=7)
    tds = _same_counts(jds, jall, tall)
    return jt, tt, jall[::4], tall[::4], jds, tds, jgen.to_vector(), jall[::6], tall[::6]


def _off_ties(setup, scale=1e-2):
    """A point near the setup's theta where no observed frequency lies
    within 1e-4 of its probability.  Near such a tie the logL terms, a
    difference of O(N) quantities, keep few digits, and at one the signed
    square root's slope is a sign that the last bit of p decides, so two
    packages need not agree there to 1e-9."""
    tt, tc, tds, theta = setup[1], setup[3], setup[5], setup[6]
    lay = SimpleForwardSimulator(tt, 'cpu').create_layout(tc, tds, observed_outcomes_only=True)
    counts, totals = lay.counts_arrays(tds)
    for seed in range(1, 20):
        x = theta + scale * np.random.RandomState(seed).randn(len(theta))
        m = tt.copy()
        m.from_vector(x)
        if np.min(np.abs(SimpleForwardSimulator(m, 'cpu').bulk_fill_probs(None, lay)
                         - counts / totals)) > 1e-4:
            return x
    raise AssertionError("no point off the ties")


def _objectives(pkg, setup, objective='logl', sparse=True, radius=1e-4, penalties=None):
    jt, tt, jc, tc, jds, tds = setup[:6]
    regs = {'chi2': {'min_prob_clip_for_weighting': 1e-4},
            'logl': {'min_prob_clip': 1e-4, 'radius': radius}}[objective]
    if pkg == 'jax':
        raw = jof.ObjectiveFunctionBuilder(objective, regularization=regs).build_raw()
        lay = jt.sim.create_layout(jc, jds, observed_outcomes_only=sparse)
        return jof.TimeIndependentMDCObjectiveFunction(raw, jt, jds, jc, layout=lay,
                                                       penalties=penalties)
    lay = SimpleForwardSimulator(tt, 'cpu').create_layout(tc, tds, observed_outcomes_only=sparse)
    return tof.ObjectiveFunctionBuilder(objective, regularization=regs,
                                        penalties=penalties).build(tt, tds, tc, device='cpu',
                                                                   layout=lay)


def test_sparse_layouts_match_the_jax_package(sparse_setup):
    """Index arrays, element maps, outcomes and the omitted circuits of the
    sparse and the dense layout are the JAX package's, element for
    element; the sparse one drops elements and has omitted outcomes."""
    jt, tt, jc, tc, jds, tds = sparse_setup[:6]
    for sparse in (True, False):
        jl = jt.sim.create_layout(jc, jds, observed_outcomes_only=sparse)
        tl = SimpleForwardSimulator(tt, 'cpu').create_layout(tc, tds,
                                                             observed_outcomes_only=sparse)
        for name in ('op_indices', 'depths', 'prep_index', 'elem_circuit', 'elem_effect',
                     'elem_to_circuit', 'omitted_firsts', 'omitted_circuits'):
            assert np.array_equal(getattr(tl, name), getattr(jl, name)), name
        assert tl.outcomes == jl.outcomes and tl.element_slices == jl.element_slices
        assert (tl.has_omitted, tl.rows_uniform_n_out, tl.num_rows) == \
            (jl.has_omitted, jl.rows_uniform_n_out, jl.num_rows)
    assert tl.num_elements == 4 * len(tc)
    sl = SimpleForwardSimulator(tt, 'cpu').create_layout(tc, tds, observed_outcomes_only=True)
    assert sl.num_elements < tl.num_elements and len(sl.omitted_firsts) > 0


@pytest.mark.parametrize("objective", ["chi2", "logl"])
def test_sparse_objective_matches_the_jax_package(sparse_setup, objective):
    """fn, lsvec, dlsvec, J^T J / J^T f and percircuit of the sparse
    objective (forward-mode Jacobian with the omitted-probability
    correction): 1e-9 relative to the largest entry; both packages report
    'linearize'."""
    theta = _off_ties(sparse_setup)
    jobj = _objectives('jax', sparse_setup, objective)
    tobj = _objectives('torch', sparse_setup, objective)
    assert tobj.jac_mode == jobj._fns['jac_mode'] == 'linearize'
    assert np.isclose(tobj.fn(theta), jobj.fn(theta), rtol=1e-9, atol=0)
    for a, b in zip(tobj.jtj_jtf(theta), jobj.jtj_jtf(theta)):
        assert a.shape == b.shape and _rel(a, b) < 1e-9
    for name in ('lsvec', 'dlsvec', 'percircuit', 'terms', 'probs'):
        a, b = getattr(tobj, name)(theta), getattr(jobj, name)(theta)
        assert a.shape == b.shape and _rel(a, b) < 1e-9, name
    assert np.isclose(tobj.percircuit(theta).sum(), tobj.fn(theta), rtol=1e-12)


def test_sparse_equals_dense_in_the_linear_regime(sparse_setup):
    """With radius 1e-9 every omitted probability is in the linear
    zero-frequency regime, where one correction term per circuit equals the
    dropped elements' terms: fn and |lsvec|^2 within 1e-12, J^T f within
    1e-9 of its largest entry; J^T J (another residual decomposition) is
    finite and symmetric."""
    theta = sparse_setup[6]
    dense = _objectives('torch', sparse_setup, sparse=False, radius=1e-9)
    sparse = _objectives('torch', sparse_setup, sparse=True, radius=1e-9)
    assert (dense.jac_mode, sparse.jac_mode) == ('blocked', 'linearize')
    assert np.isclose(sparse.fn(theta), dense.fn(theta), rtol=1e-12, atol=0)
    assert np.isclose(np.sum(sparse.lsvec(theta) ** 2), np.sum(dense.lsvec(theta) ** 2),
                      rtol=1e-12, atol=0)
    _, jtj_d, jtf_d = dense.jtj_jtf(theta)
    _, jtj_s, jtf_s = sparse.jtj_jtf(theta)
    assert _rel(jtf_s, jtf_d) < 1e-9
    assert np.all(np.isfinite(jtj_s)) and np.allclose(jtj_s, jtj_s.T, atol=1e-8)


def test_sparse_dlsvec_matches_finite_differences(sparse_setup):
    """The sparse dlsvec, correction rows included, against forward
    differences of the sparse lsvec, away from the signed square root's
    kink (the JAX test's points and bar)."""
    theta = sparse_setup[6]
    obj = _objectives('torch', sparse_setup)
    J, f0 = obj.dlsvec(theta), obj.lsvec(theta)
    smooth = np.abs(f0) > 1e-6
    assert smooth.sum() > 0.9 * len(f0)
    for i in (0, 11, 23):
        vp = theta.copy()
        vp[i] += 1e-7
        fd = (obj.lsvec(vp) - f0) / 1e-7
        assert np.max(np.abs(J[smooth, i] - fd[smooth])) < 5e-5


def test_sparse_lm_reaches_the_dense_optimum(sparse_setup):
    """LM on the sparse objective and on the dense one, from the
    data-generating point, end within 2e-2 of each other in the sparse
    metric (the JAX test's bar)."""
    jt, tt, _, _, jds, tds, theta, jc, tc = sparse_setup
    setup = (jt, tt, jc, tc, jds, tds, theta)
    dense = _objectives('torch', setup, sparse=False, radius=1e-9)
    sparse = _objectives('torch', setup, sparse=True, radius=1e-9)
    # one thread: the LM loop is many small ops, and beside other test
    # processes a pool of spinning threads slowed it 60-fold
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        xs = np.asarray(sparse.run_device_lm(theta, maxiter=150)[0])
        xd = np.asarray(dense.run_device_lm(theta, maxiter=150)[0])
    finally:
        torch.set_num_threads(threads)
    fs, fd = sparse.fn(xs), sparse.fn(xd)
    assert np.isfinite(fs) and abs(fs - fd) / fd < 2e-2


@pytest.fixture(scope='module')
def uniform_setup():
    """The JAX Jacobian-mode test's 1-qubit design."""
    jt, tt = jmp1.target_model('full TP'), tmp1.target_model('full TP')
    jgen = jt.copy().depolarize(op_noise=0.03, spam_noise=0.01)
    jc = list(j_lists(jt, jmp1.prep_fiducials(), jmp1.meas_fiducials(), jmp1.germs(),
                      [1, 2, 4])[-1])
    tc = list(t_lists(tt, tmp1.prep_fiducials(), tmp1.meas_fiducials(), tmp1.germs(),
                      [1, 2, 4])[-1])
    jds = j_simulate(jgen, jc, 500, seed=5)
    return jt, tt, jc, tc, jds, _same_counts(jds, jc, tc), jgen.to_vector()


@pytest.mark.parametrize("jax_mode", ["blocked", "linearize"])
@pytest.mark.parametrize("torch_mode", ["linearize", "fwd"])
def test_forward_mode_matches_blocked(uniform_setup, monkeypatch, jax_mode, torch_mode):
    """On a uniform layout the port's forward-mode Jacobian (under either
    name) gives the JAX package's 'blocked' and 'linearize' results: lsvec,
    J^T J, J^T f and dlsvec within 1e-9 of their largest entries."""
    jt, tt, jc, tc, jds, tds, _ = uniform_setup
    theta = _off_ties(uniform_setup)
    monkeypatch.setenv('PYGSTI_TPU_JAC_MODE', jax_mode)
    jobj = jof.ObjectiveFunctionBuilder('logl').build(jmp1.target_model('full TP'), jds, jc)
    monkeypatch.delenv('PYGSTI_TPU_JAC_MODE')
    assert jobj._fns['jac_mode'] == jax_mode
    tobj = tof.ObjectiveFunctionBuilder('logl', jac_mode=torch_mode).build(
        tt, tds, tc, device='cpu')
    assert tobj.jac_mode == torch_mode
    for a, b in zip(tobj.jtj_jtf(theta) + (tobj.dlsvec(theta),),
                    jobj.jtj_jtf(theta) + (jobj.dlsvec(theta),)):
        assert a.shape == b.shape and _rel(a, b) < 1e-9


def test_jac_mode_rule_and_refusals(uniform_setup, sparse_setup):
    """jac_mode=None follows the JAX package's rule; 'prodjac' serves when
    asked (the rule never picks it) and refuses a layout without rows;
    'blocked' refuses a sparse layout."""
    jt, tt, jc, tc, jds, tds, _ = uniform_setup
    assert tof.ObjectiveFunctionBuilder('logl').build(tt, tds, tc, device='cpu').jac_mode \
        == jof.ObjectiveFunctionBuilder('logl').build(jt, jds, jc)._fns['jac_mode'] \
        == 'blocked'
    assert tof.ObjectiveFunctionBuilder('logl', jac_mode='prodjac').build(
        tt, tds, tc, device='cpu').jac_mode == 'prodjac'
    with pytest.raises(ValueError, match='prodjac'):
        tof.choose_jac_mode(SimpleForwardSimulator(tt, 'cpu').create_layout([]), 'prodjac')
    with pytest.raises(ValueError):
        tof.ObjectiveFunctionBuilder('logl', jac_mode='scan').build(tt, tds, tc, device='cpu')
    lay = SimpleForwardSimulator(sparse_setup[1], 'cpu').create_layout(
        sparse_setup[3], sparse_setup[5], observed_outcomes_only=True)
    with pytest.raises(ValueError, match='blocked'):
        tof.ObjectiveFunctionBuilder('logl', jac_mode='blocked').build(
            sparse_setup[1], sparse_setup[5], sparse_setup[3], device='cpu', layout=lay)
    with pytest.raises(ValueError, match='penalties'):
        tof.ObjectiveFunctionBuilder('logl', penalties={'prob_clip_interval': 1})


PENALTIES = [{'cptp_penalty_factor': 1.0},
             {'spam_penalty_factor': 0.5},
             {'regularize_factor': 1e-3},
             {'cptp_penalty_factor': 1.0, 'spam_penalty_factor': 1.0,
              'regularize_factor': 1e-2}]


@pytest.mark.parametrize("penalties,sparse", [(p, False) for p in PENALTIES]
                         + [(PENALTIES[-1], True)])
def test_penalty_rows_match_the_jax_package(sparse_setup, penalties, sparse):
    """The CPTP and SPAM penalty rows and regularize_factor, on the blocked
    and the forward-mode Jacobian: fn, lsvec, dlsvec and J^T J / J^T f
    within 1e-9 relative, at a point with negative Choi eigenvalues (the
    data-generating point perturbed) so that the penalties bite."""
    theta = _off_ties(sparse_setup, 0.02)
    jobj = _objectives('jax', sparse_setup, sparse=sparse, penalties=penalties)
    tobj = _objectives('torch', sparse_setup, sparse=sparse, penalties=penalties)
    assert tobj.jac_mode == jobj._fns['jac_mode']
    assert np.isclose(tobj.fn(theta), jobj.fn(theta), rtol=1e-9, atol=0)
    ls = tobj.lsvec(theta)
    assert len(ls) > tobj.num_elements
    for a, b in zip(tobj.jtj_jtf(theta) + (ls, tobj.dlsvec(theta)),
                    jobj.jtj_jtf(theta) + (jobj.lsvec(theta), jobj.dlsvec(theta))):
        assert a.shape == b.shape and _rel(a, b) < 1e-9


@pytest.mark.parametrize("fn,kwargs", [
    ('logl', {}), ('logl', {'poisson_picture': False}), ('logl', {'min_prob_clip': 1e-4}),
    ('two_delta_logl', {}), ('two_delta_logl', {'poisson_picture': False}),
    ('chi2', {}), ('chi2', {'min_prob_clip_for_weighting': 1e-3})])
def test_standalone_functions_match_the_jax_package(sparse_setup, fn, kwargs):
    """logl, two_delta_logl and chi2 of a depolarized model on the sparse
    design's data: within 1e-10 relative."""
    jt, tt, jc, tc, jds, tds, theta = sparse_setup[:7]
    tm = tt.copy()
    tm.from_vector(theta)
    jm = jt.copy()
    jm.from_vector(theta)
    a = getattr(tof, fn)(tm, tds, tc, device='cpu', **kwargs)
    b = getattr(jof, fn)(jm, jds, jc, **kwargs)
    assert np.isclose(a, b, rtol=1e-10, atol=0)
    assert np.isclose(tof.logl_max(tm, tds, tc), jof.logl_max(jm, jds, jc), rtol=1e-12)


def test_more_than_eight_outcomes_switch_sparse_on():
    """With a dataset, a POVM of more than 8 outcomes (a 4-qubit model)
    makes create_layout keep only the observed outcomes, as in the JAX
    package; at 8 or fewer it keeps them all."""
    rng = np.random.RandomState(0)
    d = 256
    m = model_from_dense({'Gi': np.eye(d)}, {'rho0': rng.rand(d)},
                         {'Mdefault': {'%04d' % i: rng.rand(d) for i in range(16)}})
    ds = DataSet()
    circuits = ['Gi', 'GiGi']
    for c in circuits:
        ds.add_count_dict(c, {'0000': 7, '0011': 3, '1111': 0})
    sim = SimpleForwardSimulator(m, 'cpu')
    lay = sim.create_layout(circuits, ds)
    assert lay.num_elements == 2 * 2 and lay.has_omitted
    assert sim.create_layout(circuits).num_elements == 2 * 16
    assert sim.create_layout(circuits, ds, observed_outcomes_only=False).num_elements == 32


def test_gst_stages_carry_penalties(uniform_setup):
    """GateSetTomography with builders that carry penalties: every stage's
    objective value, penalty rows included, within 1e-3 relative of the
    JAX package's on the same counts (1-qubit 'full TP', maxL 1, 2)."""
    from pygsti_tpu.protocols import gst as jgst
    from pygsti_tpu.protocols.protocol import ProtocolData as JData
    from pygsti_tpu_torch.protocols import gst as tgst
    from pygsti_tpu_torch.protocols.protocol import ProtocolData as TData
    jt, tt, _, _, jds, tds, _ = uniform_setup
    pens = {'cptp_penalty_factor': 1.0, 'spam_penalty_factor': 1.0}
    values = []
    for pkg, ofb, target, mp, lists, data, kw in (
            (jgst, jof.ObjectiveFunctionBuilder, jt, jmp1, j_lists, JData, {}),
            (tgst, tof.ObjectiveFunctionBuilder, tt, tmp1, t_lists, TData, {'device': 'cpu'})):
        design = pkg.GateSetTomographyDesign(target, lists(
            target, mp.prep_fiducials(), mp.meas_fiducials(), mp.germs(), [1, 2]))
        builders = pkg.GSTObjFnBuilders([ofb('chi2', penalties=pens)],
                                        [ofb('logl', penalties=pens)])
        res = pkg.GateSetTomography(pkg.GSTInitialModel(target_model=target,
                                                        starting_point='target'),
                                    gaugeopt_suite=None, objfn_builders=builders,
                                    verbosity=0, **kw).run(
            data(design, jds if pkg is jgst else tds), disable_checkpointing=True)
        values.append(sum(res.estimates['GateSetTomography'].parameters[
            'raw_objective_values'], []))
    assert len(values[1]) == len(values[0]) == 3
    for a, b in zip(*values):
        assert abs(a - b) <= 1e-3 * abs(b)
