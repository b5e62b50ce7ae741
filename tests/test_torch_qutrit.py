"""The port's qutrit model, its 'gm' and 'qt' bases and the legacy qutrit
pack stdQT_XYIMS against the JAX package's: members, probabilities, the
blocked Jacobian and a small GST fit on the same counts."""

import numpy as np
import pytest
import torch

from pygsti_tpu.baseobjs.basis import Basis as JBasis
from pygsti_tpu.circuits.gstcircuits import create_lsgst_circuit_lists as j_lists
from pygsti_tpu.data import simulate_data as j_simulate
from pygsti_tpu.modelpacks.legacy import stdQT_XYIMS as jqt
from pygsti_tpu.models import qutrit as jq
from pygsti_tpu.objectivefns import objectivefns as jof

from pygsti_tpu_torch.baseobjs.basis import Basis as TBasis
from pygsti_tpu_torch.circuits.gstcircuits import create_lsgst_circuit_lists as t_lists
from pygsti_tpu_torch.data.dataset import DataSet
from pygsti_tpu_torch.forwardsims.forwardsim import SimpleForwardSimulator
from pygsti_tpu_torch.modelpacks.legacy import stdQT_XYIMS as tqt
from pygsti_tpu_torch.models import qutrit as tq
from pygsti_tpu_torch.objectivefns import objectivefns as tof


@pytest.fixture(scope='module', autouse=True)
def one_thread():
    """torch on one thread in this module: beside other test processes a
    pool of spinning threads slows the fit many-fold."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("name,dim", [('gm', 4), ('gm', 9), ('gm', 16), ('qt', 9),
                                      ('pp', 16), ('std', 9)])
def test_bases(name, dim):
    """Elements and labels within 1e-12, and the change of basis to 'std'."""
    jb, tb = JBasis.cast(name, dim), TBasis(name, dim)
    assert list(tb.labels) == list(jb.labels)
    assert np.max(np.abs(np.asarray(jb.elements) - tb.elements)) < 1e-12
    assert np.max(np.abs(np.asarray(jb.create_transform_matrix('std'))
                         - tb.create_transform_matrix('std'))) < 1e-12
    g = np.einsum('aij,bij->ab', tb.elements.conj(), tb.elements)
    assert np.max(np.abs(g - np.eye(dim))) < 1e-12


def same_members(jm, tm, tol=1e-12):
    assert [str(k) for k in tm.operations] == [str(k) for k in jm.operations]
    for jo, to in zip(jm.operations.values(), tm.operations.values()):
        assert np.max(np.abs(np.asarray(jo.to_dense()) - to.dense())) < tol
    for jp, tp in zip(jm.preps.values(), tm.preps.values()):
        assert np.max(np.abs(np.asarray(jp.to_dense()).ravel() - tp.dense())) < tol
    for jp, tp in zip(jm.povms.values(), tm.povms.values()):
        assert [str(k) for k, _ in jp.items()] == tp.outcome_labels
        assert np.max(np.abs(np.array([np.asarray(v).ravel() for _, v in jp.items()])
                             - tp.dense())) < tol
    assert tm.num_params == jm.num_params
    assert np.max(np.abs(np.asarray(jm.to_vector()) - tm.to_vector())) < tol


def test_qutrit_target_and_models():
    """The pack's target: 314 parameters, dense members within 1e-12 in
    'full' and 'full TP'; create_qutrit_model with random rotations, after
    or around the gates; to_qutrit_space."""
    for ptype in ('full', 'full TP'):
        same_members(jqt.target_model(ptype), tqt.target_model(ptype))
    assert tqt.target_model('full TP').num_params == 314
    for similarity in (False, True):
        same_members(jq.create_qutrit_model(0.1, seed=7, similarity=similarity),
                     tq.create_qutrit_model(0.1, seed=7, similarity=similarity))
    u = np.linalg.qr(np.random.RandomState(2).randn(4, 4) + 0j)[0]
    assert np.max(np.abs(jq.to_qutrit_space(u) - tq.to_qutrit_space(u))) < 1e-15
    for attr in ('prepStrs', 'effectStrs', 'germs', 'germs_lite'):
        assert [c.str for c in getattr(tqt, attr)] == [c.str for c in getattr(jqt, attr)]
    assert (len(tqt.germs), len(tqt.germs_lite)) == (69, 31)


@pytest.fixture(scope='module')
def perturbed():
    """Both packages' qutrit targets at one perturbed point, maxL <= 2
    circuits of 12 germs, and counts simulated by the JAX package."""
    jm, tm = jqt.target_model('full TP'), tqt.target_model('full TP')
    theta = jm.to_vector() + 0.02 * np.random.RandomState(11).randn(jm.num_params)
    jm.from_vector(theta)
    tm.from_vector(theta)
    jl = j_lists(jm, jqt.prepStrs, jqt.effectStrs, jqt.germs[:12], [1, 2])
    tl = t_lists(tm, tqt.prepStrs, tqt.effectStrs, tqt.germs[:12], [1, 2])
    gen = jqt.target_model('full TP').depolarize(op_noise=0.01, spam_noise=0.001)
    jds = j_simulate(gen, list(jl[-1]), 1000, seed=5)
    tds = DataSet()
    for jc, tc in zip(jl[-1], tl[-1]):
        tds.add_count_dict(tc, dict(jds[jc].counts))
    return jm, tm, theta, list(jl[-1]), list(tl[-1]), jds, tds


def test_qutrit_probabilities(perturbed):
    """Every circuit's outcome probabilities within 1e-10."""
    jm, tm, _, jc, tc, _, _ = perturbed
    assert [c.str for c in tc] == [c.str for c in jc]
    jp = jm.sim.bulk_probs(jc)
    tp = SimpleForwardSimulator(tm, 'cpu').bulk_probs(tc)
    assert max(abs(jp[a][o] - tp[b][o]) for a, b in zip(jc, tc) for o in jp[a]) < 1e-10


@pytest.mark.parametrize("objective", ['chi2', 'logl'])
def test_qutrit_blocked_jacobian(perturbed, objective):
    """lsvec, J^T J and J^T f of the blocked Jacobian (d 9, NOUT 3) within
    1e-9 relative (the closest observed frequency lies 1.6e-5 from its
    probability here, far enough from a tie: ROADMAP.md section 3)."""
    jm, tm, theta, jc, tc, jds, tds = perturbed
    jobj = jof.ObjectiveFunctionBuilder(objective).build(jm, jds, jc)
    tobj = tof.ObjectiveFunctionBuilder(objective).build(tm, tds, tc, device='cpu')
    assert tobj.jac_mode == 'blocked'
    for a, b in zip(tobj.jtj_jtf(theta), jobj.jtj_jtf(theta)):
        assert np.max(np.abs(a - np.asarray(b))) / np.max(np.abs(b)) < 1e-9
    assert abs(tobj.fn(theta) - jobj.fn(theta)) < 1e-9 * abs(jobj.fn(theta))


@pytest.fixture(scope='module')
def fits():
    """The JAX package's qutrit GST test (germs_lite[:10], maxL [1], from
    the target, no gauge optimization) in both packages on the same counts."""
    from pygsti_tpu.protocols.gst import (GateSetTomography as JGST,
                                          GateSetTomographyDesign as JDesign,
                                          GSTInitialModel as JInit)
    from pygsti_tpu.protocols.protocol import ProtocolData as JData
    from pygsti_tpu_torch.protocols.gst import (GateSetTomography as TGST,
                                                GateSetTomographyDesign as TDesign,
                                                GSTInitialModel as TInit)
    from pygsti_tpu_torch.protocols.protocol import ProtocolData as TData
    jt, tt = jqt.target_model('full TP'), tqt.target_model('full TP')
    jl = j_lists(jt, jqt.prepStrs, jqt.effectStrs, jqt.germs_lite[:10], [1])
    tl = t_lists(tt, tqt.prepStrs, tqt.effectStrs, tqt.germs_lite[:10], [1])
    gen = jqt.target_model('full TP').depolarize(op_noise=0.01, spam_noise=0.001)
    jds = j_simulate(gen, list(jl[-1]), 2000, seed=2026)
    tds = DataSet()
    for jc, tc in zip(jl[-1], tl[-1]):
        tds.add_count_dict(tc, dict(jds[jc].counts))
    jr = JGST(JInit(model=jt.copy()), gaugeopt_suite=None, verbosity=0).run(
        JData(JDesign(jt, jl), jds), disable_checkpointing=True)
    tr = TGST(TInit(model=tt.copy()), gaugeopt_suite=None, verbosity=0, device='cpu').run(
        TData(TDesign(tt, tl), tds), disable_checkpointing=True)
    return (jr.estimates['GateSetTomography'], tr.estimates['GateSetTomography'],
            list(jl[-1]), list(tl[-1]), jds)


def test_qutrit_fit_reaches_the_jax_optimum(fits):
    """2*DeltaLogL within 1e-3 (scored by the JAX package's objective) and
    N_sigma alike."""
    jest, test, jc, _, jds = fits
    jm, tm = jest.models['final iteration estimate'], test.models['final iteration estimate']
    port_in_jax = jm.copy()
    port_in_jax.from_vector(tm.to_vector())
    j_val = jof.two_delta_logl(jm, jds, jc)
    t_val = jof.two_delta_logl(port_in_jax, jds, jc)
    assert abs(t_val - j_val) < 1e-3, (t_val, j_val)
    assert abs(test.misfit_sigma() - jest.misfit_sigma()) < 1e-3
    assert test.misfit_sigma() < 4.0


def test_qutrit_fit_probabilities_agree(fits):
    """Per-circuit probabilities of the two fits within 1e-4."""
    jest, test, jc, tc, _ = fits
    jp = jest.models['final iteration estimate'].sim.bulk_probs(jc)
    tp = SimpleForwardSimulator(test.models['final iteration estimate'], 'cpu').bulk_probs(tc)
    assert max(abs(jp[a][o] - tp[b][o]) for a, b in zip(jc, tc) for o in jp[a]) < 1e-4
