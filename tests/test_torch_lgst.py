"""LGST and its helpers in the port against the JAX package's, on the same
counts: run_lgst, the re-parameterization helpers, the Gram matrix rank,
run_gst_fit_simple and the LinearGateSetTomography protocol."""

import collections

import numpy as np
import pytest

import pygsti_tpu.modelpacks.smq1Q_XYI as jmp1
import pygsti_tpu.modelpacks.smq2Q_XYICNOT as jmp2
from pygsti_tpu.algorithms import core as jcore
from pygsti_tpu.circuits.gstcircuits import create_lsgst_circuit_lists as j_lists
from pygsti_tpu.data import simulate_data as j_simulate
from pygsti_tpu.protocols import gst as jgst
from pygsti_tpu.protocols.protocol import ProtocolData as JProtocolData

import pygsti_tpu_torch.modelpacks.smq1Q_XYI as tmp1
import pygsti_tpu_torch.modelpacks.smq2Q_XYICNOT as tmp2
from pygsti_tpu_torch.algorithms import core as tcore
from pygsti_tpu_torch.circuits.gstcircuits import create_lsgst_circuit_lists as t_lists
from pygsti_tpu_torch.data.dataset import DataSet
from pygsti_tpu_torch.modelmembers import operations as tops, povms as tpovms, states as tstates
from pygsti_tpu_torch.protocols import gst as tgst
from pygsti_tpu_torch.protocols.protocol import ProtocolData as TProtocolData

PACKS = {'1Q': (jmp1, tmp1), '2Q': (jmp2, tmp2)}


@pytest.fixture(scope='module')
def datasets():
    """Per pack: the first GST list (it holds the LGST circuits) in both
    packages and the JAX package's sampled counts carried into the port."""
    out = {}
    for pack, (jmp, tmp) in PACKS.items():
        jt, tt = jmp.target_model('full TP'), tmp.target_model('full TP')
        jl = j_lists(jt, jmp.prep_fiducials(), jmp.meas_fiducials(), jmp.germs(), [1])[0]
        tl = t_lists(tt, tmp.prep_fiducials(), tmp.meas_fiducials(), tmp.germs(), [1])[0]
        jgen = jmp.target_model('full TP').depolarize(op_noise=0.05, spam_noise=0.02)
        jds = j_simulate(jgen, list(jl), 1000, seed=2024)
        tds = DataSet()
        for jc, tc in zip(jl, tl):
            tds.add_count_dict(tc, dict(jds[jc].counts))
        out[pack] = (list(jl), list(tl), jds, tds)
    return out


@pytest.mark.parametrize("pack,gate_type", [('1Q', 'full'), ('1Q', 'full TP'),
                                            ('2Q', 'full'), ('2Q', 'full TP')])
def test_run_lgst(datasets, pack, gate_type):
    """The LGST estimate on the same counts: the same parameter vector
    within 1e-10, member by member in the target's parameterization."""
    jmp, tmp = PACKS[pack]
    _, _, jds, tds = datasets[pack]
    jm = jcore.run_lgst(jds, jmp.prep_fiducials(), jmp.meas_fiducials(),
                        jmp.target_model(gate_type))
    tm = tcore.run_lgst(tds, tmp.prep_fiducials(), tmp.meas_fiducials(),
                        tmp.target_model(gate_type))
    assert tm.num_params == jm.num_params
    assert np.max(np.abs(tm.to_vector() - jm.to_vector())) < 1e-10
    for jd, td in ((jm.preps, tm.preps), (jm.povms, tm.povms), (jm.operations, tm.operations)):
        assert [type(o).__name__ for o in jd.values()] == \
            [type(o).__name__ for o in td.values()]
    assert tm.frobeniusdist(tmp.target_model(gate_type)) < 0.2


def test_run_lgst_refuses_incomplete_fiducials(datasets):
    _, _, _, tds = datasets['1Q']
    with pytest.raises(ValueError, match="informationally complete"):
        tcore.run_lgst(tds, tmp1.prep_fiducials()[:3], tmp1.meas_fiducials(),
                       tmp1.target_model('full'))


def test_relparam_helpers_keep_the_family():
    """A dense estimate re-wrapped in the old member's family: TP members
    get their fixed entries back, the others take the estimate whole, as in
    the JAX package."""
    rng = np.random.RandomState(2)
    mx, vec = rng.randn(4, 4), rng.randn(4)
    eye = np.eye(4)
    effects = collections.OrderedDict([('0', rng.randn(4)), ('1', rng.randn(4))])
    tp = tcore._relparam_op(tops.FullTPOp(eye), mx)
    jtp = jcore._relparam_op(jcore_ops().FullTPOp(eye), mx)
    assert isinstance(tp, tops.FullTPOp) and np.array_equal(tp.dense(), jtp.to_dense())
    assert isinstance(tcore._relparam_op(tops.FullArbitraryOp(eye), mx), tops.FullArbitraryOp)
    assert isinstance(tcore._relparam_op(tops.StaticArbitraryOp(eye), mx), tops.FullArbitraryOp)
    p = tcore._relparam_prep(tstates.TPState([1 / np.sqrt(2), 0, 0, 0]), vec)
    assert isinstance(p, tstates.TPState) and p.dense()[0] == 1 / np.sqrt(2)
    assert np.array_equal(tcore._relparam_prep(tstates.FullState(vec), vec).dense(), vec)
    old = tpovms.TPPOVM({'0': [np.sqrt(2), 0, 0, 0], '1': [0, 0, 0, 0]})
    povm = tcore._relparam_povm(old, collections.OrderedDict(effects))
    assert isinstance(povm, tpovms.TPPOVM)
    assert np.allclose(povm.dense().sum(axis=0), [np.sqrt(2), 0, 0, 0], atol=1e-15)
    assert isinstance(tcore._relparam_povm(tpovms.UnconstrainedPOVM(effects), effects),
                      tpovms.UnconstrainedPOVM)
    assert tcore._index_of_empty(tmp1.prep_fiducials()) == \
        jcore._index_of_empty(jmp1.prep_fiducials()) == 0


def jcore_ops():
    from pygsti_tpu.modelmembers import operations
    return operations


@pytest.mark.parametrize("pack", sorted(PACKS))
def test_gram_rank_and_eigenvalues(datasets, pack):
    """Rank and singular values of the data's Gram matrix, and the
    target's, within 1e-10 of the JAX package's."""
    jmp, tmp = PACKS[pack]
    _, _, jds, tds = datasets[pack]
    jr, js, jts = jcore.gram_rank_and_eigenvalues(
        jds, jmp.prep_fiducials(), jmp.meas_fiducials(), jmp.target_model('full'))
    tr, ts, tts = tcore.gram_rank_and_eigenvalues(
        tds, tmp.prep_fiducials(), tmp.meas_fiducials(), tmp.target_model('full'),
        device="cpu")
    assert tr == jr
    assert np.max(np.abs(ts - js)) < 1e-10 and np.max(np.abs(tts - jts)) < 1e-10


def test_run_gst_fit_simple(datasets):
    """One logL fit of the first list from the target: the JAX package's
    objective value within 1e-6 relative, and the model takes the optimum."""
    jl, tl, jds, tds = datasets['1Q']
    jres, _ = jcore.run_gst_fit_simple(jds, jmp1.target_model('full TP'), jl, None, 'logl')
    tm = tmp1.target_model('full TP')
    tres, tobj = tcore.run_gst_fit_simple(tds, tm, tl, None, 'logl', device="cpu")
    assert np.isclose(tres.f, jres.f, rtol=1e-6)
    assert tobj.model is tm and np.array_equal(tm.to_vector(), tres.x)


def test_linear_gate_set_tomography(datasets):
    """The LGST protocol on a standard design: the same estimate within
    1e-10, the same model and gauge-opt keys, and gauge-optimized models
    with the seed's probabilities."""
    _, _, jds, tds = datasets['1Q']
    jdesign = jgst.StandardGSTDesign(jmp1.target_model('full TP'), jmp1.prep_fiducials(),
                                     jmp1.meas_fiducials(), jmp1.germs(), [1])
    tdesign = tgst.StandardGSTDesign(tmp1.target_model('full TP'), tmp1.prep_fiducials(),
                                     tmp1.meas_fiducials(), tmp1.germs(), [1])
    jres = jgst.LinearGateSetTomography(verbosity=0).run(JProtocolData(jdesign, jds))
    tres = tgst.LGST(verbosity=0, device="cpu").run(TProtocolData(tdesign, tds))
    jest, test_ = jres.estimates['LinearGateSetTomography'], \
        tres.estimates['LinearGateSetTomography']
    assert list(test_.models.keys()) == list(jest.models.keys())
    assert list(test_.goparameters.keys()) == list(jest.goparameters.keys())
    assert np.max(np.abs(test_.models['final iteration estimate'].to_vector()
                         - jest.models['final iteration estimate'].to_vector())) < 1e-10
    assert test_.models['seed'] is test_.models['final iteration estimate']
    assert test_.misfit_sigma() is None
    from pygsti_tpu_torch.forwardsims.forwardsim import SimpleForwardSimulator
    circuits = tmp1.germs()
    p0 = SimpleForwardSimulator(test_.models['seed'], "cpu").bulk_probs(circuits)
    p1 = SimpleForwardSimulator(test_.models['stdgaugeopt'], "cpu").bulk_probs(circuits)
    assert max(abs(p0[c][o] - p1[c][o]) for c in circuits for o in p0[c]) < 1e-10
