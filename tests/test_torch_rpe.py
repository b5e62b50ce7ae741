"""The port's robust phase estimation (the algorithm, the protocol, the
two RPE packs) and the config-driven extras/rpe against the JAX package's,
on the same counts."""

import numpy as np
import pytest
import scipy.linalg

from pygsti_tpu.algorithms import robust_phase_estimation as jalg
from pygsti_tpu.data import simulate_data as j_simulate
from pygsti_tpu.extras.rpe import rpeconfig_gxpi2_gypi2_00 as jcfg
from pygsti_tpu.extras.rpe import rpeconstruction as jrc
from pygsti_tpu.extras.rpe import rpetools as jrt
from pygsti_tpu.modelpacks import smq1Q_XYI as jxyi
from pygsti_tpu.protocols import rpe as jrpe

from pygsti_tpu_torch.algorithms import robust_phase_estimation as talg
from pygsti_tpu_torch.data.dataset import DataSet
from pygsti_tpu_torch.extras.rpe import rpeconfig_gxpi2_gypi2_00 as tcfg
from pygsti_tpu_torch.extras.rpe import rpeconstruction as trc
from pygsti_tpu_torch.extras.rpe import rpetools as trt
from pygsti_tpu_torch.modelpacks import smq1Q_XYI as txyi
from pygsti_tpu_torch.protocols import rpe as trpe


def same_counts(jds, jcircuits, tcircuits):
    tds = DataSet()
    for jc, tc in zip(jcircuits, tcircuits):
        tds.add_count_dict(tc, dict(jds[jc].counts))
    return tds


@pytest.mark.parametrize("gate", ['Xpi2', 'Ypi2'])
@pytest.mark.parametrize("max_length", [1, 8, 1024])
def test_rpe_designs(gate, max_length):
    """The packs' designs: depths, cosine and sine circuits, equal as
    strings; a length that is no power of 2 raises in both."""
    import importlib
    jp = importlib.import_module('pygsti_tpu.modelpacks.smq1Q_%s_rpe' % gate)
    tp = importlib.import_module('pygsti_tpu_torch.modelpacks.smq1Q_%s_rpe' % gate)
    jd, td = jp.create_rpe_experiment_design(max_length), tp.create_rpe_experiment_design(
        max_length)
    assert td.depths == jd.depths and td.gate_label == jd.gate_label
    assert [c.str for c in td.all_circuits_needing_data] == \
        [c.str for c in jd.all_circuits_needing_data]
    assert [c.str for c in td.sin_circuits] == [c.str for c in jd.sin_circuits]
    assert max(c.depth for c in td.all_circuits_needing_data) == max_length + 1
    with pytest.raises(ValueError):
        tp.create_rpe_experiment_design(6)
    assert trpe.RPEDesign is trpe.RobustPhaseEstimationDesign
    assert trpe.RPE is trpe.RobustPhaseEstimationProtocol
    assert trpe.RPEResults is trpe.RobustPhaseEstimationResults


def test_robust_phase_estimation_on_the_same_counts():
    """Raw angles and resolved estimates within 1e-12 on random counts,
    balanced ones and empty ones."""
    rng = np.random.RandomState(3)
    for trial in range(20):
        n = rng.randint(1, 12)
        measured = {k: tuple(int(x) for x in rng.randint(0, 60, 4)) for k in range(n)}
        if trial == 0:
            measured[0] = (0, 0, 0, 0)

        class Q:
            pass
        Q.measured = measured
        j, t = jalg.RobustPhaseEstimation(Q), talg.RobustPhaseEstimation(Q)
        assert np.max(np.abs(np.array(list(j.raw_angles.values()))
                             - np.array(list(t.raw_angles.values())))) < 1e-12
        assert np.max(np.abs(j.angle_estimates - t.angle_estimates)) < 1e-12
    cos, sin = [(40, 60), (10, 90), (70, 30)], [(55, 45), (20, 80), (5, 95)]
    assert abs(jalg.rpe_phase_estimate(cos, sin) - talg.rpe_phase_estimate(cos, sin)) < 1e-12


def test_rpe_protocol_end_to_end():
    """An over-rotated Gxpi2 (0.01 rad) in both packages on the same
    simulated counts: estimates within 1e-12, the last within 1e-3 of the
    true angle."""
    from pygsti_tpu.modelpacks import smq1Q_Xpi2_rpe as jp
    from pygsti_tpu.modelmembers.operations import FullTPOp as JFullTP
    from pygsti_tpu.protocols.protocol import ProtocolData as JData
    from pygsti_tpu.tools.optools import unitary_to_superop
    from pygsti_tpu_torch.modelpacks import smq1Q_Xpi2_rpe as tp
    from pygsti_tpu_torch.modelmembers.operations import FullTPOp as TFullTP
    from pygsti_tpu_torch.protocols.protocol import ProtocolData as TData
    from pygsti_tpu_torch.tools.internalgates import sigmaX
    true_angle = np.pi / 2 + 0.01
    sup = np.real(np.asarray(unitary_to_superop(scipy.linalg.expm(-0.5j * true_angle * sigmaX))))
    jm, tm = jxyi.target_model('full TP'), txyi.target_model('full TP')
    jm.operations[('Gxpi2', 0)] = JFullTP(sup)
    tm.operations[('Gxpi2', 0)] = TFullTP(sup)
    jd, td = jp.create_rpe_experiment_design(256), tp.create_rpe_experiment_design(256)
    jc, tc = jd.all_circuits_needing_data, td.all_circuits_needing_data
    jds = j_simulate(jm, jc, 1000, seed=9)
    tds = same_counts(jds, jc, tc)
    jr = jrpe.RobustPhaseEstimationProtocol().run(JData(jd, jds))
    tr = trpe.RobustPhaseEstimationProtocol().run(TData(td, tds))
    assert np.max(np.abs(np.asarray(jr.angle_estimates) - tr.angle_estimates)) < 1e-12
    assert abs(tr.angle_estimate - true_angle) < 1e-3
    # the port's probabilities of the same circuits, simulated on the CPU
    from pygsti_tpu_torch.forwardsims.forwardsim import SimpleForwardSimulator
    p = SimpleForwardSimulator(tm, 'cpu').bulk_probs(tc)
    q = jm.sim.bulk_probs(jc)
    assert max(abs(p[b][o] - q[a][o]) for a, b in zip(jc, tc) for o in q[a]) < 1e-10


def test_extras_rpe_against_the_jax_package():
    """extras/rpe as tests/test_legacy_rpe.py drives it, in both packages on
    the same counts: the circuits, the parameterized model, every estimate
    and error list, the consistency matrices, and the angles of a model."""
    assert tcfg.to_dict().keys() == jcfg.to_dict().keys()
    jd, td = jrc.create_rpe_angle_circuits_dict(6, jcfg), trc.create_rpe_angle_circuits_dict(
        6, tcfg)
    assert td['k_list'] == jd['k_list'] == [1, 2, 4, 8, 16, 32, 64]
    for key in jd:
        if key != 'k_list':
            assert [c.str for c in td[key]] == [c.str for c in jd[key]], key
    args = (np.pi / 2 + 0.01, np.pi / 2 - 0.005, 0.002, 1e-3, 1e-4)
    jm = jrc.create_parameterized_rpe_model(*args, rpeconfig_inst=jcfg)
    tm = trc.create_parameterized_rpe_model(*args, rpeconfig_inst=tcfg)
    for k in jm.operations:
        assert np.max(np.abs(np.asarray(jm.operations[k].to_dense())
                             - tm.operations[k].dense())) < 1e-12
    jds = jrc.create_rpe_dataset(jm, jd, 5000, seed=42)
    tds = same_counts(jds, jd['totalCircList'], td['totalCircList'])
    jres = jrt.analyze_rpe_data(jds, jm, jd, jcfg, do_consistency_check=True,
                                k_list=jd['k_list'])
    tres = trt.analyze_rpe_data(tds, tm, td, tcfg, do_consistency_check=True,
                                k_list=td['k_list'])
    assert set(tres) == set(jres)
    for key in jres:
        assert np.max(np.abs(np.asarray(jres[key]) - np.asarray(tres[key]))) < 1e-12, key
    assert tres['alphaErrorList'][-1] < 0.01 and tres['epsilonErrorList'][-1] < 0.01
    assert abs(tres['thetaHatList'][-1] - trt.extract_theta(tm, tcfg)) < 2e-3
    for f in ('extract_alpha', 'extract_epsilon', 'extract_theta'):
        assert abs(getattr(jrt, f)(jm, jcfg) - getattr(trt, f)(tm, tcfg)) < 1e-12
    # the port's simulation of the same model on the CPU
    tsim = trc.create_rpe_dataset(tm, td, 10, seed=1, device='cpu')
    assert len(tsim) == len(td['totalCircList'])
    with pytest.raises(NotImplementedError):
        trc.create_parameterized_rpe_model(*args, rpeconfig_inst=trpe_config_xz())


def trpe_config_xz():
    from pygsti_tpu_torch.extras.rpe.rpeconfig import RPEconfig
    return RPEconfig({'fixed_axis_label': 'X', 'loose_axis_label': 'Z'})
