"""The port's smaller extras against the JAX package's: extras/devices (the
port's own device_data.json, every device, processor specs, calibration
models), extras/paritybenchmarking (residual TVDs within 1e-8,
disturbances), extras/ibmq (staging, offline ingestion, checkpoints) and
extras/interpygate/process_tomography.  Cases from tests/test_devices.py,
tests/test_paritybenchmarking.py and tests/test_interpygate.py."""

import json
import os

import numpy as np
import pytest

from pygsti_tpu.extras import devices as jdev
from pygsti_tpu.extras.devices import experimentaldevice as jexp
from pygsti_tpu.extras import paritybenchmarking as jpb
from pygsti_tpu.extras.paritybenchmarking import disturbancecalc as jdc
from pygsti_tpu.extras.ibmq import IBMQExperiment as JIBMQ
from pygsti_tpu.extras.interpygate import process_tomography as jpt
from pygsti_tpu.circuits import Circuit as JCircuit
from pygsti_tpu.protocols.protocol import ExperimentDesign as JDesign

from pygsti_tpu_torch.extras import devices as tdev
from pygsti_tpu_torch.extras.devices import experimentaldevice as texp
from pygsti_tpu_torch.extras import paritybenchmarking as tpb
from pygsti_tpu_torch.extras.paritybenchmarking import disturbancecalc as tdc
from pygsti_tpu_torch.extras.ibmq import IBMQExperiment as TIBMQ
from pygsti_tpu_torch.extras.ibmq import ibmqexperiment as tibmq
from pygsti_tpu_torch.extras.interpygate import process_tomography as tpt
from pygsti_tpu_torch.baseobjs.label import Label
from pygsti_tpu_torch.circuits import Circuit
from pygsti_tpu_torch.forwardsims.forwardsim import SimpleForwardSimulator
from pygsti_tpu_torch.protocols.protocol import ExperimentDesign
from pygsti_tpu_torch.tools.optools import unitary_to_superop

P = np.array([0.7, 0.1, 0.15, 0.05])


def _spec_key(s):
    return (tuple(s.qubit_labels), list(s.gate_names), sorted(s.qubit_graph.edges()))


def test_device_data_is_the_ports_own_copy():
    assert os.path.dirname(texp._DATA_PATH) == os.path.dirname(texp.__file__)
    with open(texp._DATA_PATH) as f, open(jexp._DATA_PATH) as g:
        assert json.load(f) == json.load(g)
    assert len(texp._device_data()) == 40


def test_every_device_matches_jax():
    names = sorted(set(texp._device_data()) | set(texp.DEVICE_EDGELISTS))
    assert texp.DEVICE_EDGELISTS == jexp.DEVICE_EDGELISTS
    for name in names + ['ibmqx2', 'ibm_hanoi', 'ibmq_16_melbourne', 'ibm_nazco']:
        t = tdev.ExperimentalDevice.from_legacy_device(name)
        j = jdev.ExperimentalDevice.from_legacy_device(name)
        assert (t.qubits, t.gate_mapping, t.two_qubit_gate, t.spec_format) == \
            (j.qubits, j.gate_mapping, j.two_qubit_gate, j.spec_format), name
        assert tdev.edgelist(t) == jdev.edgelist(j)
    with pytest.raises(ValueError):
        tdev.ExperimentalDevice.from_legacy_device('ibmq_nonexistent')
    from pygsti_tpu_torch.extras.devices.devcore import basic_device_information, get_device_specs
    assert len(basic_device_information('ibm_hanoi').qubits) == \
        len(get_device_specs('ibmq_hanoi').qubits) == 27


@pytest.mark.parametrize("device,subset,remove", [
    ('ibmq_belem', None, ()), ('ibmq_bogota', ['Q0', 'Q1', 'Q2', 'Q3'], ()),
    ('ibmq_lagos', ['Q1', 'Q3', 'Q5'], [('Q3', 'Q5')]), ('rigetti_agave', None, ())])
def test_processor_specs_match_jax(device, subset, remove):
    t = tdev.create_processor_spec(device, ['Gxpi2', 'Gypi2'], qubitsubset=subset,
                                   removeedges=remove)
    j = jdev.create_processor_spec(device, ['Gxpi2', 'Gypi2'], qubitsubset=subset,
                                   removeedges=remove)
    assert _spec_key(t) == _spec_key(j)
    from pygsti_tpu_torch.extras.devices.devcore import create_clifford_processor_spec
    assert _spec_key(create_clifford_processor_spec(device, ['Gxpi2'], subset)) == \
        _spec_key(tdev.create_processor_spec(device, ['Gxpi2'], subset))
    dev = tdev.ExperimentalDevice.from_legacy_device(device)
    jd = jdev.ExperimentalDevice.from_legacy_device(device)
    assert _spec_key(dev.create_processor_spec(subset_only=False, qubit_subset=subset)) == \
        _spec_key(jd.create_processor_spec(subset_only=False, qubit_subset=subset))
    with pytest.raises(ValueError):
        dev.create_processor_spec(qubit_subset=['Q99'])


CAL = {'gates': {'Q0': 0.001, 'Q1': 0.002, frozenset(('Q0', 'Q1')): 0.02},
       'readout': {'Q0': 0.03, 'Q1': 0.02}}
CAL_IBMQ = {'gates': [{'gate': 'cx', 'qubits': [0, 1],
                       'parameters': [{'name': 'gate_error', 'value': 0.015}]},
                      {'gate': 'sx', 'qubits': [2],
                       'parameters': [{'name': 'gate_error', 'value': 3e-4}]},
                      {'gate': 'id', 'qubits': [0],
                       'parameters': [{'name': 'gate_error', 'value': 1e-4}]}],
            'qubits': [[{'name': 'readout_error', 'value': 0.02}], [], []]}


@pytest.mark.parametrize("model_type", ['TwirledLayers', 'TwirledGates', 'AnyErrorCausesFailure',
                                        'AnyErrorCausesRandomOutput'])
@pytest.mark.parametrize("cal,fmt", [(CAL, 'native'), (CAL_IBMQ, 'ibmq-v2019'), (None, 'native')])
def test_error_rates_models_match_jax(model_type, cal, fmt):
    from pygsti_tpu.baseobjs.label import Label as JLabel
    t = tdev.create_error_rates_model(cal, 'ibmq_belem', calformat=fmt, model_type=model_type)
    j = jdev.create_error_rates_model(cal, 'ibmq_belem', calformat=fmt, model_type=model_type)
    assert type(t).__name__ == type(j).__name__
    layers = [[('Gxpi2', 'Q0')], [('Gcnot', 'Q0', 'Q1'), ('Gypi2', 'Q2')], [('Gxpi2', 'Q3')]]
    tc = Circuit([[Label(g[0], g[1:]) for g in l] for l in layers], ('Q0', 'Q1', 'Q2', 'Q3'))
    jc = JCircuit([[JLabel(g[0], g[1:]) for g in l] for l in layers], ('Q0', 'Q1', 'Q2', 'Q3'))
    tp, jp = t.probabilities(tc), j.probabilities(jc)
    assert sorted(tp) == sorted(jp)
    assert max(abs(tp[k] - jp[k]) for k in tp) < 1e-12
    with pytest.raises(ValueError):
        tdev.create_error_rates_model(cal, 'ibmq_belem', calformat='other')


def test_local_depolarizing_model_matches_jax():
    cal = {'gates': {'Q0': 0.002, 'Q1': 0.004, frozenset(('Q0', 'Q1')): 0.01}}
    kw = dict(qubits=['Q0', 'Q1'], one_qubit_gates_to_native={'Q1': 'Q2'})
    t = tdev.create_local_depolarizing_model(cal, 'ibmq_athens', **kw)
    j = jdev.create_local_depolarizing_model(cal, 'ibmq_athens', **kw)
    strs = ['Gxpi2:Q0Gxpi2:Q0Gcnot:Q0:Q1@(Q0,Q1)', 'Gypi2:Q1Gcnot:Q0:Q1Gxpi2:Q1@(Q0,Q1)']
    tp = SimpleForwardSimulator(t, 'cpu').bulk_probs([Circuit(s) for s in strs])
    for s in strs:
        jp = j.probabilities(JCircuit(s))
        assert max(abs(jp[o] - tp[Circuit(s)][o]) for o in jp) < 1e-12
    with pytest.raises(NotImplementedError):
        tdev.create_local_depolarizing_model(cal, 'ibmq_athens', calformat='ibmq-v2019')


def _flip_data(seed):
    rng = np.random.RandomState(seed)
    T2 = np.eye(4)[:, [3, 1, 2, 0]]
    F = np.array([[0.8, 0.3], [0.2, 0.7]])
    q = 0.8 * (tdc._swell(F, [1], 2) @ P) + 0.2 * (T2 @ P)
    return rng.multinomial(2000, P).astype(float), rng.multinomial(2000, q).astype(float)


@pytest.mark.parametrize("seed", [0, 1])
def test_residual_tvds_match_jax(seed):
    ref, test = _flip_data(seed)
    t = tpb.compute_residual_tvds(2, ref, test, add_one_to_data=True)
    j = jpb.compute_residual_tvds(2, ref, test, add_one_to_data=True)
    assert sorted(t) == sorted(j) == [0, 1, 2]
    for w in t:
        assert abs(t[w] - j[w]) < 1e-8
    assert t[2] == 0.0 and t[0] > t[1] > 1e-3
    rng = np.random.RandomState(seed)
    p3, q3 = rng.dirichlet(np.ones(8)) * 1000, rng.dirichlet(np.ones(8)) * 1000
    t3, j3 = tpb.compute_residual_tvds(3, p3, q3), jpb.compute_residual_tvds(3, p3, q3)
    assert max(abs(t3[w] - j3[w]) for w in t3) < 1e-8
    with pytest.raises(NotImplementedError):
        tpb.compute_residual_tvds(2, ref, test, confidence_percent=68)


def test_disturbances_and_transition_matrices_match_jax():
    ref, test = _flip_data(2)
    t = tpb.compute_disturbances(2, ref, test, num_bootstrap_samples=3, seed=4)
    j = jpb.compute_disturbances(2, ref, test, num_bootstrap_samples=3, seed=4)
    np.testing.assert_allclose(np.array(t), np.array(j), rtol=0, atol=1e-8)
    assert t[1][0] > 0.01 and t[1][1] > 0
    v = np.random.RandomState(0).uniform(0, 0.1, tpb.n_parameters(1, 2))
    np.testing.assert_array_equal(tpb.comprehensive_transition_matrix(v, 1, 2),
                                  jpb.comprehensive_transition_matrix(v, 1, 2))
    np.testing.assert_array_equal(tdc.transition_matrix(v[:2], 2),
                                  jdc.transition_matrix(v[:2], 2))
    with pytest.raises(ValueError):
        tdc.transition_matrix(v[:3], 2)
    r = tpb.ResidualTVD(1, 2)
    r(P, test / test.sum())
    T = r.build_transfer_mx()
    assert np.allclose(T.sum(axis=0), 1.0, atol=1e-8) and T.min() > -1e-9
    assert abs(tpb.ResidualTVD(0, 2)(P, test / test.sum())
               - 0.5 * np.abs(P - test / test.sum()).sum()) < 1e-12


def _designs():
    strs = ['Gxpi2:0Gxpi2:0@(0,1)', 'Gcnot:0:1@(0,1)', 'Gypi2:1Gxpi2:0@(0,1)', '[]@(0,1)',
            'Gxpi2:0Gxpi2:0@(0,1)', 'Gzr;0.5:0Gcnot:0:1@(0,1)', 'Gxpi2:1@(0,1)']
    return ExperimentDesign([Circuit(s) for s in strs]), JDesign([JCircuit(s) for s in strs])


def test_ibmq_staging_and_ingestion_match_jax():
    td, jd = _designs()
    t = TIBMQ(td, circuits_per_batch=3, seed=11)
    j = JIBMQ(jd, circuits_per_batch=3, seed=11)
    assert [c.str for c in t.pygsti_circuits] == [c.str for c in j.pygsti_circuits]
    assert [[c.str for c in b] for b in t.pygsti_circuit_batches] == \
        [[c.str for c in b] for b in j.pygsti_circuit_batches]
    assert len(t.pygsti_circuits) == 6                     # one duplicate removed
    rng = np.random.RandomState(2)
    counts = {c.str: {'%d%d' % (a, b): int(rng.randint(1, 50)) for a in (0, 1) for b in (0, 1)}
              for c in t.pygsti_circuits}
    tdata = t.add_counts_from_dict({c: counts[c.str] for c in t.pygsti_circuits})
    jdata = j.add_counts_from_dict({c: counts[c.str] for c in j.pygsti_circuits})
    for tc, jc in zip(t.pygsti_circuits, j.pygsti_circuits):
        assert {o[0]: n for o, n in tdata.dataset[tc].counts.items()} == \
            {o[0]: n for o, n in jdata.dataset[jc].counts.items()}
    # qiskit bitstrings are little-endian: '01' from qiskit is qubit 0 = 1
    assert tdata.dataset[t.pygsti_circuits[0]][('10',)] == counts[t.pygsti_circuits[0].str]['01']
    # results retrieved per batch are matched to the batches' circuits
    t.batch_results = [[counts[c.str] for c in b] for b in t.pygsti_circuit_batches]
    assert t._build_data().dataset.keys() == tdata.dataset.keys()


def test_ibmq_checkpoint_keeps_the_staged_order(tmp_path):
    """ROADMAP.md section 3: the JAX package's from_dir re-batches the
    circuits in the design's order, so results retrieved for the staged
    jobs meet other circuits; the port reads back the staged order."""
    td, jd = _designs()
    t = TIBMQ(td, circuits_per_batch=3, seed=11)
    t.job_ids = ['a', 'b']
    t.write(str(tmp_path / 't'))
    back = TIBMQ.from_dir(str(tmp_path / 't'))
    assert back.pygsti_circuits == t.pygsti_circuits and back.job_ids == ['a', 'b']
    assert back.pygsti_circuit_batches == t.pygsti_circuit_batches
    j = JIBMQ(jd, circuits_per_batch=3, seed=11)
    j.write(str(tmp_path / 'j'))
    jback = JIBMQ.from_dir(str(tmp_path / 'j'))
    assert [c.str for c in jback.pygsti_circuits] != [c.str for c in j.pygsti_circuits]


def test_ibmq_submission_needs_qiskit():
    td, _ = _designs()
    t = TIBMQ(td)
    try:
        import qiskit  # noqa: F401
        pytest.skip("qiskit is installed")
    except ImportError:
        pass
    with pytest.raises(ImportError, match="qiskit"):
        t.transpile()
    with pytest.raises(ImportError, match="qiskit"):
        tibmq._require_qiskit()


def test_process_tomography_matches_jax():
    theta = 0.37
    U = np.array([[np.cos(theta / 2), -1j * np.sin(theta / 2)],
                  [-1j * np.sin(theta / 2), np.cos(theta / 2)]])

    def channel(psi):
        out = U @ psi
        return np.outer(out, out.conj())

    def depol(psi, lam=0.1):
        rho = np.outer(psi, psi.conj())
        return (1 - lam) * rho + lam * np.eye(rho.shape[0]) / rho.shape[0]

    def decaying(psi):
        return [depol(psi, lam) for lam in (0.0, 0.2)]
    P1 = tpt.run_process_tomography(channel, n_qubits=1, basis='pp')
    assert np.allclose(P1, unitary_to_superop(U, 'pp'), atol=1e-10)
    np.testing.assert_allclose(P1, jpt.run_process_tomography(channel, 1, basis='pp'),
                               rtol=0, atol=1e-12)
    P2 = tpt.run_process_tomography(depol, n_qubits=2, basis='pp')
    assert np.allclose(P2, np.diag([1.0] + [0.9] * 15), atol=1e-10)
    np.testing.assert_allclose(P2, jpt.run_process_tomography(depol, 2, basis='pp'),
                               rtol=0, atol=1e-12)
    Pt = tpt.run_process_tomography(decaying, 1, basis='gm', time_dependent=True)
    Pj = jpt.run_process_tomography(decaying, 1, basis='gm', time_dependent=True)
    assert len(Pt) == 2
    for a, b in zip(Pt, Pj):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
    a, b = np.array([[1, 2], [3, 4.0]]), np.eye(2)
    np.testing.assert_array_equal(tpt.multi_kron(a, b, a), jpt.multi_kron(a, b, a))
