"""ModelTest, simulate_data's options and the free-form simulators in the
port against the JAX package: objective values and N_sigma on the same
counts (a dense 3-qubit layout and a sparse 4-qubit one of the observed
outcomes only), checkpoints and resume, the outcomes simulate_data records
and their degrees of freedom, and ModelFreeformSimulator's process matrix
and final state."""

import numpy as np
import pytest

from pygsti_tpu.circuits import Circuit as JCircuit
from pygsti_tpu.data import simulate_data as j_simulate
from pygsti_tpu.data.dataset import DataSet as JDataSet
from pygsti_tpu.models import cloudnoisemodel as jcnm
from pygsti_tpu.models import modelconstruction as jmc
from pygsti_tpu.processors import QubitProcessorSpec as JSpec
from pygsti_tpu.protocols import protocol as jproto
from pygsti_tpu.protocols.modeltest import ModelTest as JModelTest

from pygsti_tpu_torch.circuits.circuit import Circuit
from pygsti_tpu_torch.data.dataset import DataSet
from pygsti_tpu_torch.data.datasetconstruction import simulate_data
from pygsti_tpu_torch.forwardsims.forwardsim import SimpleForwardSimulator
from pygsti_tpu_torch.models import cloudnoisemodel as tcnm
from pygsti_tpu_torch.models import modelconstruction as tmc
from pygsti_tpu_torch.processors.processorspec import QubitProcessorSpec as TSpec
from pygsti_tpu_torch.protocols import protocol as tproto
from pygsti_tpu_torch.protocols.gst import GateSetTomographyDesign
from pygsti_tpu_torch.protocols.modeltest import ModelTest, ModelTestCheckpoint

GATES = ['Gxpi2', 'Gypi2', 'Gcnot']


def _random_circuits(nq, n, seed, depth=6):
    """bench.py's recipe: 1-qubit gates on random qubits, a CNOT after
    every second one."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        layers = []
        for t in range(depth):
            layers.append("%s:%d" % (['Gxpi2', 'Gypi2'][rng.randint(2)], rng.randint(nq)))
            if t % 2 == 1:
                c = rng.randint(nq - 1)
                layers.append("Gcnot:%d:%d" % (c, c + 1))
        out.append(''.join(layers) + '@(%s)' % ','.join(str(q) for q in range(nq)))
    return out


def _same_counts(jds, strs):
    tds = DataSet()
    for s in strs:
        tds.add_count_dict(Circuit(s), dict(jds[JCircuit(s)].counts))
    return tds


CASES = {
    # 3 qubits, 8 outcomes: a dense layout
    'xfree-3q': (3, 12, lambda mc, spec: mc.create_crosstalk_free_model(
        spec, depolarization_strengths={'Gxpi2': 0.02, 'Gypi2': 0.02, 'Gcnot': 0.05}), True),
    # 4 qubits, 16 outcomes, zero counts not recorded: observed outcomes only
    'cloud-4q': (4, 10, lambda mc, spec: mc.create_cloud_crosstalk_model_from_hops_and_weights(
        spec, maxhops=0, max_idle_weight=0, extra_gate_weight=1, gate_type='H+s'), False),
}


@pytest.fixture(scope='module', params=sorted(CASES))
def case(request):
    nq, n, build, record_zeros = CASES[request.param]
    jm = build(jmc if request.param.startswith('xfree') else jcnm,
               JSpec(nq, GATES, geometry='line'))
    tm = build(tmc if request.param.startswith('xfree') else tcnm,
               TSpec(nq, GATES, geometry='line'))
    if tm.num_params and request.param.startswith('cloud'):
        theta = 0.01 * np.random.RandomState(3).randn(tm.num_params)
        jm.from_vector(theta)
        tm.from_vector(theta)
    strs = _random_circuits(nq, n, seed=7)
    jds = j_simulate(jm, [JCircuit(s) for s in strs], 500, seed=77,
                     record_zero_counts=record_zeros)
    return dict(name=request.param, jm=jm, tm=tm, strs=strs, jds=jds,
                tds=_same_counts(jds, strs))


def test_modeltest_equals_the_jax_packages(case):
    """2DeltaLogL, the degrees of freedom and N_sigma of ModelTest on the
    same counts: 1e-9 relative; the sparse case leaves outcomes out."""
    jres = JModelTest(case['jm'], verbosity=0).run(
        jproto.ProtocolData(jproto.ExperimentDesign([JCircuit(s) for s in case['strs']]),
                            case['jds']), disable_checkpointing=True)
    tres = ModelTest(case['tm'], verbosity=0, device='cpu').run(
        tproto.ProtocolData(tproto.ExperimentDesign([Circuit(s) for s in case['strs']]),
                            case['tds']), disable_checkpointing=True)
    je, te = jres.estimates['ModelTest'], tres.estimates['ModelTest']
    jv, tv = je.parameters['final_objfn_value'], te.parameters['final_objfn_value']
    assert abs(tv - jv) <= 1e-9 * abs(jv)
    assert te.parameters['final_dof'] == je.parameters['final_dof']
    assert abs(te.misfit_sigma() - je.misfit_sigma()) <= 1e-9 * max(1.0, abs(je.misfit_sigma()))
    layout = SimpleForwardSimulator(case['tm'], 'cpu').create_layout(
        [Circuit(s) for s in case['strs']], case['tds'])
    n_out = 2 ** case['tm'].num_qubits
    if case['name'] == 'cloud-4q':
        assert layout.has_omitted and layout.num_elements < n_out * len(case['strs'])
    else:
        assert layout.num_elements == n_out * len(case['strs'])


def test_modeltest_builds_no_jacobian(case, monkeypatch):
    """ModelTest evaluates probabilities only: neither Tv nor a Jacobian
    function is called (a 5-qubit model could not afford them)."""
    from pygsti_tpu_torch.objectivefns import objectivefns

    def refuse(*args, **kwargs):
        raise AssertionError("a Jacobian was evaluated")
    tm = case['tm']
    monkeypatch.setattr(type(tm), 'flat_tensors_jacobian_fn', lambda self: refuse)
    monkeypatch.setattr(objectivefns, 'bwd_jacobian_accumulate', refuse)
    res = ModelTest(tm, verbosity=0, device='cpu').run(
        tproto.ProtocolData(tproto.ExperimentDesign([Circuit(s) for s in case['strs']]),
                            case['tds']), disable_checkpointing=True)
    assert np.isfinite(res.estimates['ModelTest'].misfit_sigma())


def test_checkpoint_and_resume(tmp_path):
    """Checkpoints per circuit list; a run resumed from the first list's
    checkpoint skips it and gives the same values; the JAX package's
    checkpoint reads here."""
    tm = tmc.create_crosstalk_free_model(TSpec(2, GATES, geometry='line'),
                                         depolarization_strengths={'Gxpi2': 0.03})
    strs = _random_circuits(2, 8, seed=1, depth=4)
    lists = [[Circuit(s) for s in strs[:4]], [Circuit(s) for s in strs]]
    ds = simulate_data(tm, lists[-1], 1000, seed=5, device='cpu')
    data = tproto.ProtocolData(GateSetTomographyDesign(tm, lists), ds)
    path = str(tmp_path / 'mt')
    full = ModelTest(tm, verbosity=0, device='cpu').run(data, checkpoint_path=path)
    first = ModelTestCheckpoint.read(path + '_iteration_0.json')
    assert first.last_completed_iter == 0 and len(first.objfn_vals) == 1
    resumed = ModelTest(tm, verbosity=0, device='cpu').run(data, checkpoint=first,
                                                          checkpoint_path=str(tmp_path / 'r'))
    a, b = full.estimates['ModelTest'], resumed.estimates['ModelTest']
    assert a.parameters['objfn_values_by_iter'] == b.parameters['objfn_values_by_iter']
    assert not (tmp_path / 'r_iteration_0.json').exists()
    assert (tmp_path / 'r_iteration_1.json').exists()
    from pygsti_tpu.protocols.modeltest import ModelTestCheckpoint as JCheckpoint
    JCheckpoint(0, [1.5], [[0.5, 1.0]], 'ModelTest').write(str(tmp_path / 'j.json'))
    back = ModelTestCheckpoint.read(str(tmp_path / 'j.json'))
    assert (back.last_completed_iter, back.objfn_vals, back.percircuit_vals) == \
        (0, [1.5], [[0.5, 1.0]])
    with pytest.raises(TypeError):
        ModelTest(tm, verbosity=0, device='cpu').run(data, checkpoint=object(),
                                                     checkpoint_path=path)


@pytest.mark.parametrize("record", [True, False])
def test_recorded_outcomes_and_dof(record):
    """The same counts added with and without record_zero_counts: the same
    recorded outcomes and degrees of freedom as the JAX package's DataSet."""
    counts = [{'000': 3, '001': 0, '010': 5, '111': 0}, {'000': 0, '101': 10},
              {'011': 1, '110': 0, '000': 0, '001': 0}]
    strs = ['Gxpi2:0@(0,1,2)', 'Gypi2:1@(0,1,2)', 'Gxpi2:2Gypi2:2@(0,1,2)']
    jds, tds = JDataSet(), DataSet()
    for s, c in zip(strs, counts):
        jds.add_count_dict(JCircuit(s), c, record_zero_counts=record)
        tds.add_count_dict(Circuit(s), c, record_zero_counts=record)
    for s in strs:
        assert dict(tds[Circuit(s)].counts) == dict(jds[JCircuit(s)].counts)
    assert tds.degrees_of_freedom() == jds.degrees_of_freedom() == (7 if record else 1)


@pytest.mark.parametrize("sample_error", ['none', 'round', 'multinomial'])
def test_simulate_data_options(sample_error):
    """simulate_data from equal models: 'none' and 'round' give the JAX
    package's counts; without record_zero_counts the unobserved outcomes
    are not recorded and the degrees of freedom fall; an alias is
    simulated in place of its layer; 'keepseparate' raises."""
    jm = jmc.create_crosstalk_free_model(JSpec(2, GATES, geometry='line'),
                                         depolarization_strengths={'Gxpi2': 0.013})
    tm = tmc.create_crosstalk_free_model(TSpec(2, GATES, geometry='line'),
                                         depolarization_strengths={'Gxpi2': 0.013})
    strs = _random_circuits(2, 6, seed=2, depth=3) + ['Gxpi2:0@(0,1)']
    jds = j_simulate(jm, [JCircuit(s) for s in strs], 97, sample_error=sample_error, seed=4,
                     record_zero_counts=False)
    tds = simulate_data(tm, [Circuit(s) for s in strs], 97, sample_error=sample_error, seed=4,
                        record_zero_counts=False, device='cpu')
    if sample_error != 'multinomial':
        # an expectation of 1e-17 (rounding of a zero probability) is recorded
        # by one package and not the other: compare every outcome's count
        for s in strs:
            tc, jc = tds[Circuit(s)].counts, jds[JCircuit(s)].counts
            assert max(abs(tc.get(o, 0) - jc.get(o, 0)) for o in set(tc) | set(jc)) < 1e-9
    assert all(n != 0 for s in strs for n in tds[Circuit(s)].counts.values())
    full = simulate_data(tm, [Circuit(s) for s in strs], 97, sample_error=sample_error, seed=4,
                         device='cpu')
    assert tds.degrees_of_freedom() < full.degrees_of_freedom() == 3 * len(strs)
    aliased = simulate_data(tm, [Circuit('Gx@(0,1)')], 97, sample_error='none', device='cpu',
                            alias_dict={'Gx': Circuit('Gxpi2:0@(0,1)')})
    direct = simulate_data(tm, [Circuit('Gxpi2:0@(0,1)')], 97, sample_error='none', device='cpu')
    assert dict(aliased[Circuit('Gx@(0,1)')].counts) == \
        dict(direct[Circuit('Gxpi2:0@(0,1)')].counts)
    with pytest.raises(NotImplementedError):
        simulate_data(tm, [Circuit(strs[0])], 10, collision_action='keepseparate', device='cpu')


def test_freeform_simulator():
    """ModelFreeformSimulator's process matrix, final state and
    probabilities of a crosstalk-free model, and its free-form data, equal
    the JAX package's within 1e-13."""
    from pygsti_tpu.protocols.freeformsim import ModelFreeformSimulator as JSim
    from pygsti_tpu_torch.protocols.freeformsim import ModelFreeformSimulator as TSim
    kw = dict(depolarization_strengths={'Gxpi2': 0.02},
              lindblad_error_coeffs={'Gcnot': {('H', 'XZ'): 0.01}})
    jm = jmc.create_crosstalk_free_model(JSpec(2, GATES, geometry='line'), **kw)
    tm = tmc.create_crosstalk_free_model(TSpec(2, GATES, geometry='line'), **kw)
    s = 'Gxpi2:0Gcnot:0:1Gypi2:1@(0,1)'
    jm.sim.create_layout([JCircuit(s)])
    jsim, tsim = JSim({'m': jm}), TSim({'m': tm}, device='cpu')
    jout = jsim.compute_process_matrix(jm, JCircuit(s), True, True)
    tout = tsim.compute_process_matrix(tm, Circuit(s), True, True)
    for a, b in zip(tout, jout):
        assert np.max(np.abs(a - np.asarray(b))) < 1e-13
    assert np.max(np.abs(tsim.compute_final_state(tm, Circuit(s))
                         - np.asarray(jsim.compute_final_state(jm, JCircuit(s))))) < 1e-13
    jd, td = jsim.compute_freeform_data(JCircuit(s)), tsim.compute_freeform_data(Circuit(s))
    assert jd.keys() == td.keys() and max(abs(jd[k] - td[k]) for k in jd) < 1e-13
    data = tsim.run(tproto.ExperimentDesign([Circuit(s), Circuit('Gxpi2:1@(0,1)')]))
    assert len(data.dataset) == 2 and data.dataset[Circuit(s)] == td


def test_model_dataset_simulator():
    """ModelDatasetSimulator draws the counts simulate_data draws."""
    from pygsti_tpu_torch.protocols.freeformsim import ModelDatasetSimulator
    tm = tmc.create_crosstalk_free_model(TSpec(2, GATES, geometry='line'),
                                         depolarization_strengths={'Gypi2': 0.02})
    circuits = [Circuit(s) for s in _random_circuits(2, 4, seed=9, depth=3)]
    data = ModelDatasetSimulator(tm, 200, seed=3, device='cpu').run(
        tproto.ExperimentDesign(circuits))
    ref = simulate_data(tm, circuits, 200, seed=3, device='cpu')
    assert all(dict(data.dataset[c].counts) == dict(ref[c].counts) for c in circuits)
