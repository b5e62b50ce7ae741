"""The port's one-call drivers against the JAX package's on smq1Q_XYI at
maxL [1, 2], on the same counts: run_long_sequence_gst from a dataset file
and from a DataSet, run_long_sequence_gst_base, run_stdpractice_gst,
run_model_test (fault (d) of ROADMAP.md section 3), run_linear_gst, the
advanced options and output_pkl.  The final 2DeltaLogL and N_sigma agree
within 1e-3 relative (the parity bar); LGST, a linear inversion, within
1e-10."""

import pickle

import numpy as np
import pytest
import torch

import pygsti_tpu.modelpacks.smq1Q_XYI as jmp
from pygsti_tpu.circuits.gstcircuits import create_lsgst_circuit_lists as j_lists
from pygsti_tpu.data import simulate_data as jsim
from pygsti_tpu.drivers import longsequence as jdrv
from pygsti_tpu.io import readers as jreaders, writers as jwriters

import pygsti_tpu_torch.modelpacks.smq1Q_XYI as tmp
from pygsti_tpu_torch.circuits.gstcircuits import create_lsgst_circuit_lists as t_lists
from pygsti_tpu_torch.drivers import longsequence as tdrv
from pygsti_tpu_torch.forwardsims.forwardsim import SimpleForwardSimulator
from pygsti_tpu_torch.io import readers as treaders

MAXL = [1, 2]
BAR = 1e-3


@pytest.fixture(scope='module', autouse=True)
def one_thread():
    """torch on one thread in this module, beside the other test processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def in_tmp(tmp_path, monkeypatch):
    """The drivers write checkpoints under the working directory."""
    monkeypatch.chdir(tmp_path)


@pytest.fixture(scope='module')
def data(tmp_path_factory):
    """1,000 shots of a depolarized smq1Q_XYI on its maxL [1, 2] design,
    drawn by the JAX package and written to a dataset file."""
    jt = jmp.target_model('full TP')
    lists = j_lists(jt, jmp.prep_fiducials(), jmp.meas_fiducials(), jmp.germs(), MAXL)
    jds = jsim(jmp.target_model('full TP').depolarize(op_noise=0.04, spam_noise=0.02),
               list(lists[-1]), 1000, seed=2024)
    path = str(tmp_path_factory.mktemp('data') / 'dataset.txt')
    jwriters.write_dataset(path, jds)
    return dict(path=path, jds=jreaders.read_dataset(path), tds=treaders.read_dataset(path))


def _args(mp):
    return (mp.prep_fiducials(), mp.meas_fiducials(), mp.germs(), MAXL)


def _rel(a, b):
    return abs(a - b) / abs(b)


def _assert_parity(jest, test):
    jf, tf = jest.parameters['final_objfn_value'], test.parameters['final_objfn_value']
    assert _rel(tf, jf) < BAR
    assert test.parameters['final_dof'] == jest.parameters['final_dof']
    assert _rel(test.misfit_sigma(), jest.misfit_sigma()) < BAR


def test_run_long_sequence_gst_from_a_file_and_a_dataset(data, tmp_path):
    """From the file and from the DataSet read from it, with 'stdgaugeopt';
    the run from the file also pickles its results (output_pkl), which
    unpickle to the same models, N_sigma and probabilities."""
    jres = jdrv.run_long_sequence_gst(data['path'], jmp.target_model('full TP'),
                                      *_args(jmp), verbosity=0)
    jest = jres.estimates['GateSetTomography']
    pkl = str(tmp_path / 'results.pkl')
    from_file = tdrv.run_long_sequence_gst(data['path'], tmp.target_model('full TP'),
                                           *_args(tmp), output_pkl=pkl, verbosity=0,
                                           device='cpu')
    from_set = tdrv.run_long_sequence_gst(data['tds'], tmp.target_model('full TP'),
                                          *_args(tmp), verbosity=0, device='cpu')
    for res in (from_file, from_set):
        test = res.estimates['GateSetTomography']
        _assert_parity(jest, test)
        assert list(test.models) == list(jest.models)
    a, b = (r.estimates['GateSetTomography'] for r in (from_file, from_set))
    assert a.parameters['final_objfn_value'] == b.parameters['final_objfn_value']
    with open(pkl, 'rb') as f:
        back = pickle.load(f).estimates['GateSetTomography']
    for k, m in a.models.items():
        assert np.array_equal(back.models[k].to_vector(), m.to_vector())
    assert back.misfit_sigma() == a.misfit_sigma()
    assert back.parameters['optimizer_results'][-1][-1].objective.name == \
        a.parameters['optimizer_results'][-1][-1].objective.name
    circuits = list(from_file.circuit_lists['final'])[:10]
    p0 = SimpleForwardSimulator(a.models['stdgaugeopt'], 'cpu').bulk_probs(circuits)
    p1 = SimpleForwardSimulator(back.models['stdgaugeopt'], 'cpu').bulk_probs(circuits)
    assert all(p0[c] == p1[c] for c in circuits)


def test_run_long_sequence_gst_base_and_advanced_options(data):
    """Explicit circuit lists, with every supported advanced option: a
    'chi2' objective from the target, an iteration cap, a tolerance and an
    estimate label."""
    adv = {'objective': 'chi2', 'max_iterations': 60, 'tolerance': 1e-7,
           'starting_point': 'target', 'estimate_label': 'mine', 'bad_fit_threshold': 5.0}
    jt, tt = jmp.target_model('full TP'), tmp.target_model('full TP')
    jres = jdrv.run_long_sequence_gst_base(data['jds'], jt, j_lists(jt, *_args(jmp)),
                                           advanced_options=adv, verbosity=0)
    tres = tdrv.run_long_sequence_gst_base(data['tds'], tt, t_lists(tt, *_args(tmp)),
                                           advanced_options=adv, verbosity=0, device='cpu')
    assert list(tres.estimates) == list(jres.estimates) == ['mine']
    _assert_parity(jres.estimates['mine'], tres.estimates['mine'])


def test_advanced_options_errors_match_jax(data):
    for bad in ({'nonsense': 1}, {'objective': 'logl', 'zzz': 2, 'aaa': 3}):
        with pytest.raises(ValueError) as je:
            jdrv._apply_advanced_options(bad)
        with pytest.raises(ValueError) as te:
            tdrv._apply_advanced_options(bad)
        assert str(te.value) == str(je.value)
        with pytest.raises(ValueError) as je:
            jdrv.run_linear_gst(data['jds'], jmp.target_model('full TP'), jmp.prep_fiducials(),
                                jmp.meas_fiducials(), advanced_options=bad, verbosity=0)
        with pytest.raises(ValueError) as te:
            tdrv.run_linear_gst(data['tds'], tmp.target_model('full TP'), tmp.prep_fiducials(),
                                tmp.meas_fiducials(), advanced_options=bad, verbosity=0,
                                device='cpu')
        assert str(te.value) == str(je.value)


def test_run_stdpractice_gst(data):
    """Modes 'full TP' and 'Target' from the file."""
    modes = ('full TP', 'Target')
    jres = jdrv.run_stdpractice_gst(data['path'], jmp.target_model('full TP'), *_args(jmp),
                                    modes=modes, verbosity=0)
    tres = tdrv.run_stdpractice_gst(data['path'], tmp.target_model('full TP'), *_args(tmp),
                                    modes=modes, verbosity=0, device='cpu')
    assert list(tres.estimates) == list(jres.estimates) == list(modes)
    for mode in modes:
        _assert_parity(jres.estimates[mode], tres.estimates[mode])


def _model_to_test(mp):
    return mp.target_model('full TP').depolarize(op_noise=0.03, spam_noise=0.01)


def test_run_model_test(data):
    jres = jdrv.run_model_test(_model_to_test(jmp), data['jds'], jmp.target_model('full TP'),
                               *_args(jmp), verbosity=0)
    tres = tdrv.run_model_test(_model_to_test(tmp), data['tds'], tmp.target_model('full TP'),
                               *_args(tmp), verbosity=0, device='cpu')
    (jname, jest), = jres.estimates.items()
    assert list(tres.estimates) == [jname]
    _assert_parity(jest, tres.estimates[jname])


def test_fault_d_run_model_test_reads_a_filename(data):
    """Fault (d): the JAX package's run_model_test hands a filename to
    ProtocolData as the dataset, which raises TypeError where the string is
    indexed by a circuit; the port reads the file
    as every other driver does, to the result of the DataSet."""
    with pytest.raises(TypeError):
        jdrv.run_model_test(_model_to_test(jmp), data['path'], jmp.target_model('full TP'),
                            *_args(jmp), verbosity=0)
    runs = [tdrv.run_model_test(_model_to_test(tmp), src, tmp.target_model('full TP'),
                                *_args(tmp), verbosity=0, device='cpu')
            for src in (data['path'], data['tds'])]
    (name, a), = runs[0].estimates.items()
    assert a.parameters['final_objfn_value'] == runs[1].estimates[name] \
        .parameters['final_objfn_value']


def test_run_linear_gst(data):
    """LGST from the file, gauge-optimized with 'stdgaugeopt': the LGST
    model within 1e-10 of the JAX package's, the gauge-optimized one's
    2DeltaLogL within the parity bar."""
    from pygsti_tpu.objectivefns.objectivefns import ObjectiveFunctionBuilder as JB
    from pygsti_tpu_torch.objectivefns.objectivefns import ObjectiveFunctionBuilder as TB
    jres = jdrv.run_linear_gst(data['path'], jmp.target_model('full TP'), jmp.prep_fiducials(),
                               jmp.meas_fiducials(), verbosity=0)
    tres = tdrv.run_linear_gst(data['path'], tmp.target_model('full TP'), tmp.prep_fiducials(),
                               tmp.meas_fiducials(), verbosity=0, device='cpu')
    (name, jest), = jres.estimates.items()
    test = tres.estimates[name]
    jm, tm = jest.models['final iteration estimate'], test.models['final iteration estimate']
    for lbl, op in jm.operations.items():
        assert np.max(np.abs(tm.operations[lbl].dense() - np.asarray(op.to_dense()))) < 1e-10
    circuits = list(data['jds'].keys())
    jv = 2 * JB.create_from('logl').build(jest.models['stdgaugeopt'], data['jds'], circuits).fn()
    tv = 2 * TB.create_from('logl').build(test.models['stdgaugeopt'], data['tds'],
                                          [c for c in data['tds'].keys()], device='cpu').fn()
    assert _rel(float(tv), float(jv)) < BAR
