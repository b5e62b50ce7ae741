"""The port's protocol layer against the JAX package's on the small
smq1Q_XYI design of test_torch_gst.py, fed the JAX package's counts:
GateSetTomography.run with 'stdgaugeopt', StandardGST, checkpoints written
by either package, serialization, and the pieces the protocols are built
from."""

import json
import os

import numpy as np
import pytest

import pygsti_tpu.modelpacks.smq1Q_XYI as jmp
from pygsti_tpu.circuits.gstcircuits import create_lsgst_circuit_lists as j_lists
from pygsti_tpu.data import simulate_data as j_simulate
from pygsti_tpu.protocols import gst as jgst
from pygsti_tpu.protocols.protocol import ProtocolData as JProtocolData

import pygsti_tpu_torch.modelpacks.smq1Q_XYI as tmp
from pygsti_tpu_torch.baseobjs.nicelyserializable import NicelySerializable
from pygsti_tpu_torch.baseobjs.profiler import DummyProfiler, Profiler
from pygsti_tpu_torch.baseobjs.verbosityprinter import VerbosityPrinter
from pygsti_tpu_torch.circuits.gstcircuits import create_lsgst_circuit_lists as t_lists
from pygsti_tpu_torch.data.dataset import DataSet
from pygsti_tpu_torch.models.explicitmodel import ExplicitOpModel
from pygsti_tpu_torch.models import modelconstruction as tmc
from pygsti_tpu_torch.protocols import gst as tgst
from pygsti_tpu_torch.protocols.estimate import Estimate
from pygsti_tpu_torch.protocols.protocol import (CircuitListsDesign, ExperimentDesign,
                                                 ProtocolData as TProtocolData)

NAME = 'GateSetTomography'


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    """GateSetTomography.run with 'stdgaugeopt' in both packages from the
    target on the same counts, each writing its checkpoints into a
    temporary directory."""
    ckdir = tmp_path_factory.mktemp('gst_checkpoints')
    jt, tt = jmp.target_model('full TP'), tmp.target_model('full TP')
    jl = j_lists(jt, jmp.prep_fiducials(), jmp.meas_fiducials(), jmp.germs(), [1, 2, 4])
    tl = t_lists(tt, tmp.prep_fiducials(), tmp.meas_fiducials(), tmp.germs(), [1, 2, 4])
    jgen = jmp.target_model('full TP').depolarize(op_noise=0.05, spam_noise=0.02)
    jds = j_simulate(jgen, list(jl[-1]), 1000, seed=1234)
    tds = DataSet()
    for jc, tc in zip(jl[-1], tl[-1]):
        tds.add_count_dict(tc, dict(jds[jc].counts))
    jdata = JProtocolData(jgst.GateSetTomographyDesign(jt, jl), jds)
    tdata = TProtocolData(tgst.GateSetTomographyDesign(tt, tl), tds)
    jres = jgst.GateSetTomography(jgst.GSTInitialModel(model=jt.copy()),
                                  gaugeopt_suite='stdgaugeopt', verbosity=0) \
        .run(jdata, checkpoint_path=str(ckdir / 'jax'))
    tres = tgst.GateSetTomography(tgst.GSTInitialModel(model=tt.copy()),
                                  gaugeopt_suite='stdgaugeopt', verbosity=0, device="cpu") \
        .run(tdata, checkpoint_path=str(ckdir / 'port'))
    return dict(jt=jt, tt=tt, jdata=jdata, tdata=tdata, jres=jres, tres=tres, ckdir=ckdir)


def test_gst_run_reaches_the_jax_fit(runs):
    """Stage objective values within 1e-3 relative, misfit_sigma within
    1e-3, the same model keys and gauge-opt keys."""
    jest, test_ = runs['jres'].estimates[NAME], runs['tres'].estimates[NAME]
    jvals = sum(jest.parameters['raw_objective_values'], [])
    tvals = sum(test_.parameters['raw_objective_values'], [])
    assert len(tvals) == len(jvals) == 4
    assert np.allclose(tvals, jvals, rtol=1e-3)
    assert test_.parameters['final_dof'] == jest.parameters['final_dof']
    assert abs(test_.misfit_sigma() - jest.misfit_sigma()) < 1e-3
    assert list(test_.models.keys()) == list(jest.models.keys())
    assert list(test_.goparameters.keys()) == list(jest.goparameters.keys()) == ['stdgaugeopt']
    assert list(runs['tres'].circuit_lists.keys()) == list(runs['jres'].circuit_lists.keys())
    assert test_.parent is runs['tres'] and runs['tres'][NAME] is test_
    assert 'gauge optimization + badfit' in test_.parameters['profiler']


def test_gst_run_gauge_optimized_model(runs):
    """The 'stdgaugeopt' model: its distance to the target within 1e-5 of
    the JAX package's, and the probabilities of the final iteration
    estimate (a gauge transformation changes none)."""
    from pygsti_tpu_torch.forwardsims.forwardsim import SimpleForwardSimulator
    jest, test_ = runs['jres'].estimates[NAME], runs['tres'].estimates[NAME]
    jd = jest.models['stdgaugeopt'].frobeniusdist(runs['jt'])
    td = test_.models['stdgaugeopt'].frobeniusdist(runs['tt'])
    assert abs(td - jd) < 1e-5, (td, jd)
    stats = test_.parameters['gaugeopt_stats']['stdgaugeopt']
    assert [s['group'] for s in stats] == ['TP', 'Unitary', 'TP Spam']
    assert all(s['objective_after'] <= s['objective_before'] for s in stats)
    circuits = list(runs['tdata'].edesign.circuit_lists[0])
    p0 = SimpleForwardSimulator(test_.models['final iteration estimate'], "cpu") \
        .bulk_probs(circuits)
    p1 = SimpleForwardSimulator(test_.models['stdgaugeopt'], "cpu").bulk_probs(circuits)
    assert max(abs(p0[c][o] - p1[c][o]) for c in circuits for o in p0[c]) < 1e-10


def test_standard_gst(runs):
    """StandardGST with a fit mode and the 'Target' model test: the same
    estimate keys, the 'Target' test's objective value within 1e-9 relative,
    and the 'full TP' estimate at the GateSetTomography fit's value."""
    jres = jgst.StandardGST(modes=('full TP', 'Target'), verbosity=0) \
        .run(runs['jdata'], disable_checkpointing=True)
    tres = tgst.StandardGST(modes=('full TP', 'Target'), verbosity=0, device="cpu") \
        .run(runs['tdata'], disable_checkpointing=True)
    assert list(tres.estimates.keys()) == list(jres.estimates.keys()) == ['full TP', 'Target']
    jv = jres.estimates['Target'].parameters['final_objfn_value']
    tv = tres.estimates['Target'].parameters['final_objfn_value']
    assert abs(tv - jv) <= 1e-9 * abs(jv)
    assert tres.estimates['Target'].parameters['final_dof'] == \
        jres.estimates['Target'].parameters['final_dof']
    assert list(tres.estimates['Target'].models.keys()) == \
        list(jres.estimates['Target'].models.keys())
    assert np.isclose(tres.estimates['full TP'].parameters['final_objfn_value'],
                      jres.estimates['full TP'].parameters['final_objfn_value'], rtol=1e-3)
    assert 'stdgaugeopt' in tres.estimates['full TP'].models


def test_standard_gst_checkpoints_and_modes(runs, tmp_path):
    """Per-mode checkpoints nest under the run's; a model to test is scored
    like 'Target'; an unknown mode raises the JAX package's error."""
    short = TProtocolData(tgst.GateSetTomographyDesign(
        runs['tt'], runs['tdata'].edesign.circuit_lists[:1]), runs['tdata'].dataset)
    proto = tgst.StandardGST(modes='full,mine', models_to_test={'mine': runs['tt'].copy()},
                             gaugeopt_suite=None, verbosity=0, device="cpu")
    res = proto.run(short, checkpoint_path=str(tmp_path / 'std'))
    assert sorted(os.listdir(tmp_path)) == ['std.json', 'std_full_iteration_0.json']
    ck = tgst.StandardGSTCheckpoint.read(str(tmp_path / 'std.json'))
    assert ck.completed_modes == ['full', 'mine'] and list(ck.children) == ['full']
    assert np.array_equal(ck.children['full'].mdl_list[-1].to_vector(),
                          res.estimates['full'].models['final iteration estimate'].to_vector())
    assert res.estimates['mine'].misfit_sigma() > 10
    with pytest.raises(ValueError, match="Unknown gate type 'nope'"):
        tgst.StandardGST(modes=('nope',), verbosity=0, device="cpu") \
            .run(short, disable_checkpointing=True)
    with pytest.raises(TypeError, match="StandardGSTCheckpoint"):
        proto.run(short, checkpoint=ck.children['full'], checkpoint_path=str(tmp_path / 'x'))


# -- the Lindblad modes -----------------------------------------------------------------

def _std_designs(runs):
    """Standard designs (with fiducials, so LGST can run) on the first list
    in both packages, over the fixture's data."""
    tdesign = tgst.StandardGSTDesign(runs['tt'], tmp.prep_fiducials(), tmp.meas_fiducials(),
                                     tmp.germs(), [1])
    jdesign = jgst.StandardGSTDesign(runs['jt'], jmp.prep_fiducials(), jmp.meas_fiducials(),
                                     jmp.germs(), [1])
    return (TProtocolData(tdesign, runs['tdata'].dataset),
            JProtocolData(jdesign, runs['jdata'].dataset))


def _member_classes(model):
    return {type(o).__name__ for d in (model.preps, model.povms, model.operations)
            for o in d.values()}


@pytest.mark.parametrize("mode", ['CPTPLND', 'H+S'])
def test_standard_gst_lindblad_mode_fits_lindblad_members(runs, mode):
    """A Lindblad mode on a design that LGST could seed: the seed is the
    converted target, every iterate keeps composed members and the mode's
    parameter count.  'CPTPLND' fits the depolarized data; 'H+S' cannot
    from this seed: its stochastic coefficients are parameters squared, 0 is
    a stationary point, and they stay exactly 0 (the JAX package's
    semantics, kept)."""
    tdata, _ = _std_designs(runs)
    res = tgst.StandardGST(modes=(mode,), gaugeopt_suite=None, verbosity=0, device="cpu") \
        .run(tdata, disable_checkpointing=True)
    est = res.estimates[mode]
    converted = tgst._convert_target(runs['tt'], mode)
    assert np.array_equal(est.models['seed'].to_vector(), converted.to_vector())
    for key in ('seed', 'iteration 0 estimate', 'final iteration estimate'):
        assert _member_classes(est.models[key]) == {'ComposedState', 'ComposedPOVM',
                                                    'ComposedOp'}
        assert est.models[key].num_params == {'CPTPLND': 60, 'H+S': 30}[mode]
    values = est.parameters['raw_objective_values'][0]
    assert est.models['final iteration estimate'].default_gate_type == mode
    assert np.isfinite(values).all()
    final = est.models['final iteration estimate']
    if mode == 'CPTPLND':
        assert est.misfit_sigma() < 10
    else:
        stochastic = [x for d in final.errorgen_coefficients().values()
                      for k, x in d.items() if k.errorgen_type == 'S']
        assert len(stochastic) == 15 and not any(stochastic) and est.misfit_sigma() > 100
    assert list(est.models) == ['target', 'seed', 'iteration 0 estimate',
                                'final iteration estimate']


def test_jax_package_cptplnd_mode_fits_full_members(runs):
    """A record of the JAX package's behaviour, not of the port's: its
    'CPTPLND' mode seeds from LGST, whose fallback re-parameterizes every
    member it does not know as full, so the seed and the estimate filed
    under 'CPTPLND' have fully parameterized members.  If this test fails
    the JAX package has changed and the port's start rule can follow it."""
    _, jdata = _std_designs(runs)
    res = jgst.StandardGST(modes=('CPTPLND',), gaugeopt_suite=None, verbosity=0) \
        .run(jdata, disable_checkpointing=True)
    est = res.estimates['CPTPLND']
    for key in ('seed', 'final iteration estimate'):
        assert _member_classes(est.models[key]) == {'FullState', 'UnconstrainedPOVM',
                                                    'FullArbitraryOp'}
    assert _member_classes(jgst._convert_target(runs['jt'], 'CPTPLND')) == {
        'ComposedState', 'ComposedPOVM', 'ComposedOp'}


def test_lindblad_mode_with_gaugeopt_raises_as_in_jax(runs):
    """Composed members cannot be gauge-transformed in either package: a
    Lindblad fit with 'stdgaugeopt' raises after the fit, uncaught."""
    tdata, jdata = _std_designs(runs)
    with pytest.raises(NotImplementedError,
                       match="ComposedState does not support gauge transforms"):
        tgst.StandardGST(modes=('CPTPLND',), verbosity=0, device="cpu") \
            .run(tdata, disable_checkpointing=True)
    jproto = jgst.GateSetTomography(
        jgst.GSTInitialModel(target_model=jgst._convert_target(runs['jt'], 'CPTPLND'),
                             starting_point='target'), verbosity=0)
    with pytest.raises(NotImplementedError,
                       match="ComposedState does not support gauge transforms"):
        jproto.run(jdata, disable_checkpointing=True)


@pytest.mark.parametrize("mode", ['CPTPLND', 'full unitary'])
def test_lgst_start_for_a_target_lgst_cannot_fill(runs, mode):
    """"LGST" raises ValueError for a target with Lindblad or unitary
    members; "LGST-if-possible" starts from the target; run_lgst itself
    keeps the JAX package's fallback to full members."""
    from pygsti_tpu_torch.algorithms.core import run_lgst
    tdata, _ = _std_designs(runs)
    converted = tgst._convert_target(runs['tt'], mode)
    with pytest.raises(ValueError, match="Cannot start from LGST"):
        tgst.GSTInitialModel(target_model=converted, starting_point='LGST') \
            .retrieve_model(tdata.edesign, None, tdata.dataset)
    start = tgst.GSTInitialModel(target_model=converted) \
        .retrieve_model(tdata.edesign, None, tdata.dataset)
    assert start is not converted
    assert np.array_equal(start.to_vector(), converted.to_vector())
    assert _member_classes(start) == _member_classes(converted)
    lgst = run_lgst(tdata.dataset, tmp.prep_fiducials(), tmp.meas_fiducials(), converted)
    assert _member_classes(lgst) == {'FullState', 'UnconstrainedPOVM', 'FullArbitraryOp'}


def test_lindblad_model_reads_back_where_the_jax_package_cannot(tmp_path):
    """A Lindblad model serializes and reads back in the port; the JAX
    package's own state of such a model does not read back there."""
    tm = tmp.target_model('CPTPLND')
    back = ExplicitOpModel.loads(tm.dumps())
    assert np.array_equal(back.to_vector(), tm.to_vector())
    assert _member_classes(back) == _member_classes(tm)
    jm = jmp.target_model('CPTPLND')
    with pytest.raises(NotImplementedError, match="_from_nice_serialization"):
        type(jm).from_nice_serialization(jm.to_nice_serialization())


# -- checkpoints --------------------------------------------------------------------

def test_port_reads_a_jax_checkpoint_and_resumes(runs):
    """A checkpoint the JAX package wrote after its second list reads here
    to the same model vectors; resuming from it runs the last list only and
    lands on the JAX fit's value."""
    jax_file = str(runs['ckdir'] / 'jax_iteration_1.json')
    with open(jax_file) as f:
        assert json.load(f)['module'] == 'pygsti_tpu.protocols.gst'
    ck = tgst.GateSetTomographyCheckpoint.read(jax_file)
    jck = jgst.GateSetTomographyCheckpoint.read(jax_file)
    assert isinstance(ck, tgst.GateSetTomographyCheckpoint)
    assert ck.last_completed_iter == 1 and len(ck.mdl_list) == 2
    for tm, jm in zip(ck.mdl_list, jck.mdl_list):
        assert isinstance(tm, ExplicitOpModel)
        assert np.array_equal(tm.to_vector(), jm.to_vector())
    assert [c.str for c in ck.last_completed_circuit_list] == \
        [c.str for c in jck.last_completed_circuit_list]
    res = tgst.GateSetTomography(gaugeopt_suite=None, verbosity=0, device="cpu").run(
        runs['tdata'], checkpoint=ck, checkpoint_path=str(runs['ckdir'] / 'resumed'))
    est = res.estimates[NAME]
    assert len(est.parameters['raw_objective_values']) == 1      # the last list only
    assert sorted(f for f in os.listdir(runs['ckdir']) if f.startswith('resumed')) == \
        ['resumed_iteration_2.json']
    jfinal = runs['jres'].estimates[NAME].parameters['final_objfn_value']
    assert np.isclose(est.parameters['final_objfn_value'], jfinal, rtol=1e-3)
    assert list(est.models.keys()) == ['target', 'seed', 'iteration 0 estimate',
                                       'iteration 1 estimate', 'iteration 2 estimate',
                                       'final iteration estimate']


def test_port_checkpoint_round_trip_and_full_resume(runs):
    """The port's own checkpoints: one file per list, the last reads back
    to the final model exactly, and a run resumed from it fits nothing and
    reports the stored objective value."""
    files = sorted(f for f in os.listdir(runs['ckdir']) if f.startswith('port'))
    assert files == ['port_iteration_%d.json' % i for i in range(3)]
    ck = tgst.GateSetTomographyCheckpoint.read(str(runs['ckdir'] / files[-1]))
    est = runs['tres'].estimates[NAME]
    assert np.array_equal(ck.mdl_list[-1].to_vector(),
                          est.models['final iteration estimate'].to_vector())
    assert ck.final_objfn == est.parameters['final_objfn_value']
    again = tgst.GateSetTomographyCheckpoint.loads(ck.dumps())
    assert again.last_completed_iter == 2 and len(again.mdl_list) == 3
    res = tgst.GateSetTomography(gaugeopt_suite=None, verbosity=0, device="cpu").run(
        runs['tdata'], checkpoint=ck, checkpoint_path=str(runs['ckdir'] / 'full_resume'))
    est2 = res.estimates[NAME]
    assert est2.parameters['raw_objective_values'] == []
    assert est2.parameters['final_objfn_value'] == ck.final_objfn
    assert est2.misfit_sigma() == est.misfit_sigma()
    ck.final_objfn = None      # an older checkpoint: the value is computed anew
    res = tgst.GateSetTomography(gaugeopt_suite=None, verbosity=0, device="cpu").run(
        runs['tdata'], checkpoint=ck, checkpoint_path=str(runs['ckdir'] / 'full_resume'))
    assert np.isclose(res.estimates[NAME].parameters['final_objfn_value'],
                      est.parameters['final_objfn_value'], rtol=1e-12)
    with pytest.raises(TypeError, match="GateSetTomographyCheckpoint"):
        tgst.GateSetTomography(verbosity=0, device="cpu").run(
            runs['tdata'], checkpoint=object(), checkpoint_path=str(runs['ckdir'] / 'x'))


def test_default_checkpoint_directory(runs, tmp_path, monkeypatch):
    """Checkpoints are on by default and go under gst_checkpoints/ in the
    working directory; disable_checkpointing writes nothing."""
    monkeypatch.chdir(tmp_path)
    short = TProtocolData(tgst.GateSetTomographyDesign(
        runs['tt'], runs['tdata'].edesign.circuit_lists[:1]), runs['tdata'].dataset)
    proto = tgst.GateSetTomography(gaugeopt_suite=None, verbosity=0, device="cpu")
    proto.run(short, disable_checkpointing=True)
    assert os.listdir(tmp_path) == []
    proto.run(short)
    assert os.listdir(tmp_path / 'gst_checkpoints') == ['GateSetTomography_iteration_0.json']


# -- serialization --------------------------------------------------------------------

@pytest.mark.parametrize("gate_type", ['full', 'full TP'])
def test_model_serialization_round_trip_and_from_jax(gate_type):
    """A port model through its own state and through JSON; and the JAX
    package's state of the same model, read by the port: the same vector,
    member types and labels."""
    jm = jmp.target_model(gate_type).depolarize(op_noise=0.04, spam_noise=0.03)
    tm = tmp.target_model(gate_type).depolarize(op_noise=0.04, spam_noise=0.03)
    state = tm.to_nice_serialization()
    assert state['module'] == 'pygsti_tpu_torch.models.explicitmodel'
    for back in (NicelySerializable.from_nice_serialization(state),
                 ExplicitOpModel.loads(tm.dumps()),
                 ExplicitOpModel.from_nice_serialization(jm.to_nice_serialization())):
        assert isinstance(back, ExplicitOpModel)
        assert np.array_equal(back.to_vector(), tm.to_vector())
        assert (back.dim, back.basis.name, back.default_gate_type) == (4, 'pp', gate_type)
        for kind in ('preps', 'povms', 'operations'):
            mine, theirs = getattr(back, kind), getattr(tm, kind)
            assert list(mine.keys()) == list(theirs.keys())
            assert [type(o) for o in mine.values()] == [type(o) for o in theirs.values()]


def test_static_members_serialize(tmp_path):
    from pygsti_tpu_torch.modelmembers.operations import StaticArbitraryOp, StaticStandardOp
    from pygsti_tpu_torch.modelmembers.states import StaticState
    op = StaticStandardOp('Gxpi2')
    back = NicelySerializable.from_nice_serialization(op.to_nice_serialization())
    assert type(back) is StaticArbitraryOp and np.array_equal(back.dense(), op.dense())
    st = StaticState([0.7, 0, 0, 0.7])
    st.write(str(tmp_path / 'state.json'))
    assert np.array_equal(StaticState.read(str(tmp_path / 'state.json')).dense(), st.dense())


def test_foreign_module_is_refused():
    """A state names the module to load: only the port's own are loaded,
    and the JAX package's names are rewritten, never imported."""
    with pytest.raises(ValueError, match="not a module of pygsti_tpu_torch"):
        NicelySerializable.from_nice_serialization({'module': 'os', 'class': 'system'})
    with pytest.raises(NotImplementedError):
        NicelySerializable.from_nice_serialization(
            {'module': 'pygsti_tpu.baseobjs.nicelyserializable', 'class': 'NicelySerializable'})


def test_design_serialization(runs):
    design = tgst.StandardGSTDesign(runs['tt'], tmp.prep_fiducials(), tmp.meas_fiducials(),
                                    tmp.germs(), [1, 2])
    jdesign = jgst.StandardGSTDesign(runs['jt'], jmp.prep_fiducials(), jmp.meas_fiducials(),
                                     jmp.germs(), [1, 2])
    assert [[c.str for c in cl] for cl in design.circuit_lists] == \
        [[c.str for c in cl] for cl in jdesign.circuit_lists]
    assert [c.str for c in design.all_circuits_needing_data] == \
        [c.str for c in jdesign.all_circuits_needing_data]
    for src in (design.to_nice_serialization(), jdesign.to_nice_serialization()):
        back = NicelySerializable.from_nice_serialization(json.loads(json.dumps(
            src, default=lambda a: a.tolist())))
        assert isinstance(back, tgst.StandardGSTDesign) and back.nested
        assert [len(cl) for cl in back.circuit_lists] == [len(cl) for cl in design.circuit_lists]
        assert np.allclose(back.target_model.to_vector(), runs['tt'].to_vector())
    plain = tgst.GateSetTomographyDesign(runs['tt'], design.circuit_lists, nested=True)
    back = NicelySerializable.from_nice_serialization(plain.to_nice_serialization())
    assert type(back) is tgst.GateSetTomographyDesign
    lists = CircuitListsDesign.from_nice_serialization(
        CircuitListsDesign(design.circuit_lists).to_nice_serialization())
    assert len(lists.all_circuits_needing_data) == len(design.circuit_lists[-1])
    tree = ExperimentDesign(children={'a': lists, 'b': plain})
    assert tree.keys() == ['a', 'b'] and 'a' in tree and tree['b'] is plain
    assert len(tree.all_circuits_needing_data) == len(design.circuit_lists[-1])
    data = TProtocolData(tree, runs['tdata'].dataset)
    assert [k for k, _ in data.items()] == ['a', 'b'] and data['a'].dataset is data.dataset
    assert not data.is_multipass() and data.passes == {None: data}


def test_results_serialization(runs):
    state = runs['tres'].to_nice_serialization()
    jstate = runs['jres'].to_nice_serialization()
    assert state['protocol_name'] == jstate['protocol_name'] == NAME
    assert sorted(state['estimates'][NAME]['models']) == sorted(jstate['estimates'][NAME]['models'])
    assert state['estimates'][NAME]['goparameters_keys'] == ['stdgaugeopt']
    assert str(runs['tres']) == str(runs['jres'])


# -- the pieces ---------------------------------------------------------------------

@pytest.mark.parametrize("gate_type", ['full', 'full TP'])
def test_gaugeopt_suite_dictionary(gate_type):
    """'stdgaugeopt' resolves to the JAX package's stages: the same groups,
    weights and penalty, in the same order."""
    jd = jgst.GSTGaugeOptSuite.cast('stdgaugeopt').to_dictionary(jmp.target_model(gate_type))
    td = tgst.GSTGaugeOptSuite.cast('stdgaugeopt').to_dictionary(tmp.target_model(gate_type))
    assert list(td) == list(jd) == ['stdgaugeopt']
    jstages, tstages = jd['stdgaugeopt']['stages'], td['stdgaugeopt']['stages']
    assert len(tstages) == len(jstages) == 3
    for js, ts in zip(jstages, tstages):
        assert sorted(ts) == sorted(js)
        assert ts['item_weights'] == js['item_weights']
        assert ts.get('spam_penalty_factor') == js.get('spam_penalty_factor')
        if 'gauge_group' in js:
            assert (ts['gauge_group'].name, ts['gauge_group'].num_params) == \
                (js['gauge_group'].name, js['gauge_group'].num_params)


def test_gaugeopt_suite_casts_and_names():
    suite = tgst.GSTGaugeOptSuite
    assert suite.cast(None).is_empty() and suite.cast(None).to_dictionary(None) == {}
    model = tmp.target_model('full')
    names = ('TPpenalty', 'varySpam', 'unreliable2Q', 'none')
    jd = jgst.GSTGaugeOptSuite.cast(names).to_dictionary(jmp.target_model('full'))
    assert suite.cast(names).to_dictionary(model) == jd
    assert suite.cast({'mine': {'item_weights': {'gates': 1}}}).to_dictionary(model) == \
        {'mine': {'item_weights': {'gates': 1}}}
    assert suite.cast(suite.cast('stdgaugeopt')).gaugeopt_suite_names == ('stdgaugeopt',)
    with pytest.raises(ValueError, match="Unknown gauge opt suite"):
        suite.cast('nope').to_dictionary(model)
    with pytest.raises(ValueError, match="Cannot cast"):
        suite.cast(3)


def test_objfn_builders_and_options():
    for kwargs, shape in (({}, (['chi2'], ['logl'])),
                          ({'objective': 'chi2'}, (['chi2'], [])),
                          ({'always_perform_mle': True}, (['chi2', 'logl'], [])),
                          ({'always_perform_mle': True, 'only_perform_mle': True},
                           (['logl'], []))):
        b = tgst.GSTObjFnBuilders.cast(kwargs or None)
        jb = jgst.GSTObjFnBuilders.cast(kwargs or None)
        assert ([x.name for x in b.iteration_builders], [x.name for x in b.final_builders]) \
            == shape == ([x.name for x in jb.iteration_builders],
                         [x.name for x in jb.final_builders])
    assert tgst.GSTObjFnBuilders.cast((['chi2'], ['logl'])).final_builders == ['logl']
    fw, jfw = (m.GSTObjFnBuilders.create_from(freq_weighted_chi2=True) for m in (tgst, jgst))
    assert [x.name for x in fw.iteration_builders] == [x.name for x in jfw.iteration_builders] \
        == ['fwchi2']
    with pytest.raises(ValueError, match="Invalid objective"):
        tgst.GSTObjFnBuilders.create_from('tvd')
    opts = tgst.GSTBadFitOptions.cast({'threshold': 3.0, 'actions': ['wildcard']})
    assert (opts.threshold, opts.actions) == (3.0, ('wildcard',))
    assert tgst.GSTBadFitOptions.cast(None).actions == ()
    assert (tgst.GSTDesign, tgst.GST, tgst.LGST) == (
        tgst.GateSetTomographyDesign, tgst.GateSetTomography, tgst.LinearGateSetTomography)


def test_badfit_actions_raise_until_ported(runs):
    """With the default empty actions a bad fit does nothing, as in the JAX
    package; an action on a bad fit raises."""
    est = Estimate(runs['tres'], {'final iteration estimate': runs['tt']},
                   {'final_objfn_value': 5000.0, 'final_dof': 100})
    runs['tres'].add_estimate(est, 'bad')
    try:
        tgst._add_badfit_estimates(runs['tres'], 'bad', tgst.GSTBadFitOptions())
        with pytest.raises(NotImplementedError, match="wildcard"):
            tgst._add_badfit_estimates(runs['tres'], 'bad',
                                       tgst.GSTBadFitOptions(actions=('wildcard',)))
        est.parameters['final_objfn_value'] = 100.0     # a good fit: nothing to do
        tgst._add_badfit_estimates(runs['tres'], 'bad',
                                   tgst.GSTBadFitOptions(actions=('wildcard',)))
    finally:
        del runs['tres'].estimates['bad']


def test_initial_model_starting_points(runs):
    """User-supplied model, target, and the LGST start on a standard design;
    a design without fiducials falls back to the target only for
    'LGST-if-possible'."""
    init = tgst.GSTInitialModel
    ds = runs['tdata'].dataset
    std = tgst.StandardGSTDesign(runs['tt'], tmp.prep_fiducials(), tmp.meas_fiducials(),
                                 tmp.germs(), [1])
    plain = runs['tdata'].edesign
    mine = runs['tt'].copy()
    assert init.cast(mine).retrieve_model(plain, None, ds) is mine
    assert init.cast(init(model=mine)).starting_point == "User-supplied-Model"
    tgt = init.cast('target').retrieve_model(plain, None, ds)
    assert np.array_equal(tgt.to_vector(), runs['tt'].to_vector()) and tgt is not runs['tt']
    lgst = init.cast(None).retrieve_model(std, None, ds)
    from pygsti_tpu_torch.algorithms.core import run_lgst
    direct = run_lgst(ds, tmp.prep_fiducials(), tmp.meas_fiducials(), runs['tt'])
    assert np.array_equal(lgst.to_vector(), direct.to_vector())
    fallback = init.cast(None).retrieve_model(plain, None, ds)
    assert np.array_equal(fallback.to_vector(), runs['tt'].to_vector())
    with pytest.raises(ValueError, match="no fiducials"):
        init.cast('LGST').retrieve_model(plain, None, ds)
    with pytest.raises(ValueError, match="Invalid starting point"):
        init.cast('nowhere').retrieve_model(plain, None, ds)
    depol = init(target_model=runs['tt'], starting_point='target', depolarize_start=0.1) \
        .retrieve_model(plain, None, ds)
    assert depol.frobeniusdist(runs['tt']) > 0.01


@pytest.mark.parametrize("parameterization", ['full', 'full TP', 'CPTPLND', 'GLND', 'H+S',
                                              'H+s', 'CPTP', 'full unitary', 'static unitary',
                                              'static'])
def test_convert_target(parameterization):
    """Every member re-made in the mode's parameterization: the JAX
    package's member types, parameter count and dense values."""
    jm = jgst._convert_target(jmp.target_model('full TP'), parameterization)
    tm = tgst._convert_target(tmp.target_model('full TP'), parameterization)
    assert tm.num_params == jm.num_params and tm.default_gate_type == parameterization
    assert np.max(np.abs(tm.to_vector() - jm.to_vector()), initial=0) < 1e-13
    for kind in ('preps', 'povms', 'operations'):
        assert [type(o).__name__ for o in getattr(tm, kind).values()] == \
            [type(o).__name__ for o in getattr(jm, kind).values()]


def test_make_members_by_name():
    mx, vec = np.eye(4), np.array([1 / np.sqrt(2), 0, 0, 1 / np.sqrt(2)])
    assert type(tmc._make_op(mx, 'static', 'pp')).__name__ == 'StaticArbitraryOp'
    assert type(tmc._make_op(mx, 'TP', 'pp')).__name__ == 'FullTPOp'
    static = tmc._make_prep(vec, 'static', 'pp', nqubits=1)
    assert type(static).__name__ == 'ComputationalBasisState'
    assert np.allclose(static.dense(), vec) and static.num_params == 0
    with pytest.raises(ValueError, match="requires a qubit state space"):
        tmc._make_prep(vec, 'static', 'pp')
    basis = tmp.target_model('full').basis
    for fn, args, cls, n in ((tmc._make_op, (mx, 'CPTPLND', basis), 'ComposedOp', 12),
                             (tmc._make_prep, (vec, 'H+S', basis, 1), 'ComposedState', 6),
                             (tmc._make_povm, ({}, 'static', basis, 1),
                              'ComputationalBasisPOVM', 0)):
        member = fn(*args)
        assert (type(member).__name__, member.num_params) == (cls, n)
    with pytest.raises(ValueError, match=r"Unknown gate type 'nope'$"):
        tmc._make_op(mx, 'nope', 'pp')


def test_estimate(runs):
    est = runs['tres'].estimates[NAME]
    assert 'stdgaugeopt' in est and est['target'] is runs['tt']
    assert list(est.keys()) == list(est.models.keys())
    with pytest.raises(NotImplementedError, match="confidence regions"):
        est.create_confidence_region_factory()
    scratch = Estimate(None, {'target': runs['tt'],
                              'final iteration estimate': est.models['final iteration estimate']})
    assert scratch.misfit_sigma() is None
    added = scratch.add_gaugeoptimized({'maxiter': 20, 'verbosity': 0}, device="cpu")
    assert scratch.models['go0'] is added and list(scratch.goparameters) == ['go0']
    scratch.add_gaugeoptimized({}, model=runs['tt'], label='given')
    assert scratch.models['given'] is runs['tt']


def test_printer_and_profiler(capsys, tmp_path):
    p = VerbosityPrinter.create_printer(2)
    assert VerbosityPrinter.create_printer(p) is p
    p.log("shown", 2)
    p.log("hidden", 3)
    p.log("indented", 1, indent_offset=1)
    assert capsys.readouterr().out == "shown\n  indented\n"
    VerbosityPrinter(1, filename=str(tmp_path / 'log.txt')).log("to a file")
    assert (tmp_path / 'log.txt').read_text() == "to a file\n"
    prof = Profiler()
    with prof.timing('a'):
        pass
    with prof.timing('a'):
        pass
    prof.add_count('n')
    prof.add_count('n', 2)
    assert prof.counters == {'n': 3} and prof.timers['a'] >= 0
    assert prof.format_times().startswith("  a ")
    with DummyProfiler().timing('a'):
        DummyProfiler().add_count('n')
