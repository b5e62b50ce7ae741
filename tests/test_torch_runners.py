"""The port's protocol runners and data simulators of protocols/protocol.py
against the JAX package's: MultiPassProtocol, DefaultRunner, TreeRunner,
SimpleRunner, run_default_protocols, TreeNode, SlurmSettings, and
DataCountsSimulator on the port's simulate_data.  Both packages run the same
deterministic protocol on the same counts, so their result trees are equal;
the two JAX faults of ROADMAP.md section 3 (SimpleRunner swallowing
failures, DataCountsSimulator dropping its options) are held here."""

import numpy as np
import pytest

import pygsti_tpu.protocols as jp
from pygsti_tpu.protocols import protocol as jproto
from pygsti_tpu.protocols.treenode import TreeNode as JTreeNode
from pygsti_tpu.circuits import Circuit as JCircuit
from pygsti_tpu.data.dataset import DataSet as JDataSet
from pygsti_tpu.data.multidataset import MultiDataSet as JMultiDataSet

import pygsti_tpu_torch.protocols as tp
from pygsti_tpu_torch.protocols import protocol as tproto
from pygsti_tpu_torch.protocols.treenode import TreeNode as TTreeNode
from pygsti_tpu_torch.baseobjs.label import Label
from pygsti_tpu_torch.circuits import Circuit
from pygsti_tpu_torch.data.dataset import DataSet
from pygsti_tpu_torch.data.datasetconstruction import simulate_data
from pygsti_tpu_torch.data.multidataset import MultiDataSet
from pygsti_tpu_torch.modelpacks import smq1Q_XYI as tmp

CIRCUITS = ['{}@(0)', 'Gxpi2:0@(0)', 'Gypi2:0@(0)', 'Gxpi2:0Gxpi2:0@(0)',
            'Gxpi2:0Gypi2:0@(0)', 'Gypi2:0Gypi2:0Gypi2:0@(0)']


def _counts(seed):
    """Seeded counts [circuit][outcome] for CIRCUITS, fed to both packages."""
    rng = np.random.RandomState(seed)
    return [dict(zip(('0', '1'), rng.multinomial(100, [p, 1 - p])))
            for p in rng.uniform(0.05, 0.95, len(CIRCUITS))]


def _datasets(seed):
    j, t = JDataSet(), DataSet()
    for c, counts in zip(CIRCUITS, _counts(seed)):
        j.add_count_dict(JCircuit(c), counts)
        t.add_count_dict(Circuit(c), counts)
    return j, t


def _protocol(pkg):
    """A deterministic protocol of `pkg`: per node, each circuit's count of
    '1' over its total, in the design's order."""
    class Fraction(pkg.Protocol):
        def run(self, data, memlimit=None, comm=None):
            res = pkg.ProtocolResults(data, self)
            res.value = [data.dataset[c][('1',)] / data.dataset[c].total
                         for c in data.edesign.all_circuits_needing_data]
            return res
    return Fraction()


def _tree(pkg, circuit_cls):
    """A combined design {'a': first half, 'b': {'c': second half}}."""
    c = [circuit_cls(s) for s in CIRCUITS]
    inner = pkg.CombinedExperimentDesign({'c': pkg.ExperimentDesign(c[3:])})
    return pkg.CombinedExperimentDesign({'a': pkg.ExperimentDesign(c[:3]), 'b': inner})


def _walk(rd):
    """{path: {protocol name: value}} of a ProtocolResultsDir tree."""
    out = {(): {k: v.value for k, v in rd.for_protocol.items()}}
    for k in rd.keys():
        for path, vals in _walk(rd[k]).items():
            out[(k,) + path] = vals
    return out


def test_default_runner_matches_jax():
    jds, tds = _datasets(1)
    j = jproto.DefaultRunner(_protocol(jproto)).run(
        jproto.ProtocolData(_tree(jproto, JCircuit), jds))
    t = tp.DefaultRunner(_protocol(tproto)).run(tproto.ProtocolData(_tree(tproto, Circuit), tds))
    assert _walk(t) == _walk(j)
    assert set(_walk(t)) == {(), ('a',), ('b',), ('b', 'c')}


def test_tree_runner_matches_jax():
    jds, tds = _datasets(2)
    paths = [('a',), ('b', 'c'), ()]
    j = jproto.TreeRunner({p: _protocol(jproto) for p in paths}).run(
        jproto.ProtocolData(_tree(jproto, JCircuit), jds))
    t = tp.TreeRunner({p: _protocol(tproto) for p in paths}).run(
        tproto.ProtocolData(_tree(tproto, Circuit), tds))
    assert {k: v.value for k, v in t.for_protocol.items()} == \
        {k: v.value for k, v in j.for_protocol.items()}
    for p in (('a',), ('b', 'c')):
        assert t[p]['Fraction'].value == j[p]['Fraction'].value
    assert t[('a',)]['Fraction'].value == [tds[Circuit(c)][('1',)] / 100 for c in CIRCUITS[:3]]


def test_simple_runner_matches_jax_and_filters_design_types():
    jds, tds = _datasets(3)
    for edesign_type in ('all', 'plain'):
        jt = 'all' if edesign_type == 'all' else jproto.ExperimentDesign
        tt = 'all' if edesign_type == 'all' else tproto.ExperimentDesign
        j = jproto.SimpleRunner(_protocol(jproto), edesign_type=jt).run(
            jproto.ProtocolData(_tree(jproto, JCircuit), jds))
        t = tp.SimpleRunner(_protocol(tproto), edesign_type=tt).run(
            tproto.ProtocolData(_tree(tproto, Circuit), tds))
        assert _walk(t) == _walk(j)
    # a CombinedExperimentDesign is an ExperimentDesign: every node ran
    assert all(_walk(t).values())
    only_combined = tp.SimpleRunner(_protocol(tproto),
                                    edesign_type=tproto.CombinedExperimentDesign).run(
        tproto.ProtocolData(_tree(tproto, Circuit), tds))
    assert {p for p, v in _walk(only_combined).items() if v} == {(), ('b',)}


def test_simple_runner_raises_a_failure_jax_swallows():
    """ROADMAP.md section 3: the JAX package's SimpleRunner skips every node
    whose run raises; the port's skips only other design types."""
    class Fails(tproto.Protocol):
        def run(self, data, memlimit=None, comm=None):
            raise RuntimeError("fails on %d circuits" % len(data.edesign.all_circuits_needing_data))

    class JFails(jproto.Protocol):
        def run(self, data, memlimit=None, comm=None):
            raise RuntimeError("fails")
    jds, tds = _datasets(4)
    j = jproto.SimpleRunner(JFails()).run(jproto.ProtocolData(_tree(jproto, JCircuit), jds))
    assert not any(_walk(j).values())          # every failure swallowed
    with pytest.raises(RuntimeError, match="fails on 6 circuits"):
        tp.SimpleRunner(Fails()).run(tproto.ProtocolData(_tree(tproto, Circuit), tds))


def test_simple_runner_skips_nodes_without_data():
    t = tp.SimpleRunner(_protocol(tproto)).run(tproto.ProtocolData(_tree(tproto, Circuit)))
    assert not any(_walk(t).values())


def test_multipass_protocol_matches_jax():
    jm, tm = JMultiDataSet(), MultiDataSet()
    for i, name in enumerate(('pass0', 'pass1')):
        jds, tds = _datasets(10 + i)
        jm.add_dataset(name, jds)
        tm.add_dataset(name, tds)
    c = [Circuit(s) for s in CIRCUITS]
    j = jp.MultiPassProtocol(_protocol(jproto)).run(
        jproto.ProtocolData(jproto.ExperimentDesign([JCircuit(s) for s in CIRCUITS]), jm))
    t = tp.MultiPassProtocol(_protocol(tproto)).run(
        tproto.ProtocolData(tproto.ExperimentDesign(c), tm))
    assert t.protocol.name == j.protocol.name == 'MultiPassFraction'
    assert list(t.passes) == list(j.passes) == ['pass0', 'pass1']
    for k in t.passes:
        assert t.passes[k].value == j.passes[k].value
    assert t.to_nice_serialization()['pass_names'] == ['pass0', 'pass1']
    one = tp.MultiPassProtocol(_protocol(tproto)).run(
        tproto.ProtocolData(tproto.ExperimentDesign(c), tm['pass0']))
    assert list(one.passes) == [None] and one.passes[None].value == t.passes['pass0'].value


def test_multipass_modeltest_per_pass():
    """The JAX package's case (tests/test_protocols_misc.py): ModelTest on
    each pass of two datasets of a depolarized model."""
    from pygsti_tpu_torch.circuits.gstcircuits import create_lsgst_circuit_lists
    target = tmp.target_model('full TP')
    lists = create_lsgst_circuit_lists(target, tmp.prep_fiducials(), tmp.meas_fiducials(),
                                       tmp.germs(), [1])
    circuits = list(lists[-1])
    mds = MultiDataSet()
    for i, name in enumerate(('pass0', 'pass1')):
        mds.add_dataset(name, simulate_data(target.depolarize(op_noise=0.02), circuits, 500,
                                            seed=i, device='cpu'))
    res = tp.MultiPassProtocol(tp.ModelTest(target, name='MT', device='cpu')).run(
        tproto.ProtocolData(tp.CircuitListsDesign([circuits]), mds))
    assert set(res.passes) == {'pass0', 'pass1'}
    for r in res.passes.values():
        assert hasattr(r, 'data')


def test_run_default_protocols_matches_jax():
    jds, tds = _datasets(5)
    jd, td = _tree(jproto, JCircuit), _tree(tproto, Circuit)
    jd['b']['c'].default_protocols = {'F': _protocol(jproto)}
    td['b']['c'].default_protocols = {'F': _protocol(tproto)}
    j = jproto.run_default_protocols(jproto.ProtocolData(jd, jds))
    t = tproto.run_default_protocols(tproto.ProtocolData(td, tds))
    assert _walk(t) == _walk(j)
    assert [p for p, v in _walk(t).items() if v] == [('b', 'c')]


def test_treenode_matches_jax():
    def make(base):
        class Node(base):
            def __init__(self, name, children=()):
                self.name, self._kids = name, dict(children)

            def keys(self):
                return list(self._kids)

            def items(self):
                return iter(self._kids.items())

            def __getitem__(self, k):
                return self._kids[k]
        return Node('root', {'x': Node('x', {'y': Node('y')}), 'z': 'leaf'})
    j, t = make(JTreeNode), make(TTreeNode)
    names = [getattr(n, 'name', n) for n in t.iterate_over_nodes()]
    assert names == [getattr(n, 'name', n) for n in j.iterate_over_nodes()] == \
        ['root', 'x', 'y', 'leaf']
    assert ('x' in t) and ('q' not in t) and ('x' in j)
    with pytest.raises(KeyError):
        TTreeNode()['any']


def test_small_classes_match_jax():
    kw = dict(num_nodes=2, num_procs_per_node=4, time_limit='01:00:00', partition='p',
              account='a', extra_sbatch_lines=['#SBATCH --x'])
    assert vars(tp.SlurmSettings(**kw)) == vars(jp.SlurmSettings(**kw))
    for cls in (tproto.ProtocolPostProcessor, tproto.ProtocolRunner, tproto.DataSimulator):
        with pytest.raises(NotImplementedError):
            cls().run(None)
    assert tproto.ProtocolPostProcessor().name == 'ProtocolPostProcessor'
    with pytest.raises(NotImplementedError):
        tproto.CanCreateAllCircuitsDesign()._create_all_circuits_needing_data()
    assert issubclass(tp.FreeformDataSimulator, tproto.DataSimulator)
    assert tp.DataSimulator is tproto.DataSimulator


def test_data_counts_simulator_is_simulate_data():
    model = tmp.target_model('full TP').depolarize(op_noise=0.05)
    design = tproto.ExperimentDesign([Circuit(s) for s in CIRCUITS])
    data = tp.DataCountsSimulator(model, 200, seed=9, device='cpu').run(design)
    ref = simulate_data(model, design.all_circuits_needing_data, 200, seed=9, device='cpu')
    assert data.edesign is design
    assert [(c, dict(data.dataset[c].counts)) for c in data.dataset.keys()] == \
        [(c, dict(ref[c].counts)) for c in ref.keys()]


def test_data_counts_simulator_passes_its_options():
    """ROADMAP.md section 3: the JAX package's simulator accepts alias_dict,
    collision_action, record_zero_counts and times and drops them; the
    port's passes all four to simulate_data."""
    model = tmp.target_model('full TP')
    design = tproto.ExperimentDesign([Circuit('{}@(0)'), Circuit('Gxpi2:0Gxpi2:0@(0)')])
    # record_zero_counts: the idle's '1' never happens
    kept = tp.DataCountsSimulator(model, 100, seed=1, device='cpu').run(design).dataset
    dropped = tp.DataCountsSimulator(model, 100, seed=1, record_zero_counts=False,
                                     device='cpu').run(design).dataset
    assert ('1',) in kept[Circuit('{}@(0)')].counts
    assert ('1',) not in dropped[Circuit('{}@(0)')].counts
    jm = jp.DataCountsSimulator(None, record_zero_counts=False, alias_dict={'a': 1}, times=[0])
    assert not hasattr(jm, 'record_zero_counts') and not hasattr(jm, 'alias_dict')
    # alias_dict: each Gxpi2 simulated as two, so Gxpi2 Gxpi2 becomes X(2 pi)
    alias = {Label('Gxpi2', 0): Circuit([('Gxpi2', 0), ('Gxpi2', 0)], (0,))}
    aliased = tp.DataCountsSimulator(model, 100, sample_error='none', alias_dict=alias,
                                     device='cpu').run(design).dataset
    assert aliased[Circuit('Gxpi2:0Gxpi2:0@(0)')][('0',)] == pytest.approx(100.0, abs=1e-9)
    # times: one draw per timestamp
    timed = tp.DataCountsSimulator(model, 100, seed=2, times=[0.0, 1.0, 2.0],
                                   device='cpu').run(design).dataset
    assert timed.has_timestamps
    assert sorted(set(timed[Circuit('{}@(0)')].time)) == [0.0, 1.0, 2.0]
    with pytest.raises(NotImplementedError):
        tp.DataCountsSimulator(model, 10, collision_action='keepseparate',
                               device='cpu').run(design)
