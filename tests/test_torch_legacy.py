"""The port's legacy model packs, expression constructors, bare-name
aliasing in the layout and processor specs against the JAX package's."""

import importlib

import numpy as np
import pytest

from pygsti_tpu.models import modelconstruction as jmc

from pygsti_tpu_torch.models import modelconstruction as tmc
from pygsti_tpu_torch.forwardsims.forwardsim import SimpleForwardSimulator

LEGACY = ['std1Q_XY', 'std1Q_XYI', 'std1Q_XYZI', 'std1Q_XZ', 'std1Q_ZN', 'std1Q_pi4_pi2_XZ',
          'std2Q_XY', 'std2Q_XXII', 'std2Q_XXYYII', 'std2Q_XYI', 'std2Q_XYI1', 'std2Q_XYI2',
          'std2Q_XYCNOT', 'std2Q_XYICNOT', 'std2Q_XYCPHASE', 'std2Q_XYICPHASE',
          'std2Q_XYZICNOT', 'std1Q_Cliffords']
SMQ = ['smq1Q_XY', 'smq1Q_XYI', 'smq1Q_XYZI', 'smq1Q_XZ', 'smq1Q_ZN', 'smq1Q_pi4_pi2_XZ',
       'smq2Q_XXII', 'smq2Q_XXII_condensed', 'smq2Q_XXYYII', 'smq2Q_XXYYII_condensed',
       'smq2Q_XY', 'smq2Q_XYCNOT', 'smq2Q_XYCPHASE', 'smq2Q_XYI', 'smq2Q_XYI1', 'smq2Q_XYI2',
       'smq2Q_XYICNOT', 'smq2Q_XYICPHASE', 'smq2Q_XYXX', 'smq2Q_XYZICNOT', 'smq2Q_XYZZ']


def legacy(name):
    return (importlib.import_module('pygsti_tpu.modelpacks.legacy.' + name),
            importlib.import_module('pygsti_tpu_torch.modelpacks.legacy.' + name))


def same_members(jm, tm, tol=1e-12):
    """Keys and dense values of every operation, prep and effect."""
    assert [str(k) for k in tm.operations] == [str(k) for k in jm.operations]
    for (jk, jo), (tk, to) in zip(jm.operations.items(), tm.operations.items()):
        assert np.max(np.abs(np.asarray(jo.to_dense()) - to.dense())) < tol, tk
    for jp, tp in zip(jm.preps.values(), tm.preps.values()):
        assert np.max(np.abs(np.asarray(jp.to_dense()).ravel() - tp.dense())) < tol
    for jp, tp in zip(jm.povms.values(), tm.povms.values()):
        assert [str(k) for k, _ in jp.items()] == tp.outcome_labels
        assert np.max(np.abs(np.array([np.asarray(v).ravel() for _, v in jp.items()])
                             - tp.dense())) < tol
    assert tm.num_params == jm.num_params


@pytest.mark.parametrize("name", LEGACY)
def test_legacy_pack(name):
    """The target model's dense members within 1e-12 of the JAX package's,
    of types 'full' and 'full TP', and every circuit list equal as
    strings."""
    jp, tp = legacy(name)
    for ptype in ('full', 'full TP'):
        same_members(jp.target_model(ptype), tp.target_model(ptype))
    assert tp.description == jp.description and tp.gates == jp.gates
    if name == 'std1Q_Cliffords':
        assert tp.clifford_compilation == jp.clifford_compilation
        return
    for attr in ('prepStrs', 'effectStrs', 'germs', 'germs_lite'):
        assert [c.str for c in getattr(tp, attr)] == [c.str for c in getattr(jp, attr)], attr
        assert all(c.line_labels == ('*',) for c in getattr(tp, attr))
    assert tp.fiducials is tp.prepStrs and tp.meas_fiducials is tp.effectStrs
    assert getattr(tp, 'clifford_compilation', None) == getattr(jp, 'clifford_compilation', None)


@pytest.mark.parametrize("name", ['std1Q_XYI', 'std2Q_XYICNOT', 'std2Q_XYI1', 'std1Q_Cliffords'])
def test_legacy_processor_spec(name):
    """A legacy pack's processor spec: the gates of its static target as
    unitaries, on the state space's qubits."""
    jp, tp = legacy(name)
    js, ts = jp.processor_spec(), tp.processor_spec()
    assert ts.gate_names == js.gate_names and ts.qubit_labels == js.qubit_labels
    assert [str(l) for l in ts.primitive_op_labels] == [str(l) for l in js.primitive_op_labels]
    for g in js.gate_names:
        assert np.max(np.abs(ts.gate_unitaries[g] - js.gate_unitaries[g])) < 1e-12


EXPRESSIONS = ['I(Q0)', 'X(pi/2,Q0)', 'Y(pi/4,Q1)', 'Z(pi/2,Q1)', 'X(0.3,Q0):Y(1.1,Q1)',
               'N(pi/2, sqrt(3)/2, 0, -0.5, Q1)', 'CX(pi,Q0,Q1)', 'CZ(pi/2,Q1,Q0)',
               'CNOT(Q0,Q1)', 'CNOT(Q1,Q0)', 'CPHASE(Q0,Q1)', 'I']


@pytest.mark.parametrize("expr", EXPRESSIONS)
def test_create_operation(expr):
    """create_operation on two qubits, 'pp' and 'std' bases, within 1e-12."""
    for basis in ('pp', 'std'):
        j = np.asarray(jmc.create_operation(expr, [('Q0', 'Q1')], basis))
        t = tmc.create_operation(expr, [('Q0', 'Q1')], basis)
        assert np.max(np.abs(j - t)) < 1e-12, basis


def test_expression_model_vec_and_alias_model():
    """create_explicit_model_from_expressions of each gate type, the
    identity vector, the spam vectors and an alias model."""
    from pygsti_tpu.baseobjs.basis import Basis as JBasis
    from pygsti_tpu.circuits.circuit import Circuit as JC
    from pygsti_tpu_torch.baseobjs.basis import Basis as TBasis
    from pygsti_tpu_torch.circuits.circuit import Circuit as TC
    args = (['Q0'], ['Gi', 'Gx', 'Gy'], ['I(Q0)', 'X(pi/2,Q0)', 'Y(pi/2,Q0)'])
    for gate_type in ('full', 'full TP', 'static'):
        same_members(jmc.create_explicit_model_from_expressions(*args, gate_type=gate_type),
                     tmc.create_explicit_model_from_expressions(*args, gate_type=gate_type))
    for b in ('pp', 'std', 'gm'):
        assert np.max(np.abs(jmc.create_identity_vec(JBasis.cast(b, 4))
                             - tmc.create_identity_vec(TBasis(b, 4)))) < 1e-15
        assert np.max(np.abs(np.asarray(jmc.create_spam_vector('1', ['Q0'], JBasis.cast(b, 4)))
                             - tmc.create_spam_vector('1', ['Q0'], TBasis(b, 4)))) < 1e-15
    jm = jmc.create_explicit_model_from_expressions(*args)
    tm = tmc.create_explicit_model_from_expressions(*args)
    ja = jmc.create_explicit_alias_model(jm, {'Gh': JC(['Gx', 'Gy', 'Gx']), 'Gi2': JC(['Gi'])})
    ta = tmc.create_explicit_alias_model(tm, {'Gh': TC(['Gx', 'Gy', 'Gx']), 'Gi2': TC(['Gi'])})
    same_members(ja, ta)


def test_clifford_pack_closure_and_tables():
    """The 24 Clifford superoperators form a group, and the legacy Clifford
    tables have the JAX package's sizes and name only the pack's gates."""
    cl = importlib.import_module('pygsti_tpu_torch.modelpacks.legacy.std1Q_Cliffords')
    mats = [op.dense().round(8) for op in cl.target_model().operations.values()]
    keys = {tuple(mx.ravel().round(4)) for mx in mats}
    assert len(mats) == 24 and len(keys) == 24
    for a in mats[::5]:
        for b in mats[::7]:
            assert tuple((a @ b).round(4).ravel()) in keys
    sizes = {'std1Q_XYI': 24, 'std1Q_XY': 24, 'std2Q_XYI': 47, 'std2Q_XXYYII': 576,
             'std1Q_Cliffords': 24}
    for name, n in sizes.items():
        jp, tp = legacy(name)
        assert len(tp.clifford_compilation) == n
        assert tp.clifford_compilation == jp.clifford_compilation
        opnames = {str(k) for k in tp.target_model().operations}
        assert all(set(w) <= opnames for w in tp.clifford_compilation.values())


@pytest.mark.parametrize("name", ['std1Q_XYI', 'std2Q_XYICNOT', 'stdQT_XYIMS'])
def test_bare_name_probabilities(name):
    """Legacy circuits of bare gate names through the layout, against the
    JAX package's within 1e-10; for the qutrit, whose gates are keyed
    ('Gx', 'T0'), the layout's aliasing leaves op_keys as they are."""
    jp, tp = legacy(name)
    jm, tm = jp.target_model('full TP'), tp.target_model('full TP')
    rng = np.random.RandomState(4)
    theta = jm.to_vector() + 0.01 * rng.randn(jm.num_params)
    jm.from_vector(theta)
    tm.from_vector(theta)
    circuits = list(tp.germs) + [f + g + m for f in tp.prepStrs[:3] for g in tp.germs[:6]
                                 for m in tp.effectStrs[:3]]
    jcircuits = list(jp.germs) + [f + g + m for f in jp.prepStrs[:3] for g in jp.germs[:6]
                                  for m in jp.effectStrs[:3]]
    sim = SimpleForwardSimulator(tm, 'cpu')
    layout = sim.create_layout(circuits)
    assert layout.op_keys == tuple(tm.op_keys)
    p = sim.bulk_fill_probs(layout)
    jprobs = jm.sim.bulk_probs(jcircuits)
    ref = np.concatenate([[jprobs[c][o] for o in layout.outcomes[i]]
                          for i, c in enumerate(jcircuits)])
    assert np.max(np.abs(p - ref)) < 1e-10


def test_qutrit_bare_name_circuit():
    """germs[9] = GxGy of the qutrit pack gives p('1bright') = 0.5 at the
    target."""
    from pygsti_tpu_torch.modelpacks.legacy import stdQT_XYIMS as qt
    assert qt.germs[9].str == 'GxGy'
    p = qt.target_model().probabilities(qt.germs[9], device='cpu')
    assert abs(p[('1bright',)] - 0.5) < 1e-12 and abs(sum(p.values()) - 1) < 1e-12


@pytest.mark.parametrize("name", SMQ)
def test_smq_processor_spec(name):
    """Each smq pack's processor spec: gate names, availability and
    primitive operation labels, equal to the JAX package's."""
    js = importlib.import_module('pygsti_tpu.modelpacks.' + name)._Pack.processor_spec()
    ts = importlib.import_module('pygsti_tpu_torch.modelpacks.' + name)._Pack.processor_spec()
    assert ts.gate_names == js.gate_names and ts.qubit_labels == js.qubit_labels
    assert ts.availability == js.availability
    assert [str(l) for l in ts.primitive_op_labels] == [str(l) for l in js.primitive_op_labels]
    assert ts.qubit_graph.edges() == js.qubit_graph.edges()
    for g in ts.gate_names:
        assert ts.gate_num_qubits(g) == js.gate_num_qubits(g)
        assert ts.resolved_availability(g) == js.resolved_availability(g)


def test_processor_spec_classes():
    """QubitProcessorSpec with given unitaries and 'all-permutations',
    QuditProcessorSpec, the compilation rules, and what stays unported."""
    from pygsti_tpu.processors import processorspec as jps
    from pygsti_tpu_torch.processors import processorspec as tps
    from pygsti_tpu_torch.processors import compilationrules as tcr
    u = np.diag([1, 1j])
    args = (3, ['Gxpi2', 'Gcnot', 'Gu', '{idle}'])
    kw = dict(nonstd_gate_unitaries={'Gu': u}, availability={'Gcnot': 'all-permutations'},
              geometry='ring', qubit_labels=('a', 'b', 'c'))
    js, ts = jps.QubitProcessorSpec(*args, **kw), tps.QubitProcessorSpec(*args, **kw)
    assert [str(l) for l in ts.primitive_op_labels] == [str(l) for l in js.primitive_op_labels]
    assert ts.idle_gate_names == js.idle_gate_names
    jq = jps.QuditProcessorSpec(['T0', 'T1'], [3, 2], ['Gx'], {'Gx': np.eye(6)})
    tq = tps.QuditProcessorSpec(['T0', 'T1'], [3, 2], ['Gx'], {'Gx': np.eye(6)})
    assert (tq.num_qudits, tq.udim, tq.gate_num_qudits('Gx')) == \
        (jq.num_qudits, jq.udim, jq.gate_num_qudits('Gx')) == (2, 6, 2)
    rules = tcr.CliffordCompilationRules.create_standard(ts)
    assert rules.native_1q == ('Gxpi2', 'Gu') and rules.has_cnot
    assert [str(l) for l in rules.word_for_cnot('a', 'b')] == ['Gcnot:a:b']
    with pytest.raises(NotImplementedError):
        ts.compute_clifford_symplectic_reps()
    with pytest.raises(NotImplementedError):
        rules.word_for_1q('H', 'a')
