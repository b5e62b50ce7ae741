"""Implicit-model members, state spaces, factories, noise specifications and
crosstalk-free models in the port against the JAX package: each new
member's dense form and serialization, StateSpace dims and labels, op
factories, create_crosstalk_free_model (probabilities with parallel layers
and every kind of noise, its equality to create_explicit_model at 2 qubits,
num_params, the options it refuses) and Tv against torch.func.jacfwd."""

import numpy as np
import pytest
import torch

from pygsti_tpu.baseobjs import statespace as jss
from pygsti_tpu.baseobjs.basis import Basis as JBasis
from pygsti_tpu.circuits import Circuit as JCircuit
from pygsti_tpu.modelmembers import operations as jop
from pygsti_tpu.models import modelconstruction as jmc
from pygsti_tpu.processors import QubitProcessorSpec as JSpec

from pygsti_tpu_torch.baseobjs import statespace as tss
from pygsti_tpu_torch.baseobjs.basis import Basis as TBasis
from pygsti_tpu_torch.baseobjs.nicelyserializable import NicelySerializable
from pygsti_tpu_torch.circuits.circuit import Circuit
from pygsti_tpu_torch.forwardsims.forwardsim import SimpleForwardSimulator
from pygsti_tpu_torch.modelmembers import operations as top
from pygsti_tpu_torch.models import modelconstruction as tmc
from pygsti_tpu_torch.processors.processorspec import QubitProcessorSpec as TSpec

GATES = ['Gxpi2', 'Gypi2', 'Gcnot']


def _superop(seed, d):
    """A trace-preserving superoperator near the identity."""
    mx = np.eye(d) + 0.05 * np.random.RandomState(seed).randn(d, d)
    mx[0] = np.eye(d)[0]
    return mx


def _channel(seed, d):
    """A completely positive trace-preserving superoperator: a depolarized
    rotation of 1 or 2 qubits."""
    from pygsti_tpu.tools import optools as jot
    import scipy.linalg
    u_dim = int(round(np.sqrt(d)))
    h = np.random.RandomState(seed).randn(u_dim, u_dim) + 0j
    u = scipy.linalg.expm(-0.3j * (h + h.conj().T))
    s = np.real(jot.unitary_to_superop(u, JBasis.cast('pp', d)))
    return np.diag([1.0] + [0.9] * (d - 1)) @ s


def _member_pairs(kind):
    """(JAX member, port member) of the same construction."""
    if kind == 'repeated':
        mx = _superop(1, 4)
        return jop.RepeatedOp(jop.FullArbitraryOp(mx), 3), \
            top.RepeatedOp(top.FullArbitraryOp(mx), 3)
    if kind == 'embedded':
        mx = _superop(2, 16)
        return jop.EmbeddedOp(jss.QubitSpace(3), (2, 0), jop.FullTPOp(mx)), \
            top.EmbeddedOp(tss.QubitSpace(3), (2, 0), top.FullTPOp(mx))
    if kind == 'embedded-lindblad':
        eg = (jop.build_lindblad_errorgen(JBasis.cast('pp', 4), 'H+s'),
              top.build_lindblad_errorgen(TBasis.cast('pp', 4), 'H+s'))
        return jop.EmbeddedOp(jss.QubitSpace(2), (1,), jop.ExpErrorgenOp(eg[0])), \
            top.EmbeddedOp(tss.QubitSpace(2), (1,), top.ExpErrorgenOp(eg[1]))
    if kind == 'depolarize':
        return jop.DepolarizeOp(16, 0.02), top.DepolarizeOp(16, 0.02)
    if kind == 'depolarize-linear':
        return jop.DepolarizeOp(4, 0.03, 'linear'), top.DepolarizeOp(4, 0.03, 'linear')
    if kind == 'stochastic':
        rates = [0.01, 0.02, 0.005]
        return jop.StochasticNoiseOp(4, 'pp', rates), top.StochasticNoiseOp(4, 'pp', rates)
    if kind == 'stochastic-2q':
        rates = np.linspace(0.001, 0.015, 15)
        return jop.StochasticNoiseOp(16, 'pp', rates), top.StochasticNoiseOp(16, 'pp', rates)
    if kind == 'identity-plus-errorgen':
        return (jop.IdentityPlusErrorgenOp(jop.build_lindblad_errorgen(
            JBasis.cast('pp', 16), 'H+s', max_weight=1)),
            top.IdentityPlusErrorgenOp(top.build_lindblad_errorgen(
                TBasis.cast('pp', 16), 'H+s', max_weight=1)))
    if kind == 'cptr':
        ch = 0.95 * _channel(3, 4)
        return jop.CPTRop(ch, 'pp'), top.CPTRop(ch, 'pp')
    raise ValueError(kind)


KINDS = ['repeated', 'embedded', 'embedded-lindblad', 'depolarize', 'depolarize-linear',
         'stochastic', 'stochastic-2q', 'identity-plus-errorgen', 'cptr']


@pytest.mark.parametrize("kind", KINDS)
def test_member_dense(kind):
    """Each new member's to_dense at seeded parameters equals the JAX
    member's within 1e-13; the parameters start equal."""
    jm, tm = _member_pairs(kind)
    assert tm.num_params == jm.num_params
    assert np.max(np.abs(tm.to_vector() - np.asarray(jm.to_vector())), initial=0) < 1e-13
    theta = np.asarray(jm.to_vector()) + 0.02 * np.random.RandomState(5).randn(jm.num_params)
    jm.from_vector(theta)
    tm.from_vector(theta)
    dense = tm.to_dense(torch.as_tensor(theta)).numpy()
    assert dense.shape == (tm.dim, tm.dim)
    assert np.max(np.abs(dense - np.asarray(jm.to_dense()))) < 1e-13


@pytest.mark.parametrize("kind", KINDS)
def test_member_serialization(kind):
    """Each new member reads back from its serialization with the same
    parameters and dense form."""
    _, tm = _member_pairs(kind)
    tm.from_vector(tm.to_vector() + 0.01 * np.random.RandomState(6).randn(tm.num_params))
    back = NicelySerializable.loads(tm.dumps())
    assert type(back) is type(tm)
    assert np.array_equal(back.to_vector(), tm.to_vector())
    assert np.max(np.abs(back.dense() - tm.dense())) < 1e-15


def test_cptr_reduces_trace_only_past_one():
    """CPTRop scales its Choi matrix down where the trace exceeds 1 only:
    a trace-reducing channel keeps its dense form, a scaled-up one is
    brought back to trace 1."""
    _, tm = _member_pairs('cptr')
    v = torch.as_tensor(tm.to_vector())
    assert abs(float(tm.to_dense(v)[0, 0]) - 0.95) < 1e-9
    assert abs(float(tm.to_dense(2 * v)[0, 0]) - 1.0) < 1e-12


def test_unitary_members():
    """to_unitary of a static unitary op and of an EmbeddedOp of one: the
    embedded unitary's superoperator is the embedded superoperator."""
    from pygsti_tpu_torch.tools.optools import unitary_to_superop
    x = np.array([[1, -1j], [-1j, 1]]) / np.sqrt(2)
    op = top.EmbeddedOp(tss.QubitSpace(2), (1,), top.StaticUnitaryOp(x))
    v = torch.zeros(0, dtype=torch.float64)
    u = op.to_unitary(v).numpy()
    assert np.allclose(u, np.kron(np.eye(2), x), atol=1e-15)
    assert np.max(np.abs(np.real(unitary_to_superop(u, 'pp')) - op.dense())) < 1e-14


@pytest.mark.parametrize("make", [
    lambda m: m.QubitSpace(3), lambda m: m.QubitSpace(('Q0', 'Q1')),
    lambda m: m.QuditSpace(('T0', 'Q1'), (3, 2)), lambda m: m.ExplicitStateSpace(('Q0', 'T1', 'L2')),
    lambda m: m.ExplicitStateSpace([('Q0', 'Q1')]), lambda m: m.StateSpace.cast(2),
    lambda m: m.StateSpace.cast(['Q0', 'Q1', 'Q2']), lambda m: m.default_space_for_dim(16),
    lambda m: m.default_space_for_udim(3), lambda m: m.default_space_for_num_qubits(4)],
    ids=['qubits', 'qubit-labels', 'qudits', 'explicit', 'nested', 'cast-int', 'cast-list',
         'for-dim', 'for-udim', 'for-num-qubits'])
def test_state_space(make):
    """Dims, labels and qubit-ness of each construction equal the JAX
    package's."""
    j, t = make(jss), make(tss)
    assert type(t).__name__ == type(j).__name__
    assert (t.dim, t.udim) == (j.dim, j.udim)
    assert tuple(t.tensor_product_block_labels) == tuple(j.tensor_product_block_labels)
    assert tuple(t.tensor_product_block_dims) == tuple(j.tensor_product_block_dims)
    assert t.is_entirely_qubits == j.is_entirely_qubits
    assert str(t) == str(j) and repr(t) == repr(j)
    assert t == make(tss) and hash(t) == hash(make(tss))


def _zr(args):
    th = float(args[0])
    return np.array([[1, 0], [0, np.exp(1j * th)]])


def test_unitary_factory_in_a_crosstalk_free_model():
    """A gate given as a function of label arguments becomes an op factory:
    Gzr;<angle>:0 in a circuit string, probabilities equal to the JAX
    package's and to the state-vector answer."""
    jm = jmc.create_crosstalk_free_model(JSpec(2, ['Gxpi2', 'Gzr', 'Gcnot'], geometry='line',
                                               nonstd_gate_unitaries={'Gzr': _zr}))
    tm = tmc.create_crosstalk_free_model(TSpec(2, ['Gxpi2', 'Gzr', 'Gcnot'], geometry='line',
                                               nonstd_gate_unitaries={'Gzr': _zr}))
    s = 'Gxpi2:0Gzr;1.5707963267948966:0Gxpi2:0Gcnot:0:1@(0,1)'
    jp, tp = jm.probabilities(JCircuit(s)), tm.probabilities(Circuit(s), device='cpu')
    assert max(abs(jp[o] - tp[o]) for o in jp) < 1e-12
    x = np.array([[1, -1j], [-1j, 1]]) / np.sqrt(2)
    psi = x @ _zr((np.pi / 2,)) @ x @ np.array([1, 0])
    assert abs(tp[('00',)] - abs(psi[0]) ** 2) < 1e-12
    assert tm.num_params == jm.num_params == 0


def test_composed_and_embedded_factories():
    """UnitaryOpFactory, EmbeddingOpFactory, EmbeddedOpFactory and
    ComposedOpFactory make the JAX package's operations."""
    from pygsti_tpu.modelmembers import opfactory as jf
    from pygsti_tpu_torch.modelmembers import opfactory as tf
    jfac, tfac = jf.UnitaryOpFactory(_zr, 2), tf.UnitaryOpFactory(_zr, 2)
    pairs = [(jfac.create_op((0.5,)), tfac.create_op((0.5,))),
             (jf.EmbeddingOpFactory(jss.QubitSpace(2), jfac).create_op((0.5,), sslbls=(1,)),
              tf.EmbeddingOpFactory(tss.QubitSpace(2), tfac).create_op((0.5,), sslbls=(1,))),
             (jf.EmbeddedOpFactory(jss.QubitSpace(2), (0,), jfac).create_op((0.3,)),
              tf.EmbeddedOpFactory(tss.QubitSpace(2), (0,), tfac).create_op((0.3,))),
             (jf.ComposedOpFactory([jfac, jop.StaticArbitraryOp(np.eye(4))]).create_op((0.5,)),
              tf.ComposedOpFactory([tfac, top.StaticArbitraryOp(np.eye(4))]).create_op((0.5,)))]
    for j, t in pairs:
        assert np.max(np.abs(t.dense() - np.asarray(j.to_dense()))) < 1e-14
    assert pairs[1][1].dense().shape == (16, 16)
    with pytest.raises(ValueError):
        tf.EmbeddingOpFactory(tss.QubitSpace(2), tfac).create_op((0.5,))


NOISE = {
    'none': {},
    'depolarize': dict(depolarization_strengths={'Gxpi2': 0.02, 'Gcnot': 0.05}),
    'stochastic': dict(stochastic_error_probs={'Gypi2': [0.01, 0.0, 0.02],
                                               'Gcnot': list(np.linspace(0, 0.01, 15))}),
    'lindblad': dict(lindblad_error_coeffs={'Gxpi2': {('H', 'X'): 0.05, ('S', 'Y'): 0.01},
                                            'Gcnot': {('H', 'ZZ'): 0.02}}),
    'all': dict(depolarization_strengths={'Gxpi2': 0.01},
                stochastic_error_probs={'Gxpi2': [0.01, 0.0, 0.0]},
                lindblad_error_coeffs={'Gxpi2': {('H', 'Z'): 0.03},
                                       'rho0': {('H', 'XII'): 0.02},
                                       'Mdefault': {('S', 'IIZ'): 0.01}}),
    'full TP ideals': dict(ideal_gate_type='full TP',
                           depolarization_strengths={'Gypi2': 0.03}),
}
CIRCUITS_3Q = ['Gxpi2:0Gcnot:0:1Gypi2:2@(0,1,2)', 'Gcnot:1:2Gcnot:0:1@(0,1,2)',
               '[Gxpi2:0Gypi2:1]Gcnot:1:2@(0,1,2)', '[Gxpi2:0Gxpi2:2][Gxpi2:0Gxpi2:2]@(0,1,2)',
               'Gxpi2:1Gxpi2:1Gcnot:1:2[Gypi2:0Gxpi2:1Gypi2:2]@(0,1,2)']


@pytest.fixture(scope='module', params=sorted(NOISE))
def xfree(request):
    kw = NOISE[request.param]
    jm = jmc.create_crosstalk_free_model(JSpec(3, GATES, geometry='line'), **kw)
    tm = tmc.create_crosstalk_free_model(TSpec(3, GATES, geometry='line'), **kw)
    return request.param, jm, tm


def test_crosstalk_free_probabilities(xfree):
    """Probabilities of 3-qubit circuits with parallel layers, each kind of
    noise: within 1e-12 of the JAX package's, on the same op stack."""
    _, jm, tm = xfree
    jp = jm.sim.bulk_probs([JCircuit(s) for s in CIRCUITS_3Q])
    tp = tm.bulk_probabilities([Circuit(s) for s in CIRCUITS_3Q], device='cpu')
    assert [str(k) for k in tm.op_keys] == [str(k) for k in jm.op_keys]
    for s in CIRCUITS_3Q:
        assert max(abs(jp[JCircuit(s)][o] - tp[Circuit(s)][o]) for o in jp[JCircuit(s)]) < 1e-12


def test_crosstalk_free_num_params_and_vector(xfree):
    """num_params and the parameter vector equal the JAX package's."""
    _, jm, tm = xfree
    assert tm.num_params == jm.num_params
    assert np.max(np.abs(tm.to_vector() - np.asarray(jm.to_vector())), initial=0) < 1e-14


def test_crosstalk_free_tv_against_jacfwd(xfree):
    """Tv of the crosstalk-free model (one leaf per gate name, used twice in
    a parallel layer) against torch.func.jacfwd: 1e-12."""
    name, _, tm = xfree
    if tm.num_params == 0:
        assert tm.flat_tensors_jacobian_fn()(torch.zeros(0, dtype=torch.float64)).shape[1] == 0
        return
    SimpleForwardSimulator(tm, 'cpu').create_layout([Circuit(s) for s in CIRCUITS_3Q])
    theta = tm.to_vector() + 0.01 * np.random.RandomState(3).randn(tm.num_params)
    v = torch.as_tensor(theta)
    Tv = tm.flat_tensors_jacobian_fn()(v)
    full = torch.func.jacfwd(tm.flat_tensors_fn())(v)
    assert float((Tv - full).abs().max()) < 1e-12


def test_noise_is_local():
    """Depolarizing Gxpi2 leaves the other qubits' outcomes untouched."""
    tm = tmc.create_crosstalk_free_model(TSpec(3, GATES, geometry='line'),
                                         depolarization_strengths={'Gxpi2': 0.1})
    p = tm.probabilities(Circuit('Gxpi2:0Gxpi2:0@(0,1,2)'), device='cpu')
    assert p[('100',)] < 0.95
    assert abs(p[('001',)] + p[('010',)] + p[('011',)]) < 1e-12


def test_crosstalk_free_equals_explicit_at_two_qubits():
    """With no noise the 2-qubit crosstalk-free model and
    create_explicit_model give the same probabilities, in both packages."""
    circuits = ['Gxpi2:0Gcnot:0:1@(0,1)', '[Gxpi2:0Gypi2:1]@(0,1)',
                'Gypi2:1Gcnot:0:1Gxpi2:0@(0,1)']
    impl = tmc.create_crosstalk_free_model(TSpec(2, GATES, geometry='line'))
    expl = tmc.create_explicit_model(TSpec(2, GATES, geometry='line'), ideal_gate_type='static')
    jexpl = jmc.create_explicit_model(JSpec(2, GATES, geometry='line'), ideal_gate_type='static')
    for s in circuits:
        pi = impl.probabilities(Circuit(s), device='cpu')
        pe = expl.probabilities(Circuit(s), device='cpu')
        pj = jexpl.probabilities(JCircuit(s))
        assert max(abs(pi[o] - pe[o]) for o in pi) < 1e-12
        assert max(abs(pj[o] - pe[o]) for o in pj) < 1e-12


@pytest.mark.parametrize("gate_type", ['static', 'full TP', 'static unitary', 'H+s'])
def test_create_explicit_model(gate_type):
    """create_explicit_model of a 2-qubit processor: the same operation
    labels, parameter count and dense members as the JAX package's."""
    jm = jmc.create_explicit_model(JSpec(2, GATES, geometry='line'), ideal_gate_type=gate_type)
    tm = tmc.create_explicit_model(TSpec(2, GATES, geometry='line'), ideal_gate_type=gate_type)
    assert [str(k) for k in tm.operations] == [str(k) for k in jm.operations]
    assert tm.num_params == jm.num_params
    for (_, t), (_, j) in zip(tm.operations.items(), jm.operations.items()):
        assert np.max(np.abs(t.dense() - np.asarray(j.to_dense()))) < 1e-13
    for d in ('preps', 'povms'):
        for (_, t), (_, j) in zip(getattr(tm, d).items(), getattr(jm, d).items()):
            assert np.max(np.abs(t.dense() - np.asarray(j.to_dense()))) < 1e-14


@pytest.mark.parametrize("kw", [
    dict(depolarization_parameterization='lindblad'), dict(stochastic_parameterization='x'),
    dict(lindblad_parameterization='CPTP'), dict(evotype='statevec'),
    dict(independent_gates=True), dict(ideal_gate_type='CPTP'),
    dict(ideal_spam_type='full'), dict(implicit_idle_mode='add_global')],
    ids=lambda kw: list(kw)[0])
def test_crosstalk_free_refusals(kw):
    """The options the JAX package refuses raise NotImplementedError with
    the same words in the port."""
    with pytest.raises(NotImplementedError) as je:
        jmc.create_crosstalk_free_model(JSpec(2, GATES, geometry='line'), **kw)
    with pytest.raises(NotImplementedError) as te:
        tmc.create_crosstalk_free_model(TSpec(2, GATES, geometry='line'), **kw)
    assert str(te.value) == str(je.value)


def test_noise_specification_objects():
    """OpModelPerOpNoise and ComposedOpModelNoise give the JAX package's
    construction dicts, and a model built from them its probabilities."""
    from pygsti_tpu.models import modelnoise as jmn
    from pygsti_tpu_torch.models import modelnoise as tmn

    def spec(mn):
        return mn.OpModelPerOpNoise({'Gxpi2': mn.DepolarizationNoise(0.02),
                                     'Gypi2': mn.LindbladNoise({('H', 'Z'): 0.01}),
                                     'Gcnot': mn.StochasticNoise([0.001] * 15)})
    jd, td = spec(jmn).to_construction_dicts(), spec(tmn).to_construction_dicts()
    assert td == jd
    comp = [mn.ComposedOpModelNoise([spec(mn), mn.OpModelPerOpNoise(
        {'Gypi2': mn.DepolarizationNoise(0.01)})]).to_construction_dicts() for mn in (jmn, tmn)]
    assert comp[0] == comp[1]
    jm = jmc.create_crosstalk_free_model(JSpec(2, GATES, geometry='line'), *(), **dict(zip(
        ('depolarization_strengths', 'stochastic_error_probs', 'lindblad_error_coeffs'), jd)))
    tm = tmc.create_crosstalk_free_model(TSpec(2, GATES, geometry='line'), **dict(zip(
        ('depolarization_strengths', 'stochastic_error_probs', 'lindblad_error_coeffs'), td)))
    s = 'Gxpi2:0Gypi2:1Gcnot:0:1@(0,1)'
    jp, tp = jm.probabilities(JCircuit(s)), tm.probabilities(Circuit(s), device='cpu')
    assert max(abs(jp[o] - tp[o]) for o in jp) < 1e-12


@pytest.mark.parametrize("stencil,targets", [
    (('@0', '@1'), (2, 3)), (('@0+left',), (1,)), (('@0+right',), (2,)), ((0, '@0'), (3,))])
def test_stencil_labels(stencil, targets):
    """StencilLabelTuple resolves relative labels as the JAX package does,
    and StencilLabelRadiusCombos gives the same combinations."""
    from pygsti_tpu.baseobjs.qubitgraph import QubitGraph as JGraph
    from pygsti_tpu.models import stencillabel as jsl
    from pygsti_tpu_torch.baseobjs.qubitgraph import QubitGraph as TGraph
    from pygsti_tpu_torch.models import stencillabel as tsl
    jg, tg = JGraph.common_graph(4, 'line'), TGraph.common_graph(4, 'line')
    assert tsl.StencilLabelTuple(stencil).compute_absolute_sslbls(tg, targets) == \
        jsl.StencilLabelTuple(stencil).compute_absolute_sslbls(jg, targets)
    assert tsl.StencilLabelRadiusCombos(('@0',), 1, 2).compute_absolute_sslbls(tg, targets) == \
        jsl.StencilLabelRadiusCombos(('@0',), 1, 2).compute_absolute_sslbls(jg, targets)
    assert tg.radius(list(targets), 1) == jg.radius(list(targets), 1)
