"""The port's unitary and Lindblad model members against the JAX package's,
on the CPU in float64, inputs from numpy seeds.

Tolerances: a member's dense matrix 1e-12 (both exponentials are accurate
to a few 1e-16; the rest is the same arithmetic in another order); a
member's Jacobian 1e-10; probabilities 1e-10; blocked lsvec / J^T J / J^T f
1e-9 relative to their largest entry; the fit 1e-3 on stage values and
N_sigma, 1e-4 on probabilities (LM stops within its tolerances of the
optimum, not on it).
"""

import functools

import numpy as np
import pytest
import scipy.linalg
import torch

import jax
import jax.numpy as jnp

import pygsti_tpu.modelpacks.smq1Q_XYI as jmp1
import pygsti_tpu.modelpacks.smq2Q_XYICNOT as jmp2
from pygsti_tpu.baseobjs import errorgenlabel as jlbl
from pygsti_tpu.baseobjs.basis import Basis as JBasis
from pygsti_tpu.circuits.gstcircuits import create_lsgst_circuit_lists as j_lists
from pygsti_tpu.data import simulate_data as j_simulate
from pygsti_tpu.modelmembers import operations as jop
from pygsti_tpu.modelmembers import povms as jpv
from pygsti_tpu.modelmembers import states as jst
from pygsti_tpu.models import modelconstruction as jmc
from pygsti_tpu.objectivefns.objectivefns import ObjectiveFunctionBuilder as JBuilder
from pygsti_tpu.protocols import gst as jgst
from pygsti_tpu.protocols.protocol import ProtocolData as JProtocolData
from pygsti_tpu.tools import jamiolkowski as jjam
from pygsti_tpu.tools import lindbladtools as jlt
from pygsti_tpu.tools import optools as jot

import pygsti_tpu_torch.modelpacks.smq1Q_XYI as tmp1
import pygsti_tpu_torch.modelpacks.smq2Q_XYICNOT as tmp2
from pygsti_tpu_torch.baseobjs import errorgenlabel as tlbl
from pygsti_tpu_torch.baseobjs.basis import Basis as TBasis
from pygsti_tpu_torch.baseobjs.nicelyserializable import NicelySerializable
from pygsti_tpu_torch.circuits.gstcircuits import create_lsgst_circuit_lists as t_lists
from pygsti_tpu_torch.convert import model_from_types
from pygsti_tpu_torch.data.dataset import DataSet
from pygsti_tpu_torch.forwardsims.forwardsim import SimpleForwardSimulator
from pygsti_tpu_torch.modelmembers import operations as top
from pygsti_tpu_torch.modelmembers import povms as tpv
from pygsti_tpu_torch.modelmembers import states as tst
from pygsti_tpu_torch.models import modelconstruction as tmc
from pygsti_tpu_torch.models.gaugegroup import UnitaryGaugeGroup
from pygsti_tpu_torch.objectivefns.objectivefns import ObjectiveFunctionBuilder as TBuilder
from pygsti_tpu_torch.protocols import gst as tgst
from pygsti_tpu_torch.protocols.protocol import ProtocolData as TProtocolData
from pygsti_tpu_torch.tools import jamiolkowski as tjam
from pygsti_tpu_torch.tools import lindbladtools as tlt
from pygsti_tpu_torch.tools import optools as tot

PACKS = {1: (jmp1, tmp1), 2: (jmp2, tmp2)}
ALL_TYPES = ['static', 'full', 'full TP', 'static unitary', 'static standard', 'full unitary',
             'CPTP', 'CPTPLND', 'GLND', 'H+S', 'H+s', 'H']
LINDBLAD = ['H', 'H+S', 'H+s', 'GLND', 'CPTPLND']
MEMBERS = ['FullUnitaryOp', 'FullCPTPOp', 'ComposedOp', 'ComposedState', 'ComposedPOVM'] \
    + ['ExpErrorgenOp-' + t for t in LINDBLAD]


def _gate(nq):
    """The pack's last gate (Gypi2 at one qubit, CNOT at two): its unitary
    and its 'pp' superoperator."""
    tm = PACKS[nq][1].target_model('static unitary')
    op = list(tm.operations.values())[-1]
    return op.unitary, op.dense()


@functools.lru_cache(maxsize=None)
def _pair(name, nq):
    """(JAX member, port member, parameter vector): the same construction in
    both packages, then the JAX member's parameters plus noise of scale 0.05."""
    dim = 4 ** nq
    u, mx = _gate(nq)
    out = []
    for ops, sts, pvs, mc in ((jop, jst, jpv, jmc), (top, tst, tpv, tmc)):
        if name == 'FullUnitaryOp':
            m = ops.FullUnitaryOp(u, 'pp')
        elif name == 'FullCPTPOp':
            depol = np.diag([1.0] + [0.9] * (dim - 1)) @ mx
            m = ops.FullCPTPOp.from_superop_matrix(depol, 'pp')
        elif name == 'ComposedOp':     # two parameterized factors: offsets matter
            m = ops.ComposedOp([ops.FullTPOp(mx), ops.ExpErrorgenOp(
                ops.build_lindblad_errorgen('pp', 'H+S', dim))])
        elif name == 'ComposedState':
            m = sts.ComposedState(sts.ComputationalBasisState([0] * nq, 'pp'), ops.ExpErrorgenOp(
                ops.build_lindblad_errorgen('pp', 'CPTPLND', dim)))
        elif name == 'ComposedPOVM':
            m = pvs.ComposedPOVM(ops.ExpErrorgenOp(
                ops.build_lindblad_errorgen('pp', 'GLND', dim)),
                pvs.ComputationalBasisPOVM(nq, 'pp'))
        else:
            m = ops.ExpErrorgenOp(ops.build_lindblad_errorgen('pp', name.split('-')[1], dim))
        out.append(m)
    jm, tm = out
    assert jm.num_params == tm.num_params
    v = jm.to_vector() + 0.05 * np.random.RandomState(17 + nq).randn(jm.num_params)
    return jm, tm, v


# -- (a), (b): dense forms and Jacobians ------------------------------------------------

@pytest.mark.parametrize("nq", [1, 2])
@pytest.mark.parametrize("name", MEMBERS)
def test_member_dense(name, nq):
    """to_dense at random parameters of scale 0.05: within 1e-12 of the JAX
    member's; and the members start from the same parameters (1e-13: the
    unitary's come from a matrix logarithm)."""
    jm, tm, v = _pair(name, nq)
    assert np.max(np.abs(tm.to_vector() - jm.to_vector()), initial=0) < 1e-13
    dense = tm.to_dense(torch.as_tensor(v))
    assert dense.dtype == torch.float64
    ref = np.asarray(jm.to_dense_jax(jnp.asarray(v)))
    assert dense.shape == ref.shape
    assert np.max(np.abs(dense.numpy() - ref)) < 1e-12
    tm2 = tm.copy()
    tm2.from_vector(v)
    assert np.array_equal(tm2.to_vector(), v) and np.array_equal(tm2.dense(), dense.numpy())


@pytest.mark.parametrize("nq", [1, 2])
@pytest.mark.parametrize("name", MEMBERS)
def test_member_jacobian(name, nq):
    """d dense / d v by torch.func.jacfwd against jax.jacfwd: 1e-10."""
    jm, tm, v = _pair(name, nq)
    jac = torch.func.jacfwd(tm.to_dense)(torch.as_tensor(v)).numpy()
    ref = np.asarray(jax.jacfwd(jm.to_dense_jax)(jnp.asarray(v)))
    assert jac.shape == ref.shape and jac.shape[-1] == len(v)
    assert np.max(np.abs(jac - ref)) < 1e-10
    assert np.max(np.abs(ref)) > 1e-3


@pytest.mark.parametrize("norm", [0.0, 1e-7, 1e-5, 3e-4, 1e-3, 0.01, 0.03, 0.045, 0.06, 0.3,
                                  1.0, 3.0])
@pytest.mark.parametrize("kind", ['real', 'complex'])
def test_matrix_exp_accuracy(kind, norm):
    """The port's matrix exponential against scipy's at 1-norms on both
    sides of every polynomial switch of torch.linalg.matrix_exp, whose
    degree-8 branch (norms 3.4e-4 to 5e-2) is off by up to 1e-11 on its own:
    1e-13 times max(1, exp(norm))."""
    rng = np.random.RandomState(3)
    a = rng.randn(16, 16) + (1j * rng.randn(16, 16) if kind == 'complex' else 0)
    a *= norm / np.linalg.norm(a, 1)
    out = top._matrix_exp(torch.as_tensor(a)).numpy()
    assert np.max(np.abs(out - scipy.linalg.expm(a))) < 1e-13 * max(1.0, np.exp(norm))


def test_float32_members_stay_float32():
    _, tm, v = _pair('ExpErrorgenOp-CPTPLND', 1)
    dense = tm.to_dense(torch.as_tensor(v, dtype=torch.float32))
    assert dense.dtype == torch.float32
    assert np.max(np.abs(dense.numpy() - tm.to_dense(torch.as_tensor(v)).numpy())) < 1e-5


# -- (c): construction by type ------------------------------------------------------------

def _jax_tensors(jm, theta):
    t = jm.tensors_fn()(jnp.asarray(theta))
    return [np.asarray(x) for x in (t.ops, t.preps, t.effects)]


def _port_tensors(tm, theta):
    t = tm.tensors_fn()(torch.as_tensor(theta))
    return [x.numpy() for x in (t.ops, t.preps, t.effects)]


def _member_names(model):
    return [type(o).__name__ for d in (model.preps, model.povms, model.operations)
            for o in d.values()]


@pytest.mark.parametrize("nq", [1, 2])
@pytest.mark.parametrize("gate_type", ALL_TYPES)
def test_target_model_of_each_type(gate_type, nq):
    """target_model(type): the JAX package's member classes, parameter count
    and vector, default types, and tensors_fn at a perturbed vector (1e-12)."""
    jmp, tmp = PACKS[nq]
    jm, tm = jmp.target_model(gate_type), tmp.target_model(gate_type)
    assert _member_names(tm) == _member_names(jm)
    assert tm.num_params == jm.num_params
    assert (tm.default_gate_type, tm.default_prep_type, tm.default_povm_type) == \
        (jm.default_gate_type, jm.default_prep_type, jm.default_povm_type)
    assert np.max(np.abs(tm.to_vector() - jm.to_vector()), initial=0) < 1e-13
    theta = jm.to_vector() + 0.05 * np.random.RandomState(5).randn(jm.num_params)
    for a, b in zip(_port_tensors(tm, theta), _jax_tensors(jm, theta)):
        assert a.shape == b.shape and np.max(np.abs(a - b)) < 1e-12


def test_two_qubit_parameter_counts():
    counts = {t: tmp2.target_model(t).num_params for t in ('CPTPLND', 'GLND', 'H+S', 'H')}
    assert counts == {'CPTPLND': 1920, 'GLND': 1920, 'H+S': 240, 'H': 90}
    assert [tmp1.target_model(t).num_params for t in ('H+S', 'GLND', 'H', 'full unitary')] \
        == [30, 60, 9, 12]


@pytest.mark.parametrize("gate_type", ['full unitary', 'CPTPLND', 'GLND', 'H+S', 'full TP',
                                       'static'])
def test_make_members_match_jax(gate_type):
    """_make_op / _make_prep / _make_povm: the JAX package's classes and
    initial parameters for the same ideal values."""
    _, mx = _gate(1)
    vec = np.array([1, 0, 0, 1]) / np.sqrt(2)
    effects = {'0': vec, '1': np.array([1, 0, 0, -1]) / np.sqrt(2)}
    jb, tb = JBasis.cast('pp', 4), TBasis('pp', 4)
    for jfn, tfn, args, nq in ((jmc._make_op, tmc._make_op, (mx, gate_type), ()),
                               (jmc._make_prep, tmc._make_prep, (vec, gate_type), (1,)),
                               (jmc._make_povm, tmc._make_povm, (effects, gate_type), (1,))):
        jm, tm = jfn(*args, jb, *nq), tfn(*args, tb, *nq)
        assert type(tm).__name__ == type(jm).__name__
        assert np.max(np.abs(tm.to_vector() - jm.to_vector()), initial=0) < 1e-13
        assert np.max(np.abs(tm.dense() - jm.to_dense())) < 1e-13


@pytest.mark.parametrize("fn,args,message", [
    ('_make_op', (np.eye(4), 'nope', 'pp'), r"Unknown gate type 'nope'$"),
    ('_make_prep', (np.ones(4), 'H', 'pp', 1), r"Unknown prep type 'H'$"),
    ('_make_povm', ({}, 'H', 'pp', 1), r"Unknown povm type 'H'$"),
    ('_make_prep', (np.ones(4), 'CPTPLND', 'pp'), "requires a qubit state space"),
    ('_make_povm', ({}, 'computational', 'pp'), "requires a qubit state space"),
])
def test_make_members_errors(fn, args, message):
    """The JAX package's errors: an unknown type (SPAM has no 'H' form), a
    computational or Lindblad SPAM type without a qubit count."""
    with pytest.raises(ValueError, match=message):
        getattr(tmc, fn)(*args)
    with pytest.raises((ValueError, TypeError)):
        getattr(jmc, fn)(*args, *([None] if len(args) == 3 and fn != '_make_op' else []))


@pytest.mark.parametrize("gate_type", ['CPTPLND', 'H+S', 'full unitary', 'full TP'])
def test_set_all_parameterizations(gate_type):
    """A depolarized 'full' model converted in place: the JAX package's
    classes, vector and default gate type.  The SPAM follows the gate type;
    where that has no SPAM form ('H') both packages raise."""
    noise = None if gate_type == 'full unitary' else 0.03    # a unitary type needs unitaries
    jm = jmp1.target_model('full').depolarize(op_noise=noise)
    tm = tmp1.target_model('full').depolarize(op_noise=noise)
    spam = {'full unitary': 'computational'}.get(gate_type, 'auto')
    jm.set_all_parameterizations(gate_type, spam, spam)
    tm.set_all_parameterizations(gate_type, spam, spam)
    assert _member_names(tm) == _member_names(jm) and tm.default_gate_type == gate_type
    assert tm.num_params == jm.num_params
    assert np.max(np.abs(tm.to_vector() - jm.to_vector())) < 1e-13
    with pytest.raises(ValueError, match="Unknown prep type 'H'"):
        tmp1.target_model('full').set_all_parameterizations('H')
    with pytest.raises(ValueError, match="Unknown prep type 'H'"):
        jmp1.target_model('full').set_all_parameterizations('H')


def _lindblad_type(errorgen):
    """The parameterization name of a JAX-package LindbladErrorgen."""
    shape = tuple((b.block_type, b.param_mode) for b in errorgen.blocks)
    return {(('ham', 'elements'),): 'H',
            (('ham', 'elements'), ('other_diag', 'cholesky')): 'H+S',
            (('ham', 'elements'), ('other_diag', 'elements')): 'H+s',
            (('ham', 'elements'), ('other', 'elements')): 'GLND',
            (('ham', 'elements'), ('other', 'cholesky')): 'CPTPLND'}[shape]


def _type_of(member):
    """The parameterization name of a JAX-package member, read off it."""
    name = type(member).__name__
    if name == 'ComposedOp':
        return _lindblad_type(member.factors[1].errorgen)
    if name in ('ComposedState', 'ComposedPOVM'):
        return _lindblad_type(member.error_map.errorgen)
    return {'FullUnitaryOp': 'full unitary', 'FullTPOp': 'full TP', 'TPState': 'full TP',
            'TPPOVM': 'full TP', 'ComputationalBasisState': 'computational',
            'ComputationalBasisPOVM': 'computational'}[name]


def _ideal_of(member):
    name = type(member).__name__
    if name == 'ComposedOp':
        return member.factors[0].to_dense()
    if name == 'FullUnitaryOp':
        return jot.unitary_to_superop(scipy.linalg.expm(
            -1j * np.asarray(jop._real_params_to_hermitian_jax(
                jnp.asarray(member.to_vector()), member.udim))), 'pp').real
    return member.to_dense()


@pytest.fixture(scope='module')
def design_1q():
    jt, tt = jmp1.target_model('full TP'), tmp1.target_model('full TP')
    jl = j_lists(jt, jmp1.prep_fiducials(), jmp1.meas_fiducials(), jmp1.germs(), [1, 2, 4])
    tl = t_lists(tt, tmp1.prep_fiducials(), tmp1.meas_fiducials(), tmp1.germs(), [1, 2, 4])
    jgen = jmp1.target_model('full TP').depolarize(op_noise=0.01, spam_noise=0.01)
    jds = j_simulate(jgen, list(jl[-1]), 1000, seed=1234)
    tds = DataSet()   # the same counts in both packages
    for jc, tc in zip(jl[-1], tl[-1]):
        tds.add_count_dict(tc, dict(jds[jc].counts))
    return dict(jt=jt, tt=tt, jl=jl, tl=tl, jds=jds, tds=tds)


@pytest.mark.parametrize("gate_type", ['CPTPLND', 'GLND', 'H+S', 'full unitary'])
def test_convert_carries_a_jax_vector_across(design_1q, gate_type):
    """convert.model_from_types on what the test reads off the JAX model
    (each member's type and ideal value, the model's vector at a random
    perturbation): probabilities within 1e-10 on the maxL 4 list, and the
    blocked lsvec / J^T J / J^T f within 1e-9 of their largest entry."""
    jm = jmp1.target_model(gate_type)
    ideal = {kind: {str(k): (_type_of(o), dict(o.items()) if kind == 'povms' else _ideal_of(o))
                    for k, o in getattr(jm, kind).items()}
             for kind in ('operations', 'preps', 'povms')}
    theta = jm.to_vector() + 0.02 * np.random.RandomState(23).randn(jm.num_params)
    jm.from_vector(theta)
    tm = model_from_types(ideal['operations'], ideal['preps'], ideal['povms'], theta)
    assert _member_names(tm) == _member_names(jm)
    assert np.array_equal(tm.to_vector(), theta)
    jl, tl = design_1q['jl'], design_1q['tl']
    jp = jm.sim.bulk_probs(list(jl[-1]))
    tp = SimpleForwardSimulator(tm, device="cpu").bulk_probs(list(tl[-1]))
    assert max(abs(jp[jc][o] - tp[tc][o]) for jc, tc in zip(jl[-1], tl[-1])
               for o in jp[jc]) < 1e-10
    jobj = JBuilder('logl').build(jm, design_1q['jds'], list(jl[-1]))
    tobj = TBuilder('logl').build(tm, design_1q['tds'], list(tl[-1]), device="cpu")
    for a, b in zip(tobj.jtj_jtf(theta), jobj.jtj_jtf(theta)):
        assert a.shape == b.shape
        assert np.max(np.abs(a - b)) < 1e-9 * np.max(np.abs(b))


# -- (d): the errorgen-coefficient API ---------------------------------------------------

@pytest.mark.parametrize("nq", [1, 2])
@pytest.mark.parametrize("name", ['ExpErrorgenOp-H+S', 'ExpErrorgenOp-H+s',
                                  'ExpErrorgenOp-CPTPLND', 'ComposedOp', 'ComposedState',
                                  'ComposedPOVM'])
def test_errorgen_coefficients_equal(name, nq):
    """Labels and coefficients of the H and S terms, and the full
    coefficient dictionary of the generator, at random parameters."""
    jm, tm, v = _pair(name, nq)
    jm, tm = jm.copy(), tm.copy()
    jm.from_vector(v)
    tm.from_vector(v)
    assert [str(l) for l in tm.errorgen_coefficient_labels()] == \
        [str(l) for l in jm.errorgen_coefficient_labels()]
    jc, tc = jm.errorgen_coefficients(), tm.errorgen_coefficients()
    assert [str(k) for k in tc] == [str(k) for k in jc] and len(tc) > 0
    assert np.max(np.abs(np.array(list(tc.values())) - np.array(list(jc.values())))) < 1e-14
    jeg = jm.errorgen if hasattr(jm, 'errorgen') else None
    if jeg is not None:
        full_j, full_t = jeg.coefficients(), tm.errorgen.coefficients()
        assert list(full_t) == list(full_j)
        assert np.max(np.abs(np.array(list(full_t.values()))
                             - np.array(list(full_j.values())))) < 1e-14


@pytest.mark.parametrize("label_kind", ['local', 'global', 'tuple'])
def test_set_errorgen_coefficients_round_trip(label_kind):
    """Set two H and two S coefficients of a 2-qubit 'H+S' member by each
    kind of label: they read back, the others keep their values, and the
    JAX member given the same dictionary ends at the same vector."""
    jm, tm, v = _pair('ExpErrorgenOp-H+S', 2)
    jm, tm = jm.copy(), tm.copy()
    jm.from_vector(v)
    tm.from_vector(v)
    before = tm.errorgen_coefficients()
    new = {('H', 'XI'): 0.011, ('H', 'ZY'): -0.02, ('S', 'IX'): 0.004, ('S', 'YY'): 0.0}
    dicts = []
    for mod in (jlbl, tlbl):
        if label_kind == 'local':
            d = {mod.LocalElementaryErrorgenLabel(t, (b,)): x for (t, b), x in new.items()}
        elif label_kind == 'global':
            d = {mod.GlobalElementaryErrorgenLabel.cast(
                mod.LocalElementaryErrorgenLabel(t, (b,)), (0, 1)): x
                for (t, b), x in new.items()}
        else:
            d = dict(new)
        dicts.append(d)
    jm.set_errorgen_coefficients(dicts[0])
    tm.set_errorgen_coefficients(dicts[1])
    after = tm.errorgen_coefficients()
    for lbl, val in after.items():
        key = (lbl.errorgen_type, lbl.basis_element_labels[0])
        assert abs(val - new.get(key, before[lbl])) < 1e-15
    assert np.max(np.abs(tm.to_vector() - jm.to_vector())) < 1e-15


def test_negative_stochastic_coefficient_raises():
    """A 'cholesky' S block stores sqrt(value): a negative value raises in
    both packages, truncate=True clips it to 0; an 'elements' block takes it."""
    for pair in (_pair('ExpErrorgenOp-H+S', 1), ):
        for m in (pair[0].copy(), pair[1].copy()):
            with pytest.raises(ValueError, match="Negative S coefficient"):
                m.set_errorgen_coefficients({('S', 'X'): -0.01})
            m.set_errorgen_coefficients({('S', 'X'): -0.01, ('S', 'Z'): 0.09}, truncate=True)
            coeffs = {str(k): x for k, x in m.errorgen_coefficients().items()}
            assert coeffs['S(X)'] == 0.0 and abs(coeffs['S(Z)'] - 0.09) < 1e-15
    free = _pair('ExpErrorgenOp-H+s', 1)[1].copy()
    free.set_errorgen_coefficients({('S', 'X'): -0.01})
    assert {str(k): x for k, x in free.errorgen_coefficients().items()}['S(X)'] == -0.01


@pytest.mark.parametrize("normalized", [True, False])
def test_model_errorgen_coefficients(normalized):
    """ExplicitOpModel.errorgen_coefficients: per member, global labels."""
    jm, tm = jmp2.target_model('H+S'), tmp2.target_model('H+S')
    theta = jm.to_vector() + 0.03 * np.random.RandomState(2).randn(jm.num_params)
    jm.from_vector(theta)
    tm.from_vector(theta)
    jc = jm.errorgen_coefficients(normalized_elem_gens=normalized)
    tc = tm.errorgen_coefficients(normalized_elem_gens=normalized)
    assert [str(k) for k in tc] == [str(k) for k in jc] and len(tc) == 8
    for (_, jd), (_, td) in zip(jc.items(), tc.items()):
        assert [str(k) for k in td] == [str(k) for k in jd] and len(td) == 30
        assert np.max(np.abs(np.array(list(td.values())) - np.array(list(jd.values())))) < 1e-14
    assert str(next(iter(next(iter(tc.values()))))) == 'H(X:1)'


def test_errorgen_label_casts():
    for mod in (jlbl, tlbl):
        loc = mod.LocalElementaryErrorgenLabel.cast('S(XI)')
        glob = mod.GlobalElementaryErrorgenLabel.cast(loc, ('a', 'b'))
        assert (str(loc), str(glob), glob.support) == ('S(XI)', 'S(X:a)', ('a',))
        assert mod.LocalElementaryErrorgenLabel.cast(glob, ('a', 'b')) == loc
        assert mod.LocalElementaryErrorgenLabel.cast(('C', 'XI', 'IZ')).support_indices() == (0, 1)
        swapped = mod.GlobalElementaryErrorgenLabel('A', ('XY', 'ZI'), (1, 0))
        assert (swapped.sslbls, swapped.basis_element_labels) == ((0, 1), ('YX', 'IZ'))
        assert swapped.padded_basis_element_labels((0, 1, 2)) == ('YXI', 'IZI')
        assert hash(mod.GlobalElementaryErrorgenLabel.cast(('H', ('X',), (0,)))) == \
            hash(mod.GlobalElementaryErrorgenLabel('H', ('X',), (0,)))
    with pytest.raises(ValueError, match="sslbls needed"):
        tlbl.GlobalElementaryErrorgenLabel.cast(tlbl.LocalElementaryErrorgenLabel('H', ('X',)))
    with pytest.raises(ValueError, match="Cannot cast"):
        tlbl.LocalElementaryErrorgenLabel.cast(3)


# -- the tools the members are built from --------------------------------------------------

@pytest.mark.parametrize("typ", ['H', 'S', 'C', 'A'])
def test_elementary_errorgens(typ):
    els = TBasis('pp', 16).elements
    assert np.array_equal(els, JBasis.cast('pp', 16).elements)
    args = (typ, els[5]) if typ in 'HS' else (typ, els[5], els[11])
    assert np.array_equal(tlt.create_elementary_errorgen(*args),
                          jlt.create_elementary_errorgen(*args))
    with pytest.raises(ValueError, match="Invalid elementary errorgen type"):
        tlt.create_elementary_errorgen('Q', els[1])


def test_lindbladian_term_errorgens():
    els = TBasis('pp', 4).elements
    for args in (('H', els[1]), ('O', els[1], els[2]), ('O', els[3])):
        assert np.array_equal(tlt.create_lindbladian_term_errorgen(*args),
                              jlt.create_lindbladian_term_errorgen(*args))
    with pytest.raises(ValueError, match="Invalid lindblad term type"):
        tlt.create_lindbladian_term_errorgen('S', els[1])


@pytest.mark.parametrize("name,dim", [('pp', 4), ('pp', 16), ('std', 4)])
def test_basis_labels(name, dim):
    assert TBasis(name, dim).labels == list(JBasis.cast(name, dim).labels)


@pytest.mark.parametrize("nq", [1, 2])
def test_jamiolkowski_and_unitary_recovery(nq):
    u, mx = _gate(nq)
    noisy = np.diag([1.0] + [0.93] * (4 ** nq - 1)) @ mx
    choi = tjam.jamiolkowski_iso(noisy, 'pp', 'pp')
    assert np.max(np.abs(choi - jjam.jamiolkowski_iso(noisy, 'pp', 'pp'))) < 1e-14
    assert abs(np.trace(choi) - 1) < 1e-14 and np.linalg.eigvalsh(choi).min() > -1e-14
    assert np.max(np.abs(tjam.jamiolkowski_iso_inv(choi, 'pp', 'pp') - noisy)) < 1e-14
    assert np.max(np.abs(tjam.fast_jamiolkowski_iso_std(noisy, 'pp')
                         - jjam.fast_jamiolkowski_iso_std(noisy, 'pp'))) < 1e-14
    back = tot.superop_to_unitary(mx, 'pp')
    assert np.max(np.abs(back - jot.superop_to_unitary(mx, 'pp'))) < 1e-13
    assert np.max(np.abs(tot.unitary_to_superop(back, 'pp').real - mx)) < 1e-13
    std = tot.unitary_to_std_process_mx(u)
    assert np.max(np.abs(tot.unitary_to_std_process_mx(tot.std_process_mx_to_unitary(std))
                         - std)) < 1e-13
    with pytest.raises(ValueError, match="not unitary"):
        tot.superop_to_unitary(noisy, 'pp')


def test_full_cptp_op_kraus_and_checks():
    """FullCPTPOp's Kraus operators rebuild its superoperator, whose Choi
    matrix is positive with trace one at any parameters; a Choi matrix that
    is not of trace one or not positive is refused."""
    _, tm, v = _pair('FullCPTPOp', 1)
    tm = tm.copy()
    tm.from_vector(v)
    kraus = tm.kraus_operators
    rebuilt = sum(tot.unitary_to_superop(k, 'pp') for k in kraus)
    assert np.max(np.abs(rebuilt.real - tm.dense())) < 1e-12
    choi = tjam.jamiolkowski_iso(tm.dense(), 'pp', 'pp')
    assert abs(np.trace(choi) - 1) < 1e-14 and np.linalg.eigvalsh(choi).min() > -1e-14
    with pytest.raises(ValueError, match="trace 1"):
        top.FullCPTPOp(np.eye(4), 'pp')
    with pytest.raises(ValueError, match="positive semidefinite"):
        top.FullCPTPOp(np.diag([1.5, -0.5, 0, 0]), 'pp')
    assert top.FullCPTPOp(np.eye(4), 'pp', truncate=True).num_params == 16


def test_block_start_points_and_checks():
    """The 'other' block in 'cholesky' mode starts at cholesky(M0 + 1e-14 I),
    a diagonal of 1e-7 for M0 = 0 and never exactly 0; an M0 with no
    Cholesky factor is an error, not a silent zero start; complex H or S
    generators are refused."""
    jeg = jop.build_lindblad_errorgen('pp', 'CPTPLND', 4, {('S', 'X'): 0.01, ('H', 'Z'): 0.02})
    teg = top.build_lindblad_errorgen('pp', 'CPTPLND', 4, {('S', 'X'): 0.01, ('H', 'Z'): 0.02})
    assert np.array_equal(teg.to_vector(), jeg.to_vector())
    zero = top.build_lindblad_errorgen('pp', 'CPTPLND', 4).to_vector()
    assert np.array_equal(zero[3:6], [1e-7] * 3) and not zero[6:].any()
    gens = top._block_generators('pp', 4, 'other', ('X', 'Y', 'Z'))
    with pytest.raises(ValueError, match="no Cholesky factor"):
        top.LindbladCoefficientBlock('other', 'XYZ', gens, 'cholesky', -np.eye(3))
    with pytest.raises(ValueError, match="must be real"):
        top.LindbladCoefficientBlock('ham', 'XYZ', 1j * np.ones((3, 4, 4)))
    with pytest.raises(ValueError, match="Invalid block type"):
        top.LindbladCoefficientBlock('nope', 'XYZ', np.ones((3, 4, 4)))
    with pytest.raises(ValueError, match="Unknown Lindblad parameterization"):
        top.build_lindblad_errorgen('pp', 'nope', 4)


@pytest.mark.parametrize("param,max_weight", [('H+S', 1), ('CPTPLND', 1), ('S', None),
                                              ('s', 1)])
def test_build_lindblad_errorgen_options(param, max_weight):
    """max_weight and the stochastic-only forms: labels, parameter count and
    dense generator at random parameters as in the JAX package."""
    jeg = jop.build_lindblad_errorgen('pp', param, 16, max_weight=max_weight)
    teg = top.build_lindblad_errorgen('pp', param, 16, max_weight=max_weight)
    assert [(b.block_type, b.param_mode, list(b.basis_element_labels)) for b in teg.blocks] == \
        [(b.block_type, b.param_mode, list(b.basis_element_labels)) for b in jeg.blocks]
    v = 0.05 * np.random.RandomState(9).randn(jeg.num_params)
    assert teg.num_params == jeg.num_params == len(v)
    assert np.max(np.abs(teg.to_dense(torch.as_tensor(v)).numpy()
                         - np.asarray(jeg.to_dense_jax(jnp.asarray(v))))) < 1e-13


# -- (e), (f): the fit ---------------------------------------------------------------------

NAME = 'GateSetTomography'


@pytest.fixture(scope='module')
def fits(design_1q, tmp_path_factory):
    """smq1Q_XYI, maxL 1, 2, 4: a true CPTPLND fit in both packages from the
    converted target, no gauge optimization, on the JAX package's counts; the
    port writes its checkpoints."""
    d = design_1q
    ckdir = tmp_path_factory.mktemp('cptp_checkpoints')
    jdata = JProtocolData(jgst.GateSetTomographyDesign(d['jt'], d['jl']), d['jds'])
    tdata = TProtocolData(tgst.GateSetTomographyDesign(d['tt'], d['tl']), d['tds'])
    jres = jgst.GateSetTomography(
        jgst.GSTInitialModel(target_model=jgst._convert_target(d['jt'], 'CPTPLND'),
                             starting_point='target'),
        gaugeopt_suite=None, verbosity=0).run(jdata, disable_checkpointing=True)
    tres = tgst.GateSetTomography(
        tgst.GSTInitialModel(target_model=tgst._convert_target(d['tt'], 'CPTPLND'),
                             starting_point='target'),
        gaugeopt_suite=None, verbosity=0, device="cpu").run(
            tdata, checkpoint_path=str(ckdir / 'port'))
    return dict(d, jres=jres, tres=tres, jdata=jdata, tdata=tdata, ckdir=ckdir)


def test_cptp_fit_reaches_the_jax_fit(fits):
    """Stage values within 1e-3 relative and N_sigma within 1e-3; the
    members stay composed, 60 parameters."""
    jest, test_ = fits['jres'].estimates[NAME], fits['tres'].estimates[NAME]
    jvals = sum(jest.parameters['raw_objective_values'], [])
    tvals = sum(test_.parameters['raw_objective_values'], [])
    assert len(tvals) == len(jvals) == 4
    assert np.allclose(tvals, jvals, rtol=1e-3)
    assert test_.parameters['final_dof'] == jest.parameters['final_dof']
    assert abs(test_.misfit_sigma() - jest.misfit_sigma()) < 1e-3
    assert test_.misfit_sigma() < 3
    final = test_.models['final iteration estimate']
    assert final.num_params == 60 and set(_member_names(final)) == {
        'ComposedState', 'ComposedPOVM', 'ComposedOp'}
    assert _member_names(final) == _member_names(jest.models['final iteration estimate'])
    assert not np.any(final.to_vector() == 0)      # nothing sits on the L = 0 saddle


def test_cptp_fit_probabilities_agree(fits):
    jm = fits['jres'].estimates[NAME].models['final iteration estimate']
    tm = fits['tres'].estimates[NAME].models['final iteration estimate']
    jl, tl = fits['jl'], fits['tl']
    jp = jm.sim.bulk_probs(list(jl[-1]))
    tp = SimpleForwardSimulator(tm, device="cpu").bulk_probs(list(tl[-1]))
    assert max(abs(jp[jc][o] - tp[tc][o]) for jc, tc in zip(jl[-1], tl[-1])
               for o in jp[jc]) < 1e-4


def test_cptp_fitted_model_is_cptp(fits):
    """Every fitted operation: Choi eigenvalues >= -1e-10 and first row e0;
    the prep a state of trace one and the effects summing to the identity."""
    tm = fits['tres'].estimates[NAME].models['final iteration estimate']
    for op in tm.operations.values():
        mx = op.dense()
        choi = tjam.jamiolkowski_iso(mx, 'pp', 'pp')
        assert np.linalg.eigvalsh((choi + choi.conj().T) / 2).min() >= -1e-10
        assert np.max(np.abs(mx[0] - np.eye(4)[0])) < 1e-10
    rho = next(iter(tm.preps.values())).dense()
    effects = next(iter(tm.povms.values())).dense()
    assert abs(rho[0] - 1 / np.sqrt(2)) < 1e-10
    assert np.max(np.abs(effects.sum(axis=0) - np.array([np.sqrt(2), 0, 0, 0]))) < 1e-10


def test_cptp_checkpoints_read_back(fits):
    """(g) A CPTPLND model through GateSetTomographyCheckpoint: the last
    file reads back to the final vector exactly, members composed, and a run
    resumed from it fits nothing."""
    est = fits['tres'].estimates[NAME]
    ck = tgst.GateSetTomographyCheckpoint.read(str(fits['ckdir'] / 'port_iteration_2.json'))
    final = est.models['final iteration estimate']
    assert len(ck.mdl_list) == 3
    assert np.array_equal(ck.mdl_list[-1].to_vector(), final.to_vector())
    assert _member_names(ck.mdl_list[-1]) == _member_names(final)
    assert np.array_equal(ck.mdl_list[-1].operations['Gxpi2', 0].dense(),
                          final.operations['Gxpi2', 0].dense())
    res = tgst.GateSetTomography(gaugeopt_suite=None, verbosity=0, device="cpu").run(
        fits['tdata'], checkpoint=ck, checkpoint_path=str(fits['ckdir'] / 'resumed'))
    assert res.estimates[NAME].parameters['raw_objective_values'] == []
    assert res.estimates[NAME].misfit_sigma() == est.misfit_sigma()


# -- (g): serialization --------------------------------------------------------------------

@pytest.mark.parametrize("name", MEMBERS + ['ComputationalBasisState',
                                            'ComputationalBasisPOVM', 'LindbladErrorgen'])
def test_member_serialization_round_trip(name, tmp_path):
    """State dict, JSON string and file: the same class, parameters and
    dense value; generators are rebuilt, not stored."""
    if name == 'ComputationalBasisState':
        tm = tst.ComputationalBasisState([1, 0], 'pp')
    elif name == 'ComputationalBasisPOVM':
        tm = tpv.ComputationalBasisPOVM(2, 'pp')
    elif name == 'LindbladErrorgen':
        tm = top.build_lindblad_errorgen('pp', 'CPTPLND', 16, max_weight=1)
        tm.from_vector(0.05 * np.random.RandomState(1).randn(tm.num_params))
    else:
        tm = _pair(name, 2)[1].copy()
        tm.from_vector(_pair(name, 2)[2])
    text = tm.dumps()
    assert len(text) < 40000 and '_gens' not in text
    tm.write(str(tmp_path / 'member.json'))
    for back in (NicelySerializable.from_nice_serialization(tm.to_nice_serialization()),
                 type(tm).loads(text), type(tm).read(str(tmp_path / 'member.json'))):
        assert type(back) is type(tm)
        assert np.array_equal(back.to_vector(), tm.to_vector())
        assert np.array_equal(back.dense(), tm.dense())


def test_member_copies_drop_the_tensor_cache():
    _, tm, v = _pair('ExpErrorgenOp-CPTPLND', 1)
    tm.to_dense(torch.as_tensor(v))
    block = tm.errorgen.blocks[-1]
    assert '_tensor_cache' in block.__dict__
    assert '_tensor_cache' not in tm.copy().errorgen.blocks[-1].__dict__


# -- the three decisions --------------------------------------------------------------------

def test_gauge_transform_of_composed_members_raises_as_in_jax():
    group = UnitaryGaugeGroup(4, 'pp')
    el = group.compute_element(0.01 * np.ones(group.num_params))
    tm, jm = tmp1.target_model('CPTPLND'), jmp1.target_model('CPTPLND')
    with pytest.raises(NotImplementedError,
                       match="ComposedState does not support gauge transforms"):
        tm.transform_inplace(el)
    with pytest.raises(NotImplementedError,
                       match="ComposedState does not support gauge transforms"):
        jm.transform_inplace(el)
    for member in (top.FullUnitaryOp(np.eye(2)), _pair('FullCPTPOp', 1)[1],
                   tpv.ComputationalBasisPOVM(1), tst.ComputationalBasisState([0])):
        with pytest.raises(NotImplementedError, match="does not support gauge transforms"):
            member.transform_inplace(el.transform_matrix, el.transform_matrix_inverse)


@pytest.mark.parametrize("gate_type", ['CPTPLND', 'full unitary'])
def test_depolarize_refuses_members_it_cannot_rebuild(gate_type):
    """Both packages rebuild a depolarized member from its dense value with
    the member's own constructor, which only the dense families take: the
    port says so, the JAX package fails inside the constructor (or, for a
    unitary, builds an operation of the wrong dimension)."""
    with pytest.raises(TypeError, match="depolarize cannot rebuild a"):
        tmp1.target_model(gate_type).depolarize(op_noise=0.01)
    with pytest.raises(TypeError, match="depolarize cannot rebuild a"):
        tmp1.target_model('CPTPLND').depolarize(spam_noise=0.01)
    if gate_type == 'CPTPLND':
        with pytest.raises(AttributeError):
            jmp1.target_model(gate_type).depolarize(op_noise=0.01)
    else:
        wrong = jmp1.target_model(gate_type).depolarize(op_noise=0.01)
        assert next(iter(wrong.operations.values())).dim == 16
    ok = tmp1.target_model('full TP').depolarize(op_noise=0.01, spam_noise=0.01)
    assert ok.frobeniusdist(tmp1.target_model('full TP')) > 0


def test_copy_and_frobeniusdist_of_composed_models():
    tm = tmp2.target_model('CPTPLND')
    theta = tm.to_vector() + 0.01 * np.random.RandomState(4).randn(tm.num_params)
    moved = tm.copy()
    moved.from_vector(theta)
    assert np.array_equal(tm.to_vector(), tmp2.target_model('CPTPLND').to_vector())
    jm, jmoved = jmp2.target_model('CPTPLND'), jmp2.target_model('CPTPLND')
    jmoved.from_vector(theta)
    assert abs(moved.frobeniusdist(tm) - jmoved.frobeniusdist(jm)) < 1e-13
    assert tm.num_qubits == 2 and tmp1.target_model('full').num_qubits == 1


# -- the model's tensors and their Jacobian -------------------------------------------------

@pytest.mark.parametrize("pack,gate_type", [(1, 'CPTPLND'), (2, 'CPTPLND'), (2, 'H+S'), (1, 'H'),
                                            (2, 'full unitary'), (1, 'full TP'), (2, 'full'),
                                            (1, 'static')])
def test_flat_tensors_jacobian_equals_plain_forward_mode(pack, gate_type):
    """Tv taken with as many tangents as the largest member has parameters
    equals torch.func.jacfwd over every parameter to the last bit, and the
    grouped evaluation of the error maps equals each member's own to_dense
    (1e-14: the same arithmetic, batched)."""
    tm = PACKS[pack][1].target_model(gate_type)
    theta = tm.to_vector() + 0.05 * np.random.RandomState(8).randn(tm.num_params)
    v = torch.as_tensor(theta)
    flat = tm.flat_tensors_fn()
    tv = tm.flat_tensors_jacobian_fn()(v)
    assert tv.shape == (flat(v).numel(), tm.num_params)
    if tm.num_params:
        assert torch.equal(tv, torch.func.jacfwd(flat)(v))
    members = list(tm.operations.values()) + list(tm.preps.values()) + list(tm.povms.values())
    own = torch.cat([m.to_dense(v[m.gpindices]).reshape(-1) for m in members])
    assert float((flat(v) - own).abs().max()) < 1e-14


def test_error_maps_are_grouped_by_function():
    """Members around error maps of one structure share a call; a member
    with another structure, or with parameters outside its error map, is
    evaluated on its own."""
    tm = tmp1.target_model('CPTPLND')
    ops = list(tm.operations.values())
    emap, pre, post = ops[1].error_map_form()
    assert emap is ops[1].factors[1] and post is None
    assert np.array_equal(pre, ops[1].factors[0].dense())
    prep_map = next(iter(tm.preps.values())).error_map_form()[0]
    assert emap.same_function_as(prep_map)
    other = top.ExpErrorgenOp(top.build_lindblad_errorgen('pp', 'GLND', 4))
    assert not emap.same_function_as(other)
    assert _pair('ComposedOp', 1)[1].error_map_form() is None     # two live factors
    assert tmp1.target_model('full').operations['Gxpi2', 0].error_map_form() is None
    # a model mixing both: one GLND gate among CPTPLND members
    tm.operations['Gxpi2', 0] = top.ComposedOp([ops[1].factors[0], other])
    theta = tm.to_vector() + 0.05 * np.random.RandomState(6).randn(tm.num_params)
    v = torch.as_tensor(theta)
    members = list(tm.operations.values()) + list(tm.preps.values()) + list(tm.povms.values())
    own = torch.cat([m.to_dense(v[m.gpindices]).reshape(-1) for m in members])
    assert float((tm.flat_tensors_fn()(v) - own).abs().max()) < 1e-14
    assert torch.equal(tm.flat_tensors_jacobian_fn()(v),
                       torch.func.jacfwd(tm.flat_tensors_fn())(v))
