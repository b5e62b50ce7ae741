"""Model construction (counterpart of pygsti_tpu/models/modelconstruction.py):
members by parameterization name (_make_op, _make_prep, _make_povm, for
every type the JAX package's functions take), unitaries embedded on a
qubit register, the expression constructors of the legacy packs
(create_operation, create_spam_vector,
create_explicit_model_from_expressions), create_identity_vec and
create_explicit_alias_model.

A state space is given as the JAX package takes it: a list of qubit labels
('Q0', ...) or of tuples of them, one tuple per tensor-product block; the
port supports one block of qubits.
"""

from __future__ import annotations

import collections
import re

import numpy as np
import scipy.linalg

from pygsti_tpu_torch.baseobjs.basis import Basis
from pygsti_tpu_torch.baseobjs.label import Label
from pygsti_tpu_torch.modelmembers import operations as _op
from pygsti_tpu_torch.modelmembers import states as _st
from pygsti_tpu_torch.modelmembers import povms as _pv
from pygsti_tpu_torch.tools import optools as _ot
from pygsti_tpu_torch.tools.basistools import stdmx_to_vec
from pygsti_tpu_torch.tools.internalgates import sigmaX, sigmaY, sigmaZ

LINDBLAD_GATE_TYPES = ('CPTP', 'CPTPLND', 'GLND', 'H+S', 'H+s', 'H')
LINDBLAD_SPAM_TYPES = ('CPTP', 'CPTPLND', 'GLND', 'H+S', 'H+s')
COMPUTATIONAL_SPAM_TYPES = ('computational', 'static', 'static unitary', 'static standard',
                            'full unitary', 'static pure')


def _lindblad_error_map(name, basis):
    return _op.ExpErrorgenOp(_op.build_lindblad_errorgen(
        basis, 'CPTPLND' if name == 'CPTP' else name))


def _require_qubits(kind, name, nqubits):
    if nqubits is None:
        raise ValueError("%s type %r requires a qubit state space" % (kind, name))


def _make_op(ideal_mx, gate_type, basis):
    """The operation of type `gate_type` at the dense superoperator
    `ideal_mx`; a Lindblad type composes the static ideal with exp(error
    generator), the generator starting at zero."""
    if gate_type in ('static', 'static arbitrary'):
        return _op.StaticArbitraryOp(ideal_mx)
    if gate_type in ('full', 'full arbitrary'):
        return _op.FullArbitraryOp(ideal_mx)
    if gate_type in ('full TP', 'TP'):
        return _op.FullTPOp(ideal_mx)
    if gate_type in ('static unitary', 'static standard'):
        return _op.StaticUnitaryOp(_ot.superop_to_unitary(np.asarray(ideal_mx), basis), basis)
    if gate_type == 'full unitary':
        return _op.FullUnitaryOp(_ot.superop_to_unitary(np.asarray(ideal_mx), basis), basis)
    if gate_type in LINDBLAD_GATE_TYPES:
        return _op.ComposedOp([_op.StaticArbitraryOp(ideal_mx),
                               _lindblad_error_map(gate_type, basis)])
    raise ValueError("Unknown gate type %r" % gate_type)


def _make_prep(ideal_vec, prep_type, basis, nqubits=None):
    """The state preparation of type `prep_type`.  The computational and
    Lindblad types build on |0...0> of `nqubits` qubits, not on `ideal_vec`."""
    if prep_type in COMPUTATIONAL_SPAM_TYPES:
        _require_qubits('prep', prep_type, nqubits)
        return _st.ComputationalBasisState([0] * nqubits, basis)
    if prep_type in ('full', 'full arbitrary'):
        return _st.FullState(ideal_vec)
    if prep_type in ('full TP', 'TP'):
        return _st.TPState(ideal_vec)
    if prep_type in LINDBLAD_SPAM_TYPES:
        _require_qubits('prep', prep_type, nqubits)
        return _st.ComposedState(_st.ComputationalBasisState([0] * nqubits, basis),
                                 _lindblad_error_map(prep_type, basis))
    raise ValueError("Unknown prep type %r" % prep_type)


def _make_povm(ideal_effects, povm_type, basis, nqubits=None):
    """The POVM of type `povm_type`.  The computational and Lindblad types
    build on the Z-basis measurement of `nqubits` qubits, not on
    `ideal_effects`."""
    if povm_type in COMPUTATIONAL_SPAM_TYPES:
        _require_qubits('povm', povm_type, nqubits)
        return _pv.ComputationalBasisPOVM(nqubits, basis)
    if povm_type in ('full', 'full arbitrary'):
        return _pv.UnconstrainedPOVM(ideal_effects)
    if povm_type in ('full TP', 'TP'):
        return _pv.TPPOVM(ideal_effects)
    if povm_type in LINDBLAD_SPAM_TYPES:
        _require_qubits('povm', povm_type, nqubits)
        return _pv.ComposedPOVM(_lindblad_error_map(povm_type, basis),
                                _pv.ComputationalBasisPOVM(nqubits, basis))
    raise ValueError("Unknown povm type %r" % povm_type)


def embed_unitary_superop(u, target_qubits, all_qubits, basis='pp'):
    """The superoperator, in the `basis` basis of the whole register, of the
    unitary `u` acting on `target_qubits` of `all_qubits` and the identity
    on the others."""
    nq_gate = int(round(np.log2(u.shape[0])))
    bname = basis if isinstance(basis, str) else basis.name
    small = np.real(_ot.unitary_to_superop(u, Basis(bname, 4 ** nq_gate)))
    n = len(all_qubits)
    if tuple(target_qubits) == tuple(all_qubits):
        return small
    tgt_pos = [list(all_qubits).index(t) for t in target_qubits]
    other_pos = [i for i in range(n) if i not in tgt_pos]
    full = np.kron(small, np.eye(4 ** len(other_pos)))
    inv = [0] * n
    for newpos, srcpos in enumerate(tgt_pos + other_pos):
        inv[srcpos] = newpos
    full = full.reshape([4] * (2 * n))
    full = np.transpose(full, inv + [p + n for p in inv])
    return full.reshape(4 ** n, 4 ** n)


def state_space_qubits(state_space):
    """The qubit labels of a state space given as a list of labels or a list
    of one tuple of labels."""
    blocks = list(state_space)
    if blocks and all(isinstance(b, (tuple, list)) for b in blocks):
        if len(blocks) != 1:
            raise ValueError("state spaces of several tensor-product blocks are not ported")
        return tuple(blocks[0])
    return tuple(blocks)


def create_spam_vector(vec_expr, state_space, basis):
    """The superket |i><i| of the computational state named by the integer
    expression `vec_expr` ('0', '1', ...)."""
    udim = 2 ** len(state_space_qubits(state_space))
    idx = int(vec_expr)
    rho = np.zeros((udim, udim), dtype=complex)
    rho[idx, idx] = 1.0
    return np.real(stdmx_to_vec(rho, basis))


def _angle(s):
    return float(eval(s, {'pi': np.pi, 'sqrt': np.sqrt, '__builtins__': {}}))  # noqa: S307


def create_operation(op_expr, state_space, basis='pp', parameterization='full'):
    """The dense superoperator of an expression: 'I(Q0)', 'X(theta,Q0)',
    'Y(...)', 'Z(...)', 'N(theta, sx, sy, sz, Q0)' (a rotation about the
    axis (sx, sy, sz)), 'CX(theta,Q0,Q1)', 'CZ(theta,Q0,Q1)', 'CNOT(Q0,Q1)',
    'CPHASE(Q0,Q1)', and products of factors on disjoint qubits joined by
    ':' ('X(pi/2,Q0):Y(pi/2,Q1)').  Angles may use pi and sqrt."""
    qlbls = state_space_qubits(state_space)
    dim = 4 ** len(qlbls)
    parts = [p for p in op_expr.strip().split(':') if p.strip()]
    if len(parts) > 1:
        # factors on disjoint qubits commute: their product is the tensor product
        out = np.eye(dim)
        for part in parts:
            out = create_operation(part, state_space, basis, parameterization) @ out
        return out
    m = re.match(r'([A-Z]+)\((.*)\)\s*$', op_expr.strip())
    if not m:
        if op_expr.strip() in ('I', ''):
            return np.eye(dim)
        raise ValueError("Cannot parse operation expression %r" % op_expr)
    kind, argstr = m.group(1), m.group(2)
    args = [a.strip() for a in argstr.split(',')] if argstr else []
    if kind in ('X', 'Y', 'Z'):
        sigma = {'X': sigmaX, 'Y': sigmaY, 'Z': sigmaZ}[kind]
        u = scipy.linalg.expm(-1j * _angle(args[0]) / 2 * sigma)
        return embed_unitary_superop(u, (args[1],), qlbls, basis)
    if kind == 'I':
        return np.eye(dim)
    if kind in ('CX', 'CZ'):
        u4 = np.eye(4, dtype=complex)
        u4[2:, 2:] = scipy.linalg.expm(-1j * _angle(args[0]) / 2
                                       * (sigmaX if kind == 'CX' else sigmaZ))
        return embed_unitary_superop(u4, (args[1], args[2]), qlbls, basis)
    if kind == 'CNOT':
        u4 = np.array([[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 0, 1], [0, 0, 1, 0]], dtype=complex)
        return embed_unitary_superop(u4, (args[0], args[1]), qlbls, basis)
    if kind == 'CPHASE':
        return embed_unitary_superop(np.diag([1, 1, 1, -1]).astype(complex),
                                     (args[0], args[1]), qlbls, basis)
    if kind == 'N':
        sx, sy, sz = (_angle(a) for a in args[1:4])
        u = scipy.linalg.expm(-1j * _angle(args[0]) / 2
                              * (sx * sigmaX + sy * sigmaY + sz * sigmaZ))
        return embed_unitary_superop(u, (args[4],), qlbls, basis)
    raise ValueError("Unknown operation kind %r" % kind)


def create_explicit_model_from_expressions(state_space, op_labels, op_expressions,
                                           prep_labels=('rho0',), prep_expressions=('0',),
                                           effect_labels='standard',
                                           effect_expressions='standard',
                                           povm_labels='Mdefault', basis='pp',
                                           gate_type='full', prep_type='auto',
                                           povm_type='auto'):
    """An ExplicitOpModel from expression strings (create_operation,
    create_spam_vector); 'standard' effects are the computational basis,
    labelled by bit strings.  The SPAM types follow `gate_type` when
    'auto' ('TP' gates get 'full TP' SPAM)."""
    from pygsti_tpu_torch.models.explicitmodel import ExplicitOpModel
    qlbls = state_space_qubits(state_space)
    nq = len(qlbls)
    basis_obj = Basis.cast(basis, 4 ** nq)
    if prep_type == 'auto':
        prep_type = 'full TP' if gate_type in ('full TP', 'TP') else gate_type
    if povm_type == 'auto':
        povm_type = 'full TP' if gate_type in ('full TP', 'TP') else gate_type
    mdl = ExplicitOpModel(4 ** nq, basis_obj, gate_type, prep_type, povm_type)
    for plbl, pexpr in zip(prep_labels, prep_expressions):
        mdl.preps[Label(plbl)] = _make_prep(create_spam_vector(pexpr, qlbls, basis_obj),
                                            prep_type, basis_obj, nq)
    if effect_labels == 'standard':
        effect_labels = [format(i, '0%db' % nq) for i in range(2 ** nq)]
        effect_expressions = [str(i) for i in range(2 ** nq)]
    effects = collections.OrderedDict(
        (elbl, create_spam_vector(eexpr, qlbls, basis_obj))
        for elbl, eexpr in zip(effect_labels, effect_expressions))
    for povm_lbl in ((povm_labels,) if isinstance(povm_labels, str) else povm_labels):
        mdl.povms[Label(povm_lbl)] = _make_povm(effects, povm_type, basis_obj, nq)
    for olbl, oexpr in zip(op_labels, op_expressions):
        mdl.operations[Label(olbl)] = _make_op(create_operation(oexpr, qlbls, basis_obj),
                                               gate_type, basis_obj)
    return mdl


def create_identity_vec(basis):
    """The identity superket in `basis` (a Basis)."""
    b = Basis.cast(basis, None)
    udim = int(round(np.sqrt(b.dim)))
    return np.real(np.asarray(stdmx_to_vec(np.eye(udim).astype(complex), b))).ravel()


def create_explicit_alias_model(mdl_primitives, alias_dict):
    """A copy of `mdl_primitives` whose operations are {alias label: the
    product of the primitive operations of a Circuit}, each a full
    operation; the SPAM is copied unchanged."""
    mdl_new = mdl_primitives.copy()
    mdl_new.operations.clear()
    mdl_new._derived_layers.clear()
    for alias_lbl, circuit in alias_dict.items():
        mx = np.eye(mdl_primitives.dim)
        for layer in circuit.layertup:
            mx = mdl_primitives.operations[layer].dense() @ mx
        mdl_new.operations[alias_lbl] = _op.FullArbitraryOp(mx)
    mdl_new._mark_for_rebuild()
    return mdl_new
