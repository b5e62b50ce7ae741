"""Member construction by parameterization name (counterpart of
pygsti_tpu/models/modelconstruction.py: _make_op, _make_prep, _make_povm, for
every type the JAX package's functions take)."""

from __future__ import annotations

import numpy as np

from pygsti_tpu_torch.modelmembers import operations as _op
from pygsti_tpu_torch.modelmembers import states as _st
from pygsti_tpu_torch.modelmembers import povms as _pv
from pygsti_tpu_torch.tools import optools as _ot

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
