"""Member construction by parameterization name (counterpart of
pygsti_tpu/models/modelconstruction.py: _make_op, _make_prep, _make_povm, for
the 'static', 'full' and 'full TP' families; the Lindblad and unitary
families are not ported yet)."""

from __future__ import annotations

import numpy as np

from pygsti_tpu_torch.modelmembers import operations as _op
from pygsti_tpu_torch.modelmembers import states as _st
from pygsti_tpu_torch.modelmembers import povms as _pv
from pygsti_tpu_torch.tools.basistools import stdmx_to_vec

_NOT_PORTED = ('static', 'static unitary', 'static standard', 'full unitary', 'computational',
               'static pure', 'CPTP', 'CPTPLND', 'GLND', 'H+S', 'H+s', 'H')


def _unknown(kind, name):
    if name in _NOT_PORTED:
        return ValueError("Unknown %s type %r (not ported yet)" % (kind, name))
    return ValueError("Unknown %s type %r" % (kind, name))


def _make_op(ideal_mx, gate_type, basis):
    if gate_type in ('static', 'static arbitrary'):
        return _op.StaticArbitraryOp(ideal_mx)
    if gate_type in ('full', 'full arbitrary'):
        return _op.FullArbitraryOp(ideal_mx)
    if gate_type in ('full TP', 'TP'):
        return _op.FullTPOp(ideal_mx)
    raise _unknown('gate', gate_type)


def _make_prep(ideal_vec, prep_type, basis, nqubits=None):
    if prep_type == 'static':
        # the JAX package's 'static' prep is the computational |0...0> state
        if nqubits is None:
            raise ValueError("prep type %r requires a qubit state space" % prep_type)
        rho = np.zeros((2 ** nqubits, 2 ** nqubits), dtype=complex)
        rho[0, 0] = 1.0
        return _st.StaticState(np.real(stdmx_to_vec(rho, basis)))
    if prep_type in ('full', 'full arbitrary'):
        return _st.FullState(ideal_vec)
    if prep_type in ('full TP', 'TP'):
        return _st.TPState(ideal_vec)
    raise _unknown('prep', prep_type)


def _make_povm(ideal_effects, povm_type, basis, nqubits=None):
    if povm_type in ('full', 'full arbitrary'):
        return _pv.UnconstrainedPOVM(ideal_effects)
    if povm_type in ('full TP', 'TP'):
        return _pv.TPPOVM(ideal_effects)
    raise _unknown('povm', povm_type)
