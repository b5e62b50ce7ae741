"""Leakage models: a qubit gate set embedded in a 3-level (qutrit) space,
host numpy (counterpart of pygsti_tpu/leakage/models.py).

The third level stands for leakage: each gate acts as its 2-level unitary
on the computational levels and as the identity on level 2.  The models'
superoperators are in the Gell-Mann ('gm') basis of the 9-dimensional
operator space.
"""

from __future__ import annotations

import collections

import numpy as np

from pygsti_tpu_torch.baseobjs.basis import Basis
from pygsti_tpu_torch.baseobjs.label import Label
from pygsti_tpu_torch.models.explicitmodel import ExplicitOpModel
from pygsti_tpu_torch.modelmembers import operations as _op
from pygsti_tpu_torch.modelmembers import povms as _pv
from pygsti_tpu_torch.modelmembers import states as _st
from pygsti_tpu_torch.tools import optools as _ot
from pygsti_tpu_torch.tools.basistools import stdmx_to_vec


def to_3level_unitary(u_2level):
    """A 2 x 2 unitary embedded in the 3-level space (a 4 x 4 two-qubit one
    in two qutrits' 9 levels), the identity on the leakage levels."""
    u = np.asarray(u_2level, dtype=complex)
    if u.shape == (2, 2):
        out = np.eye(3, dtype=complex)
        out[:2, :2] = u
        return out
    if u.shape == (4, 4):
        out = np.eye(9, dtype=complex)
        idx = [0, 1, 3, 4]  # |00>, |01>, |10>, |11> among two qutrits' levels
        for a, ia in enumerate(idx):
            for b, ib in enumerate(idx):
                out[ia, ib] = u[a, b]
        return out
    raise ValueError("Unsupported unitary shape %s" % (u.shape,))


def _make_op(gate_type, mx):
    if gate_type == 'static':
        return _op.StaticArbitraryOp(mx)
    if gate_type in ('full TP', 'TP'):
        return _op.FullTPOp(mx)
    return _op.FullArbitraryOp(mx)


def create_3level_model(model_2level, gate_type='full', basis='gm', leakage_in_povm='1'):
    """A 1-qubit model lifted to 3 levels: each gate the 3-level embedding
    of its 2-level unitary; the prep |0><0| (a full state, static for
    gate_type 'static'); the POVM unconstrained, level 2 counted in outcome
    '1' (leakage_in_povm='1') or in an outcome '2' of its own ('separate'),
    as in the JAX package."""
    b = Basis.cast(basis, 9)
    mdl = ExplicitOpModel(9, b, default_gate_type=gate_type)
    for lbl, op in model_2level.operations.items():
        u2 = _ot.superop_to_unitary(op.dense(), model_2level.basis, check=False)
        mx = np.real(_ot.unitary_to_superop(to_3level_unitary(u2), b))
        mdl.operations[lbl] = _make_op(gate_type, mx)

    def level(*ks):
        m = np.zeros((3, 3), dtype=complex)
        for k in ks:
            m[k, k] = 1.0
        return np.real(stdmx_to_vec(m, b))

    rho_vec = level(0)
    mdl.preps[Label('rho0')] = _st.FullState(rho_vec) if gate_type.startswith('full') \
        else _st.StaticState(rho_vec)
    effects = collections.OrderedDict()
    if leakage_in_povm == '1':
        effects['0'], effects['1'] = level(0), level(1, 2)
    elif leakage_in_povm == 'separate':
        effects['0'], effects['1'], effects['2'] = level(0), level(1), level(2)
    else:
        raise ValueError("leakage_in_povm must be '1' or 'separate'")
    mdl.povms[Label('Mdefault')] = _pv.UnconstrainedPOVM(effects)
    return mdl


create_leakage_model = create_3level_model
