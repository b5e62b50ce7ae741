"""Legacy model pack: the 24 single-qubit Clifford gates Gc0-Gc23
(counterpart of pygsti_tpu/modelpacks/legacy/std1Q_Cliffords.py)."""

from __future__ import annotations

import collections

import numpy as np

description = "The 1-qubit Clifford group"

gates = ['Gc%d' % i for i in range(24)]


def target_model(parameterization_type="full", sim_type="auto"):
    """The model of all 24 one-qubit Clifford gates, prep |0>, Z measurement."""
    from pygsti_tpu_torch.baseobjs.basis import Basis
    from pygsti_tpu_torch.baseobjs.label import Label
    from pygsti_tpu_torch.models.explicitmodel import ExplicitOpModel
    from pygsti_tpu_torch.models.modelconstruction import _make_op, _make_povm, _make_prep
    from pygsti_tpu_torch.tools.internalgates import standard_gatename_unitaries
    from pygsti_tpu_torch.tools.optools import unitary_to_superop

    std = standard_gatename_unitaries()
    basis = Basis('pp', 4)
    gtype = parameterization_type
    ptype = 'full TP' if gtype in ('full TP', 'TP') else gtype
    mdl = ExplicitOpModel(4, basis, gtype, ptype, ptype)
    mdl.preps[Label('rho0')] = _make_prep(np.array([1, 0, 0, 1.0]) / np.sqrt(2), ptype, basis, 1)
    mdl.povms[Label('Mdefault')] = _make_povm(collections.OrderedDict(
        [('0', np.array([1, 0, 0, 1.0]) / np.sqrt(2)),
         ('1', np.array([1, 0, 0, -1.0]) / np.sqrt(2))]), ptype, basis, 1)
    for i in range(24):
        mdl.operations[Label('Gc%d' % i)] = _make_op(
            np.real(unitary_to_superop(std['Gc%d' % i], basis)), gtype, basis)
    return mdl


def processor_spec():
    return target_model('static').create_processor_spec(('Q0',))


clifford_compilation = collections.OrderedDict([('Gc%d' % i, ['Gc%d' % i]) for i in range(24)])
