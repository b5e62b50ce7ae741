"""Model pack base (counterpart of pygsti_tpu/modelpacks/_modelpack.py).

A pack bundles a target gate set with its GST circuits (germs, prep and
measurement fiducials).  The target model is built directly from the gate
unitaries, embedded on the pack's qubits in the 'pp' basis, with operations
in the same order as the JAX package's pack, so parameter vectors line up.
"""

from __future__ import annotations

import collections

import numpy as np

from pygsti_tpu_torch.baseobjs.basis import Basis
from pygsti_tpu_torch.baseobjs.label import Label
from pygsti_tpu_torch.circuits.circuit import Circuit
from pygsti_tpu_torch.models.explicitmodel import ExplicitOpModel
from pygsti_tpu_torch.models.modelconstruction import (LINDBLAD_SPAM_TYPES, _make_op,
                                                        _make_povm, _make_prep)
from pygsti_tpu_torch.tools import optools as _ot
from pygsti_tpu_torch.tools.basistools import stdmx_to_vec
from pygsti_tpu_torch.tools.internalgates import standard_gatename_unitaries



def _spam_type(gate_type):
    """The SPAM type that goes with a gate type: 'full TP' and 'full' keep
    their family, a Lindblad type with a SPAM form is used as it is, every
    other type ('static', the unitary types, 'H') gets computational SPAM."""
    if gate_type in ('full TP', 'TP'):
        return 'full TP'
    if gate_type in ('full', 'full arbitrary'):
        return 'full'
    if gate_type in LINDBLAD_SPAM_TYPES:
        return gate_type
    return 'computational'


def _embed_unitary_superop(u, target_qubits, all_qubits):
    """'pp'-basis superop of a unitary on `target_qubits`, identity on the
    other qubits of `all_qubits`."""
    nq_gate = int(round(np.log2(u.shape[0])))
    small = np.real(_ot.unitary_to_superop(u, Basis('pp', 4 ** nq_gate)))
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


class GSTModelPack(object):
    """Base for GST model packs: subclasses set _nqubits, _gates, _germs,
    _prep_fids, _meas_fids and optionally _op_order."""

    _nqubits = 1
    _gates = []
    _germs = []
    _prep_fids = []
    _meas_fids = []
    _op_order = None   # [(gate_name, qubit-index tuple)], '' = global idle

    @classmethod
    def _op_labels(cls):
        qubits = tuple(range(cls._nqubits))
        if cls._op_order is not None:
            return [Label(()) if name == '' else Label((name,) + tuple(idx))
                    for name, idx in cls._op_order]
        std = standard_gatename_unitaries()
        out = [Label(())]
        for name in cls._gates:
            nq_gate = int(round(np.log2(std[name].shape[0])))
            if nq_gate == cls._nqubits and cls._nqubits > 1:
                out.append(Label(name, qubits))
            elif nq_gate == 1:
                out.extend(Label(name, (q,)) for q in qubits)
            else:
                raise ValueError("no availability rule for %s" % name)
        return out

    @classmethod
    def target_model(cls, gate_type='full'):
        """The ideal model with every member of type `gate_type` ('static',
        'full', 'full TP', 'static unitary', 'full unitary', 'CPTPLND',
        'GLND', 'H+S', 'H+s', 'H', ...), its SPAM following the gate type."""
        qubits = tuple(range(cls._nqubits))
        nq = cls._nqubits
        dim = 4 ** nq
        spam_type = _spam_type(gate_type)
        mdl = ExplicitOpModel(dim, 'pp', gate_type, spam_type, spam_type)
        std = standard_gatename_unitaries()
        for lbl in cls._op_labels():
            if lbl == Label(()):
                u, targets = np.eye(2 ** cls._nqubits, dtype=complex), qubits
            else:
                u, targets = std[lbl.name], lbl.sslbls
            mdl.operations[lbl] = _make_op(_embed_unitary_superop(u, targets, qubits),
                                           gate_type, mdl.basis)
        udim = 2 ** cls._nqubits
        rho = np.zeros((udim, udim), dtype=complex)
        rho[0, 0] = 1.0
        mdl.preps[Label('rho0')] = _make_prep(np.real(stdmx_to_vec(rho, mdl.basis)),
                                              spam_type, mdl.basis, nq)
        effects = collections.OrderedDict()
        for i in range(udim):
            e = np.zeros((udim, udim), dtype=complex)
            e[i, i] = 1.0
            effects[format(i, '0%db' % cls._nqubits)] = \
                np.real(stdmx_to_vec(e, mdl.basis))
        mdl.povms[Label('Mdefault')] = _make_povm(effects, spam_type, mdl.basis, nq)
        return mdl

    @classmethod
    def germs(cls):
        return [Circuit(s) for s in cls._germs]

    @classmethod
    def prep_fiducials(cls):
        return [Circuit(s) for s in cls._prep_fids]

    @classmethod
    def meas_fiducials(cls):
        return [Circuit(s) for s in cls._meas_fids]
