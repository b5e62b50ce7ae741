"""POVMs as pure torch functions (counterpart of
pygsti_tpu/modelmembers/povms.py: UnconstrainedPOVM, TPPOVM, each with its
gauge transform and serialization; ComputationalBasisPOVM, ComposedPOVM and
MarginalizedPOVM, which serialize and, as in the JAX package, have no gauge
transform).  A
POVM's dense rep is the stack of its effect vectors [n_outcomes, dim]."""

from __future__ import annotations

import collections
import math

import numpy as np
import torch

from pygsti_tpu_torch.baseobjs.basis import Basis
from pygsti_tpu_torch.baseobjs.nicelyserializable import NicelySerializable
from pygsti_tpu_torch.modelmembers.modelmember import ModelMember
from pygsti_tpu_torch.modelmembers.operations import _WrapsOneMember
from pygsti_tpu_torch.tools.basistools import stdmx_to_vec


def _effect_items(effect_dict):
    items = effect_dict.items() if isinstance(effect_dict, dict) else effect_dict
    return [(str(k), np.asarray(v, dtype=float).reshape(-1)) for k, v in items]


class POVM(ModelMember):
    """Base POVM: ordered outcome labels + effect stack."""

    def __init__(self, dim, outcome_labels, initial_paramvals=None):
        super().__init__(initial_paramvals)
        self._dim = dim
        self._outcome_labels = [str(o) for o in outcome_labels]

    @property
    def outcome_labels(self):
        return list(self._outcome_labels)

    @property
    def num_outcomes(self):
        return len(self._outcome_labels)

    def items(self):
        """[(outcome label, dense effect vector)] at the current values."""
        return list(zip(self._outcome_labels, self.dense()))

    def _to_nice_serialization(self):
        return {'effects': [[ol, ev] for ol, ev in self.items()]}

    @classmethod
    def _from_nice_serialization(cls, state):
        return cls(collections.OrderedDict(
            (ol, np.asarray(ev)) for ol, ev in state['effects']))


class UnconstrainedPOVM(POVM):
    """Every effect fully parameterized."""

    def __init__(self, effect_dict):
        items = _effect_items(effect_dict)
        super().__init__(len(items[0][1]), [k for k, _ in items],
                         np.concatenate([v for _, v in items]))

    def to_dense(self, v):
        return v.reshape(self.num_outcomes, self._dim)

    def transform_inplace(self, s, sinv):
        dense = self._paramvals.reshape(self.num_outcomes, self._dim)
        self._paramvals = (dense @ s).reshape(-1)


class TPPOVM(POVM):
    """Trace-preserving POVM: the last effect is the identity vector minus
    the others."""

    def __init__(self, effect_dict):
        items = _effect_items(effect_dict)
        dim = len(items[0][1])
        self._identity_vec = np.zeros(dim)
        self._identity_vec[0] = np.sqrt(int(round(np.sqrt(dim))))
        if not np.allclose(np.sum([v for _, v in items], axis=0),
                           self._identity_vec, atol=1e-6):
            raise ValueError("TPPOVM effects must sum to the identity")
        pv = np.concatenate([v for _, v in items[:-1]]) if len(items) > 1 \
            else np.empty(0)
        super().__init__(dim, [k for k, _ in items], pv)

    def to_dense(self, v):
        free = v.reshape(self.num_outcomes - 1, self._dim)
        ident = torch.as_tensor(self._identity_vec, dtype=v.dtype, device=v.device)
        last = ident - free.sum(dim=0)
        return torch.cat([free, last[None, :]], dim=0)

    def transform_inplace(self, s, sinv):
        # only the free effects move; the last stays identity minus their
        # sum, which is right for the groups that fix the identity vector
        # (TP, unitary, TP-spam), as in the JAX package
        free = self._paramvals.reshape(self.num_outcomes - 1, self._dim) @ s
        self._paramvals = free.reshape(-1)


class ComputationalBasisPOVM(POVM):
    """Z-basis measurement of n qubits, 0 parameters; outcomes '0..0' to
    '1..1' in binary order."""

    def __init__(self, nqubits, basis='pp'):
        self.nqubits = nqubits
        udim = 2 ** nqubits
        self.basis = Basis.cast(basis, udim * udim).name
        effects = np.empty((udim, udim * udim))
        for i in range(udim):
            e = np.zeros((udim, udim), dtype=complex)
            e[i, i] = 1.0
            effects[i] = np.real(stdmx_to_vec(e, self.basis))
        super().__init__(udim * udim, [format(i, '0%db' % nqubits) for i in range(udim)],
                         np.empty(0))
        self._effects = effects

    def to_dense(self, v):
        return torch.as_tensor(self._effects, dtype=v.dtype, device=v.device)

    def dense(self):
        return self._effects.copy()

    def _to_nice_serialization(self):
        return {'nqubits': self.nqubits, 'basis': self.basis}

    @classmethod
    def _from_nice_serialization(cls, state):
        # the JAX package writes no basis and reads its states back in 'pp'
        return cls(state['nqubits'], state.get('basis', 'pp'))


class ComposedPOVM(_WrapsOneMember, POVM):
    """An error map acting before a base POVM: the error map is applied to
    the state, then the base POVM measures, so effects' = base_effects @
    M_err (the map stands on the right of the effect rows).  Its parameters
    are the error map's."""

    def __init__(self, errormap, povm=None, mx_basis='pp'):
        if povm is None:
            povm = ComputationalBasisPOVM(
                int(round(math.log(math.sqrt(errormap.dim), 2))), mx_basis)
        self.base_povm = povm
        self.error_map = self._inner = errormap
        super().__init__(povm.dim, povm.outcome_labels, np.empty(0))

    def to_dense(self, v):
        return self.base_povm.to_dense(v[:0]) @ self.error_map.to_dense(v)

    def error_map_form(self):
        if self.base_povm.num_params or not hasattr(self.error_map, 'same_function_as'):
            return None
        return self.error_map, None, self.base_povm.dense()

    def _to_nice_serialization(self):
        return {'error_map': self.error_map.to_nice_serialization(),
                'base_povm': self.base_povm.to_nice_serialization()}

    @classmethod
    def _from_nice_serialization(cls, state):
        return cls(NicelySerializable.from_nice_serialization(state['error_map']),
                   NicelySerializable.from_nice_serialization(state['base_povm']))


class MarginalizedPOVM(POVM):
    """A POVM marginalized onto some of its qubits: each kept outcome's
    effect is the sum of the base effects whose bits on the kept qubits
    match it.  Its parameters are the base POVM's."""

    def __init__(self, povm_to_marginalize, all_sslbls, sslbls_after_marginalizing):
        self.base_povm = povm_to_marginalize
        self.all_sslbls = tuple(all_sslbls)
        self.kept = tuple(sslbls_after_marginalizing)
        kept_pos = [self.all_sslbls.index(s) for s in self.kept]
        out_labels = [format(i, '0%db' % len(self.kept)) for i in range(2 ** len(self.kept))]
        groups = collections.defaultdict(list)
        for i, ol in enumerate(self.base_povm.outcome_labels):
            groups["".join(ol[p] for p in kept_pos)].append(i)
        self._groups = [groups[ol] for ol in out_labels]
        super().__init__(self.base_povm.dim, out_labels, np.empty(0))
        # sum[k, i] = 1 where base outcome i is marginalized into outcome k
        self._sum = np.zeros((len(out_labels), self.base_povm.num_outcomes))
        for k, g in enumerate(self._groups):
            self._sum[k, g] = 1.0

    @property
    def num_params(self):
        return self.base_povm.num_params

    def to_vector(self):
        return self.base_povm.to_vector()

    def from_vector(self, v):
        self.base_povm.from_vector(v)

    def to_dense(self, v):
        S = torch.as_tensor(self._sum, dtype=v.dtype, device=v.device)
        return S @ self.base_povm.to_dense(v)

    def _to_nice_serialization(self):
        return {'base_povm': self.base_povm.to_nice_serialization(),
                'all_sslbls': list(self.all_sslbls), 'kept': list(self.kept)}

    @classmethod
    def _from_nice_serialization(cls, state):
        return cls(NicelySerializable.from_nice_serialization(state['base_povm']),
                   state['all_sslbls'], state['kept'])
