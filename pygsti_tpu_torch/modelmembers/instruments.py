"""Instruments (mid-circuit measurements): named collections of maps that
sum to a trace-preserving map (counterpart of
pygsti_tpu/modelmembers/instruments.py).

An instrument's dense form is the stack of its members' superoperators,
``[n_members, d, d]``.  A model lays each member into its op stack as the
pseudo-operation ``('INSTRUMENT', label, member)``, and a layout expands
every circuit that holds an instrument into one row per combination of
members.

Neither class supports a gauge transform: as in the JAX package, trying
one raises NotImplementedError.  Both serialize (the JAX package writes no
instruments, so the state layout is the port's own).
"""

from __future__ import annotations

import numpy as np
import torch

from pygsti_tpu_torch.baseobjs.nicelyserializable import NicelySerializable
from pygsti_tpu_torch.modelmembers.modelmember import ModelMember
from pygsti_tpu_torch.modelmembers.operations import (FullArbitraryOp, FullTPOp,
                                                      StaticArbitraryOp)


def _items(member_ops):
    return list(member_ops.items() if isinstance(member_ops, dict) else member_ops)


class Instrument(ModelMember):
    """An instrument: ordered members (operations), one per outcome.
    Raw matrices become static members."""

    def __init__(self, member_ops):
        items = _items(member_ops)
        self.member_labels = [str(k) for k, _ in items]
        self.members = [v if isinstance(v, ModelMember) else StaticArbitraryOp(v)
                        for _, v in items]
        self._dim = self.members[0].dim
        super().__init__(np.empty(0))

    @property
    def num_members(self):
        return len(self.member_labels)

    @property
    def num_params(self):
        return sum(m.num_params for m in self.members)

    def to_vector(self):
        return np.concatenate([m.to_vector() for m in self.members] + [np.empty(0)])

    def from_vector(self, v):
        off = 0
        for m in self.members:
            m.from_vector(v[off:off + m.num_params])
            off += m.num_params

    def to_dense(self, v):
        """The member stack [n_members, d, d] of parameters v."""
        mats, off = [], 0
        for m in self.members:
            mats.append(m.to_dense(v[off:off + m.num_params]))
            off += m.num_params
        return torch.stack(mats)

    def keys(self):
        return list(self.member_labels)

    def items(self):
        return list(zip(self.member_labels, self.members))

    def __getitem__(self, lbl):
        return self.members[self.member_labels.index(str(lbl))]

    def __len__(self):
        return len(self.member_labels)

    def _to_nice_serialization(self):
        return {'member_labels': list(self.member_labels),
                'members': [m.to_nice_serialization() for m in self.members]}

    @classmethod
    def _from_nice_serialization(cls, state):
        return cls(list(zip(state['member_labels'],
                            [NicelySerializable.from_nice_serialization(s)
                             for s in state['members']])))


class TPInstrument(Instrument):
    """An instrument whose members sum to a trace-preserving map for every
    parameter value.  The total map is a FullTPOp, members 1..n-1 are fully
    parameterized, and member 0 is the total less the others.  Parameters:
    the total's, then each free member's."""

    def __init__(self, member_ops):
        items = _items(member_ops)
        labels = [str(k) for k, _ in items]
        dense = [np.asarray(v.dense() if isinstance(v, ModelMember) else v, dtype=float)
                 for _, v in items]
        total = np.sum(dense, axis=0)
        if not np.allclose(total[0], np.eye(total.shape[0])[0], atol=1e-6):
            raise ValueError("TPInstrument members must sum to a TP map")
        self._set_parts(labels, total, dense[1:])

    def _set_parts(self, labels, total, free):
        self.member_labels = list(labels)
        self._total_op = FullTPOp(total)
        self._free_members = [FullArbitraryOp(m) for m in free]
        self._dim = self._total_op.dim
        ModelMember.__init__(self, np.empty(0))

    @property
    def members(self):
        """Each member as a static operation at the current values."""
        return [StaticArbitraryOp(m) for m in self.dense()]

    @property
    def num_params(self):
        return self._total_op.num_params + sum(m.num_params for m in self._free_members)

    def to_vector(self):
        return np.concatenate([self._total_op.to_vector()]
                              + [m.to_vector() for m in self._free_members])

    def from_vector(self, v):
        off = self._total_op.num_params
        self._total_op.from_vector(v[:off])
        for m in self._free_members:
            m.from_vector(v[off:off + m.num_params])
            off += m.num_params

    def to_dense(self, v):
        off = self._total_op.num_params
        total = self._total_op.to_dense(v[:off])
        mats = []
        for m in self._free_members:
            mats.append(m.to_dense(v[off:off + m.num_params]))
            off += m.num_params
        m0 = total - torch.stack(mats).sum(dim=0) if mats else total
        return torch.stack([m0] + mats)

    def __getitem__(self, lbl):
        return self.members[self.member_labels.index(str(lbl))]

    def _to_nice_serialization(self):
        # the total and the free members, so that a state reads back to the
        # same parameters bit for bit (summing the members again would not)
        return {'member_labels': list(self.member_labels), 'total': self._total_op.dense(),
                'free_members': [m.dense() for m in self._free_members]}

    @classmethod
    def _from_nice_serialization(cls, state):
        inst = cls.__new__(cls)
        inst._set_parts(state['member_labels'], np.asarray(state['total']),
                        [np.asarray(m) for m in state['free_members']])
        return inst
