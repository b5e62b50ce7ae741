"""POVMs as pure torch functions (counterpart of
pygsti_tpu/modelmembers/povms.py: UnconstrainedPOVM, TPPOVM, each with its
gauge transform and serialization).  A POVM's dense rep is the stack of its
effect vectors [n_outcomes, dim]."""

from __future__ import annotations

import collections

import numpy as np
import torch

from pygsti_tpu_torch.modelmembers.modelmember import ModelMember


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
