"""State preparations as pure torch functions (counterpart of
pygsti_tpu/modelmembers/states.py: StaticState, FullState, TPState, each
with its gauge transform and serialization)."""

from __future__ import annotations

import numpy as np
import torch

from pygsti_tpu_torch.modelmembers.modelmember import ModelMember


class State(ModelMember):
    """Base: dense rep is a length-dim superket (vector in the model basis)."""

    def __init__(self, dim, initial_paramvals=None):
        super().__init__(initial_paramvals)
        self._dim = dim

    def _to_nice_serialization(self):
        return {'vec': self.dense()}

    @classmethod
    def _from_nice_serialization(cls, state):
        return cls(np.asarray(state['vec']))


class StaticState(State):
    """Fixed state vector."""

    def __init__(self, vec):
        vec = np.asarray(vec, dtype=float).reshape(-1)
        super().__init__(len(vec), np.empty(0))
        self._vec = vec

    def to_dense(self, v):
        return torch.as_tensor(self._vec, dtype=v.dtype, device=v.device)

    def dense(self):
        return self._vec.copy()

    def transform_inplace(self, s, sinv):
        self._vec = sinv @ self._vec


class FullState(State):
    """Every component is a parameter."""

    def __init__(self, vec):
        vec = np.asarray(vec, dtype=float).reshape(-1)
        super().__init__(len(vec), vec.copy())

    def to_dense(self, v):
        return v

    def transform_inplace(self, s, sinv):
        self._paramvals = sinv @ self._paramvals


class TPState(State):
    """Trace-one state: the first component is fixed at 1/sqrt(udim)
    (identity-first basis); the rest are parameters."""

    def __init__(self, vec):
        vec = np.asarray(vec, dtype=float).reshape(-1)
        d = len(vec)
        self._first = 1.0 / np.sqrt(int(round(np.sqrt(d))))
        if not np.isclose(vec[0], self._first, atol=1e-6):
            raise ValueError("TPState initial vector must have first "
                             "component 1/sqrt(udim)")
        super().__init__(d, vec[1:].copy())

    def to_dense(self, v):
        first = torch.full((1,), self._first, dtype=v.dtype, device=v.device)
        return torch.cat([first, v])

    def transform_inplace(self, s, sinv):
        new = sinv @ np.concatenate([[self._first], self._paramvals])
        assert np.isclose(new[0], self._first, atol=1e-6), "Gauge transform broke TP state"
        self._paramvals = new[1:]
