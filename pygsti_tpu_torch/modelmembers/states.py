"""State preparations as pure torch functions (counterpart of
pygsti_tpu/modelmembers/states.py: StaticState, FullState, TPState, each
with its gauge transform and serialization; ComputationalBasisState and
ComposedState, which serialize and, as in the JAX package, have no gauge
transform)."""

from __future__ import annotations

import numpy as np
import torch

from pygsti_tpu_torch.baseobjs.basis import Basis
from pygsti_tpu_torch.baseobjs.nicelyserializable import NicelySerializable
from pygsti_tpu_torch.modelmembers.modelmember import ModelMember
from pygsti_tpu_torch.modelmembers.operations import _WrapsOneMember
from pygsti_tpu_torch.tools.basistools import stdmx_to_vec


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


class ComputationalBasisState(State):
    """The computational basis state |z_1 ... z_n> of n qubits, 0 parameters."""

    def __init__(self, zvals, basis='pp'):
        self.zvals = tuple(int(z) for z in zvals)
        udim = 2 ** len(self.zvals)
        self.basis = Basis.cast(basis, udim * udim).name
        idx = int("".join(str(z) for z in self.zvals), 2) if self.zvals else 0
        rho = np.zeros((udim, udim), dtype=complex)
        rho[idx, idx] = 1.0
        vec = np.real(stdmx_to_vec(rho, self.basis))
        super().__init__(len(vec), np.empty(0))
        self._vec = vec

    def to_dense(self, v):
        return torch.as_tensor(self._vec, dtype=v.dtype, device=v.device)

    def dense(self):
        return self._vec.copy()

    def to_statevec(self, v):
        """The state vector |z>, on v's device."""
        psi = torch.zeros(2 ** len(self.zvals), device=v.device,
                          dtype=torch.complex128 if v.dtype == torch.float64 else torch.complex64)
        psi[int("".join(str(z) for z in self.zvals), 2) if self.zvals else 0] = 1.0
        return psi

    def _to_nice_serialization(self):
        return {'zvals': list(self.zvals), 'basis': self.basis}

    @classmethod
    def _from_nice_serialization(cls, state):
        # the JAX package writes no basis and reads its states back in 'pp'
        return cls(state['zvals'], state.get('basis', 'pp'))


class ComposedState(_WrapsOneMember, State):
    """An error map applied to a static base state: vec = M_err @ base.  Its
    parameters are the error map's."""

    def __init__(self, static_state, errormap):
        self.state_vec = static_state
        self.error_map = self._inner = errormap
        super().__init__(static_state.dim, np.empty(0))

    def to_dense(self, v):
        return self.error_map.to_dense(v) @ self.state_vec.to_dense(v[:0])

    def error_map_form(self):
        if self.state_vec.num_params or not hasattr(self.error_map, 'same_function_as'):
            return None
        return self.error_map, self.state_vec.dense(), None

    def _to_nice_serialization(self):
        return {'state_vec': self.state_vec.to_nice_serialization(),
                'error_map': self.error_map.to_nice_serialization()}

    @classmethod
    def _from_nice_serialization(cls, state):
        return cls(NicelySerializable.from_nice_serialization(state['state_vec']),
                   NicelySerializable.from_nice_serialization(state['error_map']))
