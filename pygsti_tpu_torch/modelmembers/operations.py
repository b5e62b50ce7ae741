"""Operation parameterizations as pure torch functions (counterpart of
pygsti_tpu/modelmembers/operations.py: the static ops, FullArbitraryOp and
FullTPOp, each with its gauge transform and serialization, and the
Hermitian-from-real-parameters map of the unitary gauge group)."""

from __future__ import annotations

import numpy as np
import torch

from pygsti_tpu_torch.modelmembers.modelmember import ModelMember
from pygsti_tpu_torch.tools import optools as _ot


class LinearOperator(ModelMember):
    """Base class for operations; dense rep is a (dim, dim) superop matrix."""

    def __init__(self, dim, initial_paramvals=None):
        super().__init__(initial_paramvals)
        self._dim = dim


class StaticArbitraryOp(LinearOperator):
    """A fixed (0-parameter) superoperator matrix."""

    def __init__(self, mx):
        mx = np.asarray(mx, dtype=float)
        super().__init__(mx.shape[0], np.empty(0))
        self._mx = mx

    def to_dense(self, v):
        return torch.as_tensor(self._mx, dtype=v.dtype, device=v.device)

    def dense(self):
        return self._mx.copy()

    def transform_inplace(self, s, sinv):
        self._mx = sinv @ self._mx @ s

    def _to_nice_serialization(self):
        return {'mx': self._mx}

    @classmethod
    def _from_nice_serialization(cls, state):
        # the static subclasses serialize as their dense matrix
        return StaticArbitraryOp(np.asarray(state['mx']))


class StaticUnitaryOp(StaticArbitraryOp):
    """A fixed superoperator built from a unitary."""

    def __init__(self, unitary, basis='pp'):
        self.unitary = np.asarray(unitary, dtype=complex)
        super().__init__(np.real(_ot.unitary_to_superop(self.unitary, basis)))


class StaticStandardOp(StaticUnitaryOp):
    """A fixed superoperator for a named standard gate."""

    def __init__(self, name, basis='pp'):
        from pygsti_tpu_torch.tools.internalgates import standard_gatename_unitaries
        self.name = name
        super().__init__(standard_gatename_unitaries()[name], basis)


class FullArbitraryOp(LinearOperator):
    """Every matrix element is a parameter (row-major)."""

    def __init__(self, mx):
        mx = np.asarray(mx, dtype=float)
        super().__init__(mx.shape[0], mx.reshape(-1).copy())

    def to_dense(self, v):
        return v.reshape(self._dim, self._dim)

    def _to_nice_serialization(self):
        return {'mx': self.dense()}

    @classmethod
    def _from_nice_serialization(cls, state):
        return cls(np.asarray(state['mx']))

    def transform_inplace(self, s, sinv):
        d = self._dim
        self._paramvals = (sinv @ self._paramvals.reshape(d, d) @ s).reshape(-1)


class FullTPOp(LinearOperator):
    """Trace-preserving superop: first row fixed to [1,0,...,0]; the other
    rows are parameters (row-major)."""

    def __init__(self, mx):
        mx = np.asarray(mx, dtype=float)
        d = mx.shape[0]
        if not np.allclose(mx[0], np.eye(d)[0], atol=1e-8):
            raise ValueError("Initial matrix is not trace-preserving "
                             "(first row != e0)")
        super().__init__(d, mx[1:, :].reshape(-1).copy())

    def to_dense(self, v):
        d = self._dim
        first_row = torch.zeros((1, d), dtype=v.dtype, device=v.device)
        first_row[0, 0] = 1.0
        return torch.cat([first_row, v.reshape(d - 1, d)], dim=0)

    def _to_nice_serialization(self):
        return {'mx': self.dense()}

    @classmethod
    def _from_nice_serialization(cls, state):
        return cls(np.asarray(state['mx']))

    def transform_inplace(self, s, sinv):
        d = self._dim
        mx = sinv @ self.dense() @ s
        assert np.allclose(mx[0], np.eye(d)[0], atol=1e-6), "Gauge transform broke TP"
        mx[0] = np.eye(d)[0]  # clean numerical noise
        self._paramvals = mx[1:, :].reshape(-1)


def _real_params_to_hermitian(v, d):
    """Real vector (d*d: the diagonal, then (re, im) of the upper triangle
    row by row) -> Hermitian complex [d, d] tensor on v's device."""
    ctype = torch.complex128 if v.dtype == torch.float64 else torch.complex64
    iu = torch.triu_indices(d, d, offset=1, device=v.device)
    upper = torch.complex(v[d::2], v[d + 1::2]).to(ctype)
    h = torch.zeros((d, d), dtype=ctype, device=v.device)
    h = h.index_put((iu[0], iu[1]), upper)
    h = h + h.conj().T
    return h + torch.diag(v[:d].to(ctype))
