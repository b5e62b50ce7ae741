"""ModelMember base: a parameterization = static structure + pure function
(counterpart of pygsti_tpu/modelmembers/modelmember.py).

A member owns ``num_params``, its current parameter values (host numpy),
``gpindices`` (its slice of the parent model's flat vector) and
``to_dense(v)``: a pure torch function of its own parameter slice ``v`` that
returns its dense representation (superoperator, state vector or stack of
effect vectors) on ``v``'s device and dtype.  ``dense()`` evaluates it on the
host at the current values.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from pygsti_tpu_torch.baseobjs.nicelyserializable import NicelySerializable


class ModelMember(NicelySerializable):
    """Base class for operations / states / POVMs."""

    def __init__(self, initial_paramvals=None):
        self._paramvals = np.asarray(initial_paramvals, dtype=float) \
            if initial_paramvals is not None else np.empty(0)
        self.gpindices = None

    @property
    def num_params(self):
        return len(self._paramvals)

    def to_vector(self):
        return self._paramvals.copy()

    def from_vector(self, v):
        self._paramvals = np.asarray(v, dtype=float).copy()

    def to_dense(self, v):
        """Pure torch function: own-params vector -> dense tensor."""
        raise NotImplementedError()

    def dense(self):
        """Dense numpy representation at the current parameter values."""
        v = torch.as_tensor(self.to_vector(), dtype=torch.float64)
        return self.to_dense(v).numpy().copy()

    @property
    def dim(self):
        return self._dim

    def copy(self):
        return copy.deepcopy(self)

    def error_map_form(self):
        """None, or (error_map, pre, post) when this member's dense form is
        ``post @ E @ pre`` with E the dense matrix of `error_map`, a member
        that holds all of this member's parameters and has
        ``same_function_as(other)``; `pre` and `post` are host arrays or None
        (the identity).  A model evaluates error maps that are the same
        function of their parameters in one batched call."""
        return None

    def transform_inplace(self, s_matrix, s_inverse):
        """Apply a gauge transformation given as host numpy matrices
        (members that support it override)."""
        raise NotImplementedError("%s does not support gauge transforms"
                                  % type(self).__name__)
