"""ProtectedArray: a numpy array wrapper with read-only elements (counterpart
of pygsti_tpu/baseobjs/protectedarray.py)."""

from __future__ import annotations

import numpy as np


class ProtectedArray(object):
    """Wraps an ndarray, raising on writes to protected indices (reference:
    protectedarray.ProtectedArray).  `protected_index_mask` is a boolean
    array (True = protected)."""

    def __init__(self, input_array, protected_index_mask=None):
        self.base = np.asarray(input_array)
        if protected_index_mask is None:
            protected_index_mask = np.zeros(self.base.shape, dtype=bool)
        self.protected_index_mask = np.asarray(protected_index_mask,
                                               dtype=bool)
        assert self.protected_index_mask.shape == self.base.shape

    @property
    def shape(self):
        return self.base.shape

    @property
    def dtype(self):
        return self.base.dtype

    def copy(self):
        return ProtectedArray(self.base.copy(),
                              self.protected_index_mask.copy())

    def __array__(self, dtype=None):
        return np.asarray(self.base, dtype=dtype)

    def __getitem__(self, key):
        sub = self.base[key]
        mask = self.protected_index_mask[key]
        if np.ndim(sub) == 0:
            return sub
        return ProtectedArray(sub, mask)

    def __setitem__(self, key, val):
        if np.any(self.protected_index_mask[key]):
            raise ValueError("Cannot set a protected array element")
        self.base[key] = val

    def __len__(self):
        return len(self.base)

    def __repr__(self):
        return "ProtectedArray(%r)" % (self.base,)

    def __eq__(self, other):
        other_base = other.base if isinstance(other, ProtectedArray) else other
        return np.array_equal(self.base, np.asarray(other_base))
