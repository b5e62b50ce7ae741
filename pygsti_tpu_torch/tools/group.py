"""Finite matrix groups (reference: pygsti/tools/group.py)."""

from __future__ import annotations

import numpy as np


class MatrixGroup(object):
    """A closed set of matrices with group lookups (reference:
    group.MatrixGroup:48)."""

    def __init__(self, list_of_matrices, labels=None):
        self.mxs = [np.asarray(m) for m in list_of_matrices]
        self.labels = list(labels) if labels is not None \
            else list(range(len(self.mxs)))
        self._index = {self._key(m): i for i, m in enumerate(self.mxs)}
        n = len(self.mxs)
        self._prod = np.full((n, n), -1, dtype=int)
        self._inv = np.full(n, -1, dtype=int)
        for i, a in enumerate(self.mxs):
            for j, b in enumerate(self.mxs):
                k = self._index.get(self._key(a @ b))
                assert k is not None, "Input matrices do not form a group"
                self._prod[i, j] = k
                if k == self._index[self._key(np.eye(a.shape[0]))]:
                    self._inv[i] = j

    @staticmethod
    def _key(m):
        return tuple(np.round(np.asarray(m), 9).ravel())

    def __len__(self):
        return len(self.mxs)

    def matrix(self, i):
        return self.mxs[self.label_indices([i])[0] if not isinstance(i, (int, np.integer)) else i]

    def label_indices(self, labels):
        lookup = {l: i for i, l in enumerate(self.labels)}
        return [lookup[l] for l in labels]

    def product(self, indices):
        """Group index of the ordered product of element indices."""
        out = None
        for i in indices:
            out = i if out is None else self._prod[out, i]
        return out

    def inverse_index(self, i):
        return int(self._inv[i])

    def matrix_index(self, mx):
        return self._index[self._key(mx)]


def construct_1q_clifford_group():
    """The 24-element single-qubit Clifford group as pp-superoperators
    (reference: group.construct_1q_clifford_group:35)."""
    from pygsti_tpu_torch.tools.optools import unitary_to_superop
    s_u = np.array([[1, 0], [0, 1j]], dtype=complex)
    h_u = np.array([[1, 1], [1, -1]], dtype=complex) / np.sqrt(2)
    gens = [np.real(unitary_to_superop(h_u, 'pp')),
            np.real(unitary_to_superop(s_u, 'pp'))]
    # closure in superoperator space (phase-free, so exactly 24 elements)
    def key(m):
        return tuple(np.round(m, 8).ravel())
    elems = {key(np.eye(4)): np.eye(4)}
    frontier = [np.eye(4)]
    while frontier:
        new = []
        for m in frontier:
            for g in gens:
                v = g @ m
                k = key(v)
                if k not in elems:
                    elems[k] = v
                    new.append(v)
        frontier = new
    assert len(elems) == 24, \
        "1Q Clifford group should have 24 elements, got %d" % len(elems)
    return MatrixGroup(list(elems.values()), labels=list(range(24)))


def is_integer(x):
    """Whether `x` is an integer type (reference: group.is_integer:18)."""
    import numbers
    import numpy as _np
    return isinstance(x, (int, _np.integer)) \
        or (isinstance(x, numbers.Integral) and not isinstance(x, bool))
