"""Operator bases: 'std' (matrix units) and 'pp' (Pauli products), host numpy
(counterpart of pygsti_tpu/baseobjs/basis.py and basisconstructors.py).

A vector in basis B has components x_i = Tr(B_i^dag rho); the 'std' basis
vectorization is the row-major flattening of rho.
"""

from __future__ import annotations

import functools
import itertools

import numpy as np

_PAULIS = (np.eye(2, dtype=complex),
           np.array([[0, 1], [1, 0]], dtype=complex),
           np.array([[0, -1j], [1j, 0]], dtype=complex),
           np.array([[1, 0], [0, -1]], dtype=complex))


@functools.lru_cache(maxsize=None)
def std_matrices(matrix_dim):
    """Matrix-unit basis E_ij of d x d matrices, ordered row-major."""
    d = matrix_dim
    mxs = np.zeros((d * d, d, d), dtype=complex)
    for k, (i, j) in enumerate(itertools.product(range(d), range(d))):
        mxs[k, i, j] = 1.0
    mxs.flags.writeable = False
    return mxs


@functools.lru_cache(maxsize=None)
def pp_matrices(matrix_dim):
    """Normalized Pauli-product basis for d = 2**n: tensor products of
    {I,X,Y,Z}/sqrt(2) with the first qubit's factor varying slowest."""
    d = matrix_dim
    nq = int(round(np.log2(d)))
    if 2 ** nq != d:
        raise ValueError("Pauli-product basis requires a power-of-2 dimension, "
                         "got %d" % d)
    basis1q = [p / np.sqrt(2.0) for p in _PAULIS]
    mxs = np.empty((4 ** nq, d, d), dtype=complex)
    for k, factors in enumerate(itertools.product(basis1q, repeat=nq)):
        m = np.ones((1, 1), dtype=complex)
        for f in factors:
            m = np.kron(m, f)
        mxs[k] = m
    mxs.flags.writeable = False
    return mxs


def std_labels(matrix_dim):
    """Labels "(i,j)" of the matrix units, row-major."""
    d = matrix_dim
    return ["(%d,%d)" % (i, j) for i in range(d) for j in range(d)]


def pp_labels(matrix_dim):
    """Pauli strings over 'IXYZ', the first qubit's letter varying slowest."""
    nq = int(round(np.log2(matrix_dim)))
    if nq == 0:
        return [""]
    return ["".join(t) for t in itertools.product('IXYZ', repeat=nq)]


_BUILTIN = {'std': std_matrices, 'pp': pp_matrices}
_LABELS = {'std': std_labels, 'pp': pp_labels}


class Basis(object):
    """A builtin basis ('std' or 'pp') of d x d matrices; ``dim`` = d**2."""

    @classmethod
    def cast(cls, name_or_basis, dim):
        if isinstance(name_or_basis, Basis):
            return name_or_basis
        return cls(name_or_basis, dim)

    def __init__(self, name, dim):
        if name not in _BUILTIN:
            raise ValueError("Unknown basis %r (known: %s)" % (name, list(_BUILTIN)))
        d = int(round(np.sqrt(dim)))
        if d * d != dim:
            raise ValueError("Basis dim must be a perfect square, got %d" % dim)
        self.name = name
        self.dim = int(dim)
        self.matrix_dim = d

    @property
    def elements(self):
        """ndarray [d**2, d, d] of basis elements."""
        return _BUILTIN[self.name](self.matrix_dim)

    @property
    def labels(self):
        """One string per basis element, in the order of ``elements``."""
        return _LABELS[self.name](self.matrix_dim)

    @property
    def real(self):
        els = self.elements
        return bool(np.allclose(els, els.conj().transpose(0, 2, 1)))

    def create_transform_matrix(self, to_basis):
        """Matrix M such that x_to = M @ x_from (this basis)."""
        to_basis = Basis.cast(to_basis, self.dim)
        n, d, _ = self.elements.shape
        fro = self.elements.reshape(n, d * d).T          # std <- self
        to_dual = to_basis.elements.reshape(n, d * d).conj()
        return to_dual @ fro

    def __repr__(self):
        return "%s basis (dim=%d)" % (self.name, self.dim)
