"""Operator bases: 'std' (matrix units), 'pp' (Pauli products), 'gm'
(generalized Gell-Mann) and 'qt' (the qutrit basis), host numpy
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


@functools.lru_cache(maxsize=None)
def gm_matrices(matrix_dim):
    """Normalized generalized Gell-Mann basis of d x d matrices: the
    identity, then the symmetric (X-like) off-diagonal elements in
    row-major upper-triangle order, the antisymmetric (Y-like) ones in the
    same order, then the diagonal (Z-like) ones; each of unit Frobenius
    norm."""
    d = matrix_dim
    mxs = [np.identity(d, dtype=complex)]
    pairs = [(i, j) for i in range(d) for j in range(i + 1, d)]
    for i, j in pairs:
        xm = np.zeros((d, d), dtype=complex)
        xm[i, j] = xm[j, i] = 1.0
        mxs.append(xm)
    for i, j in pairs:
        ym = np.zeros((d, d), dtype=complex)
        ym[i, j], ym[j, i] = -1j, 1j
        mxs.append(ym)
    for k in range(1, d):
        zm = np.zeros((d, d), dtype=complex)
        zm[np.arange(k), np.arange(k)] = 1.0
        zm[k, k] = -k
        mxs.append(zm * np.sqrt(2.0 / (k * (k + 1))))
    arr = np.stack(mxs)
    for k in range(arr.shape[0]):
        nrm = np.sqrt(np.real(np.trace(arr[k].conj().T @ arr[k])))
        if nrm > 1e-12:
            arr[k] /= nrm
    arr.flags.writeable = False
    return arr


def gm_labels(matrix_dim):
    d = matrix_dim
    pairs = [(i, j) for i in range(d) for j in range(i + 1, d)]
    return (["I"] + ["X_{%d,%d}" % p for p in pairs] + ["Y_{%d,%d}" % p for p in pairs]
            + ["Z_{%d}" % k for k in range(1, d)])


@functools.lru_cache(maxsize=None)
def qt_matrices(matrix_dim):
    """The qutrit basis (d = 3): two-qubit Pauli products projected onto the
    symmetric (triplet) subspace |00>, (|01>+|10>)/sqrt2, |11>, then
    orthonormalized so that Tr(B_i B_j) = delta_ij."""
    if matrix_dim == 1:
        return np.identity(1, 'd')[None, :, :]
    if matrix_dim != 3:
        raise ValueError("qt basis requires dimension 3")
    s2 = np.sqrt(2.0)
    proj = np.array([[1, 0, 0, 0], [0, 1 / s2, 1 / s2, 0], [0, 0, 0, 1]], 'd')
    pp = pp_matrices(4)
    # pp indices of II, XX, YY, YZ, IX, IY, IZ, XY, XZ
    mxs = [proj @ pp[i] @ proj.T for i in (0, 5, 10, 11, 1, 2, 3, 6, 7)]
    mxs[0] = mxs[0] / np.sqrt(0.75)
    q1 = mxs[1] - mxs[0] * np.sqrt(0.75) / 3
    q2 = mxs[2] - mxs[0] * np.sqrt(0.75) / 3
    mxs[1] = (q1 + q2) / np.sqrt(2.0 / 3.0)
    mxs[2] = (q1 - q2) / s2
    for i in range(3, 9):
        mxs[i] = mxs[i] / np.sqrt(0.5)
    out = np.array(mxs)
    out.flags.writeable = False
    return out


def qt_labels(matrix_dim):
    if matrix_dim == 1:
        return ['']
    return ['II', 'X+Y', 'X-Y', 'YZ', 'IX', 'IY', 'IZ', 'XY', 'XZ']


_BUILTIN = {'std': std_matrices, 'pp': pp_matrices, 'gm': gm_matrices, 'qt': qt_matrices}
_LABELS = {'std': std_labels, 'pp': pp_labels, 'gm': gm_labels, 'qt': qt_labels}


class Basis(object):
    """A builtin basis ('std', 'pp', 'gm' or 'qt') of d x d matrices;
    ``dim`` = d**2."""

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
