"""Constructors for the builtin operator bases (std, pp, gm, qt, and the
leakage basis lf), host numpy (counterpart of
pygsti_tpu/baseobjs/basisconstructors.py).

Same element conventions as the reference (pygsti/baseobjs/basisconstructors.py):
all matrix bases are orthonormal under the trace inner product
Tr(B_i^dag B_j) = delta_ij (except 'PP', the unnormalized Pauli product basis).
"""

from __future__ import annotations

import functools
import itertools

import numpy as np

sqrt2 = np.sqrt(2.0)

id2x2 = np.array([[1, 0], [0, 1]], dtype=complex)
sigmax = np.array([[0, 1], [1, 0]], dtype=complex)
sigmay = np.array([[0, -1j], [1j, 0]], dtype=complex)
sigmaz = np.array([[1, 0], [0, -1]], dtype=complex)
_PAULIS = {'I': id2x2, 'X': sigmax, 'Y': sigmay, 'Z': sigmaz}


@functools.lru_cache(maxsize=None)
def std_matrices(matrix_dim):
    """Matrix-unit basis E_ij of d x d matrices, ordered row-major."""
    d = matrix_dim
    mxs = np.zeros((d * d, d, d), dtype=complex)
    for k, (i, j) in enumerate(itertools.product(range(d), range(d))):
        mxs[k, i, j] = 1.0
    mxs.flags.writeable = False
    return mxs


def std_labels(matrix_dim):
    d = matrix_dim
    return ["(%d,%d)" % (i, j) for i, j in itertools.product(range(d), range(d))]


@functools.lru_cache(maxsize=None)
def pp_matrices(matrix_dim, normalize=True):
    """Normalized Pauli-product basis for d = 2**n: tensor products of
    {I,X,Y,Z}/sqrt(2) with the first qubit's factor varying slowest."""
    d = matrix_dim
    nq = int(round(np.log2(d)))
    if 2 ** nq != d:
        raise ValueError("Pauli-product basis requires power-of-2 dimension, got %d" % d)
    norm = sqrt2 if normalize else 1.0
    basis1q = [_PAULIS[k] / norm for k in ('I', 'X', 'Y', 'Z')]
    mxs = np.empty((4 ** nq, d, d), dtype=complex)
    if nq == 0:
        mxs[0] = np.ones((1, 1), complex)
    for k, factors in enumerate(itertools.product(basis1q, repeat=nq)):
        m = np.ones((1, 1), dtype=complex)
        for f in factors:
            m = np.kron(m, f)
        mxs[k] = m
    mxs.flags.writeable = False
    return mxs


def pp_labels(matrix_dim):
    d = matrix_dim
    nq = int(round(np.log2(d)))
    if nq == 0:
        return [""]
    return ["".join(t) for t in itertools.product('IXYZ', repeat=nq)]


@functools.lru_cache(maxsize=None)
def gm_matrices(matrix_dim, normalize=True):
    """Normalized generalized Gell-Mann basis of d x d matrices.

    Ordering (matching the reference's gm_matrices_unnormalized,
    pygsti/baseobjs/basisconstructors.py:573): identity first, then all
    symmetric (X-like) off-diagonal elements in row-major upper-triangle
    order, then all antisymmetric (Y-like) elements in the same order, then
    the diagonal (Z-like) elements.
    """
    d = matrix_dim
    mxs = [np.identity(d, dtype=complex)]
    for i in range(d):
        for j in range(i + 1, d):
            xm = np.zeros((d, d), dtype=complex)
            xm[i, j] = xm[j, i] = 1.0
            mxs.append(xm)
    for i in range(d):
        for j in range(i + 1, d):
            ym = np.zeros((d, d), dtype=complex)
            ym[i, j] = -1j
            ym[j, i] = 1j
            mxs.append(ym)
    # Z-like (diagonal)
    for k in range(1, d):
        zm = np.zeros((d, d), dtype=complex)
        for i in range(k):
            zm[i, i] = 1.0
        zm[k, k] = -k
        mxs.append(zm * np.sqrt(2.0 / (k * (k + 1))))
    arr = np.stack(mxs)
    if normalize:
        for k in range(arr.shape[0]):
            nrm = np.sqrt(np.real(np.trace(arr[k].conj().T @ arr[k])))
            if nrm > 1e-12:
                arr[k] /= nrm
    arr.flags.writeable = False
    return arr


def gm_labels(matrix_dim):
    d = matrix_dim
    lbls = ["I"]
    for i in range(d):
        for j in range(i + 1, d):
            lbls.append("X_{%d,%d}" % (i, j))
    for i in range(d):
        for j in range(i + 1, d):
            lbls.append("Y_{%d,%d}" % (i, j))
    for k in range(1, d):
        lbls.append("Z_{%d}" % k)
    return lbls


@functools.lru_cache(maxsize=None)
def qt_matrices(matrix_dim):
    """Qutrit basis (d=3): 2-qubit Pauli products projected onto the
    symmetric (triplet) subspace, Gram-Schmidt'ed to Tr(Bi Bj) = delta_ij
    (reference: basisconstructors.qt_matrices:970 -- element-for-element
    identical, so qutrit models/reportables are numerically comparable)."""
    if matrix_dim == 1:
        return np.identity(1, 'd')[None, :, :]
    if matrix_dim != 3:
        raise ValueError("qt basis requires dimension 3")
    # projector onto the symmetric subspace |00>, (|01>+|10>)/sqrt2, |11>
    proj = np.array([[1, 0, 0, 0],
                     [0, 1 / sqrt2, 1 / sqrt2, 0],
                     [0, 0, 0, 1]], 'd')
    pp = pp_matrices(4)
    # pp indices II, XX, YY, YZ, IX, IY, IZ, XY, XZ
    selected = (0, 5, 10, 11, 1, 2, 3, 6, 7)
    mxs = [proj @ pp[i] @ proj.T for i in selected]
    mxs[0] = mxs[0] / np.sqrt(0.75)
    q1 = mxs[1] - mxs[0] * np.sqrt(0.75) / 3
    q2 = mxs[2] - mxs[0] * np.sqrt(0.75) / 3
    mxs[1] = (q1 + q2) / np.sqrt(2.0 / 3.0)
    mxs[2] = (q1 - q2) / sqrt2
    for i in range(3, 9):
        mxs[i] = mxs[i] / np.sqrt(0.5)
    out = np.array(mxs)
    out.flags.writeable = False
    return out


def qt_labels(matrix_dim):
    if matrix_dim == 0:
        return []
    if matrix_dim == 1:
        return ['']
    return ['II', 'X+Y', 'X-Y', 'YZ', 'IX', 'IY', 'IZ', 'XY', 'XZ']


@functools.lru_cache(maxsize=None)
def lf_matrices(matrix_dim):
    """The 'l2p1' leakage basis for a 2+1 level system: Hilbert space splits
    into a 2-dim computational subspace + 1-dim leakage level; basis elements
    separate computational-supported and leakage-supported operator sectors
    (reference: basisconstructors.lf_matrices:728)."""
    if matrix_dim != 3:
        raise NotImplementedError("l2p1 basis requires matrix_dim == 3")
    gm = gm_matrices(3, normalize=True)
    out = np.array([
        np.sqrt(2) / 3 * (np.sqrt(3) * gm[0] + 0.5 * np.sqrt(6) * gm[8]),
        gm[1],            # X_{0,1}
        gm[4],            # Y_{0,1}
        gm[7],            # Z_{1}
        gm[2],            # X_{0,2}
        gm[3],            # X_{1,2}
        gm[5],            # Y_{0,2}
        gm[6],            # Y_{1,2}
        1 / 3 * (np.sqrt(3) * gm[0] - np.sqrt(6) * gm[8]),
    ])
    out.flags.writeable = False
    return out


def lf_labels(matrix_dim):
    if matrix_dim != 3:
        raise NotImplementedError("l2p1 basis requires matrix_dim == 3")
    return ["C[I]", "C[X]", "C[Y]", "C[Z]",
            "L[X_02]", "L[X_12]", "L[Y_02]", "L[Y_12]", "L[I]"]
