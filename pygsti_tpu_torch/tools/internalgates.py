"""Unitaries of the standard gate names (counterpart of
pygsti_tpu/tools/internalgates.py: standard_gatename_unitaries).

Pauli rotations exp(-i theta sigma / 2), the 24 one-qubit Cliffords
Gc0-Gc23 from H/P/X words, and the two-qubit gates the model packs use, with
the JAX package's global-phase conventions, so that every unitary is the same
matrix in both packages.  The continuously parameterized gates (Gzr, Gczr,
Gu3) are not carried over.
"""

from __future__ import annotations

import functools

import numpy as np
import scipy.linalg as spl

sigmaI = np.eye(2, dtype=complex)
sigmaX = np.array([[0, 1], [1, 0]], dtype=complex)
sigmaY = np.array([[0, -1j], [1j, 0]], dtype=complex)
sigmaZ = np.array([[1, 0], [0, -1]], dtype=complex)


def _rot(generator, theta):
    """exp(-i * theta/2 * generator)."""
    return spl.expm(-1j * (theta / 2.0) * generator)


def _phase_canonical(u):
    """u with its global phase fixed: the largest entry of its first row
    made real and positive."""
    row = u[0]
    idx = int(np.argmax(np.abs(row)))
    ph = row[idx] / abs(row[idx]) if abs(row[idx]) > 1e-12 else 1.0
    return u / ph


@functools.lru_cache(maxsize=1)
def standard_gatename_unitaries():
    """Dict of standard gate name -> unitary (complex ndarray)."""
    H = np.array([[1, 1], [1, -1]], dtype=complex) / np.sqrt(2)
    P = np.array([[1, 0], [0, 1j]], dtype=complex)
    Pdag = P.conj().T
    X, Y, Z, I2 = sigmaX, sigmaY, sigmaZ, sigmaI

    u = {'Gi': I2.copy(),
         'Gxpi2': _rot(X, np.pi / 2), 'Gypi2': _rot(Y, np.pi / 2), 'Gzpi2': _rot(Z, np.pi / 2),
         'Gxpi': X.copy(), 'Gypi': Y.copy(), 'Gzpi': Z.copy(),
         'Gxmpi2': _rot(X, -np.pi / 2), 'Gympi2': _rot(Y, -np.pi / 2),
         'Gzmpi2': _rot(Z, -np.pi / 2),
         'Gxpi4': _rot(X, np.pi / 4), 'Gypi4': _rot(Y, np.pi / 4), 'Gzpi4': _rot(Z, np.pi / 4),
         'Gh': H.copy(), 'Gp': P.copy(), 'Gpdag': Pdag.copy(),
         'Gt': np.array([[1, 0], [0, np.exp(1j * np.pi / 4)]], dtype=complex),
         'Gtdag': np.array([[1, 0], [0, np.exp(-1j * np.pi / 4)]], dtype=complex),
         # pi/2 about the (sqrt(3)/2, 0, -1/2) axis
         'Gn': spl.expm(-1j * (np.pi / 4) * ((np.sqrt(3) / 2) * X - 0.5 * Z))}

    # the one-qubit Cliffords, indexed as in the JAX package (up to phase)
    cliff_words = {
        0: [], 1: [H, Pdag], 2: [P, H], 3: [X], 4: [H, Pdag, X], 5: [Pdag, H],
        6: [Y], 7: [H, P, X], 8: [Pdag, X, H], 9: [Z], 10: [H, P],
        11: [P, X, H], 12: [H], 13: [_rot(X, -np.pi / 2)], 14: [P],
        15: [_rot(Y, -np.pi / 2)], 16: [_rot(X, np.pi / 2)], 17: [P, X],
        18: [Y, H], 19: [Pdag, H, P], 20: [Pdag, X], 21: [_rot(Y, np.pi / 2)],
        22: [P, H, Pdag], 23: [Pdag],
    }
    for idx, word in cliff_words.items():
        m = I2.copy()
        for factor in word:
            m = m @ factor
        u['Gc%d' % idx] = _phase_canonical(m)

    u['Gcphase'] = np.diag(np.array([1, 1, 1, -1], dtype=complex))
    u['Gcnot'] = np.array([[1, 0, 0, 0], [0, 1, 0, 0],
                           [0, 0, 0, 1], [0, 0, 1, 0]], dtype=complex)
    u['Gswap'] = np.array([[1, 0, 0, 0], [0, 0, 1, 0],
                           [0, 1, 0, 0], [0, 0, 0, 1]], dtype=complex)
    u['Giswap'] = np.array([[1, 0, 0, 0], [0, 0, 1j, 0],
                            [0, 1j, 0, 0], [0, 0, 0, 1]], dtype=complex)
    s2 = 1 / np.sqrt(2)
    u['Gsqrtiswap'] = np.array([[1, 0, 0, 0], [0, s2, 1j * s2, 0],
                                [0, 1j * s2, s2, 0], [0, 0, 0, 1]], dtype=complex)
    u['Gzz'] = _rot(np.kron(Z, Z), np.pi / 2)
    u['Gxx'] = _rot(np.kron(X, X), np.pi / 2)
    u['Gcres'] = _rot(np.kron(X, Z), np.pi / 2)
    # echoed cross-resonance (IX - XY)/sqrt(2); 'Gecr' is its other name
    u['Gecres'] = (np.kron(I2, X) - np.kron(X, Y)) / np.sqrt(2)
    u['Gecr'] = u['Gecres']
    u['Gx'], u['Gy'], u['Gz'] = u['Gxpi2'], u['Gypi2'], u['Gzpi2']
    # two-qubit products of one-qubit pi/2 rotations (the condensed packs)
    for nm, (a, b) in {'Gxxpi2': ('Gxpi2', 'Gxpi2'), 'Gyypi2': ('Gypi2', 'Gypi2'),
                       'Gxypi2': ('Gxpi2', 'Gypi2'), 'Gyxpi2': ('Gypi2', 'Gxpi2')}.items():
        u[nm] = np.kron(u[a], u[b])
    return u
