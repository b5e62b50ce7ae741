"""Elementary error-generator constructors, host numpy, run once when a
Lindblad member is built (counterpart of pygsti_tpu/tools/lindbladtools.py).

The four elementary error generators acting on a density matrix rho
(arXiv:2103.01928):

  H:  L(rho) = -i [p, rho]
  S:  L(rho) = p rho p^dag - (1/2){p^dag p, rho}
  C:  L(rho) = p rho q^dag + q rho p^dag - (1/2){p^dag q + q^dag p, rho}
  A:  L(rho) = i (p rho q^dag - q rho p^dag + (1/2){p^dag q - q^dag p, rho})

Superoperators use the row-major vec convention: vec(A rho B) =
(A kron B^T) vec(rho).
"""

from __future__ import annotations

import numpy as np


def _sandwich(a, b):
    """Superop of rho -> a rho b^dag in the std (row-major vec) basis."""
    return np.kron(a, b.conj())


def _left(a):
    return np.kron(a, np.identity(a.shape[0]))


def _right(a):
    return np.kron(np.identity(a.shape[0]), a.T)


def create_elementary_errorgen(typ, p, q=None):
    """Elementary error generator superoperator in the std basis."""
    p = np.asarray(p, dtype=complex)
    pdag = p.conj().T
    if typ in ('H', 'S'):
        if q is not None:
            raise ValueError("%r-type elementary error generators take one matrix" % typ)
        if typ == 'H':
            return -1j * (_left(p) - _right(p))
        pdp = pdag @ p
        return _sandwich(p, p) - 0.5 * (_left(pdp) + _right(pdp))
    if typ in ('C', 'A'):
        q = np.asarray(q, dtype=complex)
        qdag = q.conj().T
        if typ == 'C':
            anti = pdag @ q + qdag @ p
            return _sandwich(p, q) + _sandwich(q, p) - 0.5 * (_left(anti) + _right(anti))
        anti = pdag @ q - qdag @ p
        return 1j * (_sandwich(p, q) - _sandwich(q, p) + 0.5 * (_left(anti) + _right(anti)))
    raise ValueError("Invalid elementary errorgen type %r" % typ)


def create_lindbladian_term_errorgen(typ, lindblad_term_basis_mx, other_mx=None):
    """Lindblad-term generators in the std basis: 'H' is the elementary H
    generator; 'O' is the general term
    L(rho) = A rho B^dag - (1/2){B^dag A, rho} (B = A when not given)."""
    a = np.asarray(lindblad_term_basis_mx, dtype=complex)
    if typ == 'H':
        return -1j * (_left(a) - _right(a))
    if typ == 'O':
        b = np.asarray(other_mx, dtype=complex) if other_mx is not None else a
        bda = b.conj().T @ a
        return _sandwich(a, b) - 0.5 * (_left(bda) + _right(bda))
    raise ValueError("Invalid lindblad term type %r" % typ)
