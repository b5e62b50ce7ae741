"""Choi <-> superoperator (Jamiolkowski) isomorphism, host numpy
(counterpart of pygsti_tpu/tools/jamiolkowski.py).

The Choi matrix J is the expansion of the std-basis superoperator in the
operator basis {B_i kron B_j^*}: S_std = sum_ij (d * J_ij) B_i kron B_j^*,
so that a CPTP map gives J >= 0 with trace(J) = 1 (when `normalized`).
"""

from __future__ import annotations

import numpy as np

from pygsti_tpu_torch.baseobjs.basis import Basis
from pygsti_tpu_torch.tools.basistools import change_basis


def _pair_elements(basis):
    """[n, n, d*d, d*d]: B_i kron B_j^* for every pair of basis elements."""
    els = basis.elements
    n, d, _ = els.shape
    return np.einsum('iab,jce->ijacbe', els, els.conj()).reshape(n, n, d * d, d * d)


def jamiolkowski_iso(operation_mx, op_mx_basis='pp', choi_mx_basis='pp', normalized=True):
    """Superoperator -> Choi matrix in `choi_mx_basis`."""
    std = change_basis(np.asarray(operation_mx), op_mx_basis, 'std')
    d2 = std.shape[0]
    pairs = _pair_elements(Basis.cast(choi_mx_basis, d2))
    norms = np.einsum('ijab,ijab->ij', pairs.conj(), pairs).real
    choi = np.einsum('ijab,ab->ij', pairs.conj(), std) / norms
    if normalized:
        choi = choi / int(round(np.sqrt(d2)))
    return choi


def jamiolkowski_iso_inv(choi_mx, choi_mx_basis='pp', op_mx_basis='pp', normalized=True):
    """Inverse of jamiolkowski_iso."""
    choi = np.asarray(choi_mx)
    d2 = choi.shape[0]
    scale = int(round(np.sqrt(d2))) if normalized else 1.0
    pairs = _pair_elements(Basis.cast(choi_mx_basis, d2))
    std = scale * np.einsum('ij,ijab->ab', choi, pairs)
    return change_basis(std, 'std', op_mx_basis)


def fast_jamiolkowski_iso_std(operation_mx, op_mx_basis='pp'):
    """Superoperator -> Choi matrix in the *std* basis (trace-normalized)."""
    std = change_basis(np.asarray(operation_mx), op_mx_basis, 'std')
    d2 = std.shape[0]
    d = int(round(np.sqrt(d2)))
    return std.reshape(d, d, d, d).transpose(0, 2, 1, 3).reshape(d2, d2) / d


def fast_jamiolkowski_iso_std_inv(choi_mx, op_mx_basis='pp'):
    """Inverse of fast_jamiolkowski_iso_std: a std-basis Choi matrix ->
    the superoperator in `op_mx_basis`."""
    choi = np.asarray(choi_mx)
    d2 = choi.shape[0]
    d = int(round(np.sqrt(d2)))
    std = choi.reshape(d, d, d, d).transpose(0, 2, 1, 3).reshape(d2, d2) * d
    return change_basis(std, 'std', op_mx_basis)
