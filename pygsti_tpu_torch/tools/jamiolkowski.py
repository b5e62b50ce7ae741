"""Choi <-> superoperator (Jamiolkowski) isomorphism, host numpy
(counterpart of pygsti_tpu/tools/jamiolkowski.py).

The Choi matrix J is the expansion of the std-basis superoperator in the
operator basis {B_i kron B_j^*}: S_std = sum_ij (d * J_ij) B_i kron B_j^*,
so that a CPTP map gives J >= 0 with trace(J) = 1 (when `normalized`).
"""

from __future__ import annotations

import functools

import numpy as np

from pygsti_tpu_torch.baseobjs.basis import Basis
from pygsti_tpu_torch.tools.basistools import change_basis


def _pair_elements(basis):
    """[n, n, d*d, d*d]: B_i kron B_j^* for every pair of basis elements."""
    els = basis.elements
    n, d, _ = els.shape
    return np.einsum('iab,jce->ijacbe', els, els.conj()).reshape(n, n, d * d, d * d)


def _conj_pairs_and_norms(basis):
    """(conj(B_i kron B_j^*), <B_i kron B_j^*, B_i kron B_j^*>) of a basis."""
    conj_pairs = _pair_elements(basis).conj()
    return conj_pairs, np.einsum('ijab,ijab->ij', conj_pairs, conj_pairs.conj()).real


@functools.lru_cache(maxsize=None)
def _named_conj_pairs_and_norms(basis_name, d2):
    """_conj_pairs_and_norms of a basis given by name, made once per (name,
    dimension): a report differences thousands of nearby Choi matrices.
    The arrays are read-only."""
    out = _conj_pairs_and_norms(Basis.cast(basis_name, d2))
    for a in out:
        a.setflags(write=False)
    return out


def jamiolkowski_iso(operation_mx, op_mx_basis='pp', choi_mx_basis='pp', normalized=True):
    """Superoperator -> Choi matrix in `choi_mx_basis`."""
    std = change_basis(np.asarray(operation_mx), op_mx_basis, 'std')
    d2 = std.shape[0]
    conj_pairs, norms = _named_conj_pairs_and_norms(choi_mx_basis, d2) \
        if isinstance(choi_mx_basis, str) else _conj_pairs_and_norms(Basis.cast(choi_mx_basis, d2))
    choi = np.einsum('ijab,ab->ij', conj_pairs, std) / norms
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


def _negative_choi_eigenvalues(gate_mx, mx_basis):
    """The negative eigenvalues of a superoperator's std-basis Choi matrix
    (its Hermitian part)."""
    choi = fast_jamiolkowski_iso_std(gate_mx, mx_basis)
    evals = np.linalg.eigvalsh((choi + choi.conj().T) / 2)
    return evals[evals < 0]


def sums_of_negative_choi_eigenvalues(model):
    """Per operation of `model`, the magnitude of the sum of its Choi
    matrix's negative eigenvalues (0 for a CP operation)."""
    return [-float(np.sum(_negative_choi_eigenvalues(op.dense(), model.basis)))
            for op in model.operations.values()]


def sum_of_negative_choi_eigenvalues(model):
    """The sum over operations of sums_of_negative_choi_eigenvalues."""
    return float(sum(sums_of_negative_choi_eigenvalues(model)))


def sum_of_negative_choi_eigenvalues_gate(gate_mx, mx_basis='pp'):
    """The magnitude of the sum of one superoperator's negative Choi
    eigenvalues (from the general eigensolver, as the JAX package takes
    them)."""
    J = fast_jamiolkowski_iso_std(gate_mx, mx_basis)
    evals = np.linalg.eigvals(J)
    return float(sum(-ev.real for ev in evals if ev.real < 0))


def magnitudes_of_negative_choi_eigenvalues(model, dimensions=None):
    """|negative Choi eigenvalues| of every operation of `model`, in
    operation order (from the general eigensolver, as the JAX package takes
    them)."""
    out = []
    for op in model.operations.values():
        evals = np.linalg.eigvals(fast_jamiolkowski_iso_std(op.dense(), model.basis))
        out.extend(-ev.real for ev in evals if ev.real < 0)
    return out
