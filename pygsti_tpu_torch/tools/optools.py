"""Superoperator conversions, host numpy (counterpart of
pygsti_tpu/tools/optools.py).  Row-major vectorization: the std-basis
superoperator of rho -> U rho U^dag is kron(U, U.conj())."""

from __future__ import annotations

import numpy as np

from pygsti_tpu_torch.tools.basistools import change_basis


def unitary_to_std_process_mx(u):
    """Unitary (d x d) -> superoperator in the std basis (d**2 x d**2)."""
    u = np.asarray(u, dtype=complex)
    return np.kron(u, u.conj())


def unitary_to_superop(u, mx_basis='pp'):
    """Unitary -> superoperator matrix in `mx_basis`."""
    return change_basis(unitary_to_std_process_mx(u), 'std', mx_basis)


def superop_to_unitary(superop, mx_basis='pp', check=True):
    """Invert unitary_to_superop (the superoperator must be a unitary map):
    the Choi matrix of a unitary map has rank one, |u>><<u|.  The phase is
    fixed so that the entry of largest magnitude is real and positive."""
    std = change_basis(np.asarray(superop), mx_basis, 'std')
    d2 = std.shape[0]
    d = int(round(np.sqrt(d2)))
    choi = std.reshape(d, d, d, d).transpose(0, 2, 1, 3).reshape(d2, d2) / d
    evals, evecs = np.linalg.eigh((choi + choi.conj().T) / 2)
    if check and not np.isclose(evals[-1], 1.0, atol=1e-6):
        raise ValueError("Superoperator is not unitary (top Choi eigenvalue %g != 1)"
                         % evals[-1])
    u = evecs[:, -1].reshape(d, d) * np.sqrt(d)
    idx = np.unravel_index(np.argmax(np.abs(u)), u.shape)
    return u / (u[idx] / abs(u[idx]))


def std_process_mx_to_unitary(superop):
    """Unitary of a std-basis process matrix that is a unitary channel."""
    return superop_to_unitary(superop, 'std')


def kraus_decomposition(superop, mx_basis='pp', tol=1e-9):
    """Kraus operators of a CP map from the eigendecomposition of its
    std-basis Choi matrix: each eigenvector with an eigenvalue above `tol`
    unvecs (row-major) to one Kraus operator."""
    from pygsti_tpu_torch.tools.jamiolkowski import fast_jamiolkowski_iso_std
    choi = fast_jamiolkowski_iso_std(superop, mx_basis)
    d2 = choi.shape[0]
    d = int(round(np.sqrt(d2)))
    evals, evecs = np.linalg.eigh((choi + choi.conj().T) / 2)
    return [evecs[:, i].reshape(d, d) * np.sqrt(d * evals[i])
            for i in range(d2 - 1, -1, -1) if evals[i] > tol]
