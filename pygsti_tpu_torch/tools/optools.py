"""Superoperator conversions and gate/state metrics, host numpy
(counterpart of pygsti_tpu/tools/optools.py).  Row-major vectorization: the
std-basis superoperator of rho -> U rho U^dag is kron(U, U.conj())."""

from __future__ import annotations

import numpy as np
import scipy.linalg as spl

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


def decompose_gate_matrix(op_mx):
    """A gate matrix's eigenvalues, whether it is unitary, its rotation
    angle in units of pi (the largest eigenvalue phase), the mean decay of
    its eigenvalues and, for one qubit, the axis of rotation [0, nx, ny, nz]
    (the +1 eigenvector of its unital block)."""
    m = np.asarray(op_mx)
    evals = np.linalg.eigvals(m)
    mags = np.abs(evals)
    out = {'isValid': True, 'eigenvalues': evals,
           'isUnitary': bool(np.allclose(mags, 1.0, atol=1e-6)),
           'pi rotations': float(np.max(np.abs(np.angle(evals))) / np.pi),
           'decay of diagonal rotation terms': float(1.0 - np.mean(mags))}
    if m.shape[0] == 4:
        evals_r, evecs_r = np.linalg.eig(np.real(m[1:, 1:]))
        axis = np.real(evecs_r[:, int(np.argmin(np.abs(evals_r - 1.0)))])
        nrm = np.linalg.norm(axis)
        if nrm > 1e-12:
            axis = axis / nrm
        out['axis of rotation'] = np.concatenate([[0.0], axis])
    return out


# -- metrics -------------------------------------------------------------------

def fidelity(a, b):
    """State fidelity (Tr sqrt(sqrt(a) b sqrt(a)))^2 of two density
    matrices; where one of them has rank one it is <psi|other|psi>."""
    a = np.asarray(a, dtype=complex)
    b = np.asarray(b, dtype=complex)
    for x, y in ((a, b), (b, a)):
        evals = np.linalg.eigvalsh((x + x.conj().T) / 2)
        if np.isclose(np.max(evals), 1.0, atol=1e-6) and np.isclose(np.sum(evals), 1.0,
                                                                    atol=1e-6):
            psi = np.linalg.eigh((x + x.conj().T) / 2)[1][:, -1]
            return float(np.real(psi.conj() @ y @ psi))
    sqrt_a = spl.sqrtm(a)
    evals = np.linalg.eigvals(sqrt_a @ b @ sqrt_a)
    return float(np.real(np.sum(np.sqrt(np.clip(np.real(evals), 0, None))) ** 2))


def frobeniusdist(a, b):
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b)))


def frobeniusdist_squared(a, b):
    return frobeniusdist(a, b) ** 2


def tracenorm(m):
    """The sum of the singular values."""
    return float(np.sum(np.linalg.svd(np.asarray(m), compute_uv=False)))


def tracedist(a, b):
    """0.5 * ||a - b||_1."""
    return 0.5 * tracenorm(np.asarray(a) - np.asarray(b))


def jtracedist(a, b, mx_basis='pp'):
    """The trace distance of the two superoperators' Choi matrices."""
    from pygsti_tpu_torch.tools.jamiolkowski import jamiolkowski_iso
    return tracedist(jamiolkowski_iso(a, mx_basis), jamiolkowski_iso(b, mx_basis))


def entanglement_fidelity(a, b, mx_basis='pp'):
    """The fidelity of the two superoperators' Choi matrices."""
    from pygsti_tpu_torch.tools.jamiolkowski import jamiolkowski_iso
    return fidelity(jamiolkowski_iso(a, mx_basis), jamiolkowski_iso(b, mx_basis))


def process_fidelity(a, b, mx_basis='pp'):
    return entanglement_fidelity(a, b, mx_basis)


def entanglement_infidelity(a, b, mx_basis='pp'):
    return 1.0 - entanglement_fidelity(a, b, mx_basis)


def average_gate_fidelity(a, b, mx_basis='pp'):
    """(d F_e + 1) / (d + 1)."""
    d = int(round(np.sqrt(np.asarray(a).shape[0])))
    return float((d * entanglement_fidelity(a, b, mx_basis) + 1) / (d + 1))


def average_gate_infidelity(a, b, mx_basis='pp'):
    return 1.0 - average_gate_fidelity(a, b, mx_basis)


def unitarity(a, mx_basis='pp'):
    """Tr(E_u^dag E_u) / (d^2 - 1) of the unital block E_u in the 'gm'
    basis."""
    b = change_basis(np.asarray(a), mx_basis, 'gm')
    unital = b[1:, 1:]
    return float(np.real(np.trace(unital.conj().T @ unital)) / (b.shape[0] - 1))


def diamonddist(a, b, mx_basis='pp', return_x=False):
    """||a - b||_diamond, maximized over pure inputs on the doubled space
    (tools/sdptools.diamond_norm_distance)."""
    from pygsti_tpu_torch.tools import sdptools
    return sdptools.diamond_norm_distance(a, b, mx_basis)
