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
