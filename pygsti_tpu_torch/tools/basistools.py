"""Basis-change utilities, host numpy (counterpart of
pygsti_tpu/tools/basistools.py)."""

from __future__ import annotations

import numpy as np

from pygsti_tpu_torch.baseobjs.basis import Basis


def change_basis(mx, from_basis, to_basis):
    """Convert a vector (len d**2) or superoperator (d**2 x d**2) between
    operator bases; real bases drop a vanishing imaginary part."""
    mx = np.asarray(mx)
    dim = mx.shape[0]
    fb, tb = Basis.cast(from_basis, dim), Basis.cast(to_basis, dim)
    M = fb.create_transform_matrix(tb)
    out = M @ mx if mx.ndim == 1 else M @ mx @ np.linalg.inv(M)
    if tb.real and np.allclose(out.imag, 0, atol=1e-10):
        out = out.real.copy()
    return out


def stdmx_to_vec(m, basis):
    """Density matrix (d x d) -> vector of components in `basis` (len d**2)."""
    m = np.asarray(m)
    b = Basis.cast(basis, m.shape[0] ** 2)
    v = np.einsum('aij,ij->a', b.elements.conj(), m)
    if b.real and np.allclose(v.imag, 0, atol=1e-10):
        v = v.real.copy()
    return v


def vec_to_stdmx(v, basis):
    """Vector of components in `basis` (len d**2) -> the d x d matrix
    sum_a v_a B_a; a stack of vectors [n, d**2] -> [n, d, d]."""
    v = np.asarray(v)
    b = Basis.cast(basis, v.shape[-1])
    return np.tensordot(v, b.elements, axes=1)
