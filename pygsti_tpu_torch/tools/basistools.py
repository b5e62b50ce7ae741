"""Basis-change utilities, host numpy (counterpart of
pygsti_tpu/tools/basistools.py)."""

from __future__ import annotations

import numpy as np

from pygsti_tpu_torch.baseobjs.basis import Basis, BuiltinBasis, DirectSumBasis


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


def resize_std_mx(mx, resize, std_basis_1, std_basis_2):
    """Embed a superoperator given in a direct-sum std basis into the std
    basis of the whole space ('expand': std_basis_1 is the direct sum,
    std_basis_2 the whole space), or restrict one back ('contract': the
    other way round).  Both bases' elements are matrices of one size; the
    embedding is the direct-sum basis's to-elementstd transform T, with
    T^dag T = I: expand is T mx T^dag, contract T^dag mx T."""
    mx = np.asarray(mx)
    if std_basis_1.elshape != std_basis_2.elshape:
        raise ValueError("the two bases' elements differ in size: %s and %s"
                         % (std_basis_1.elshape, std_basis_2.elshape))
    if std_basis_1.dim == std_basis_2.dim:
        return change_basis(mx, std_basis_1, std_basis_2)
    if resize == 'expand':
        T = std_basis_1.to_elementstd_transform_matrix()
        return T @ mx @ T.conj().T
    if resize == 'contract':
        T = std_basis_2.to_elementstd_transform_matrix()
        return T.conj().T @ mx @ T
    raise ValueError("resize must be 'expand' or 'contract'")


def resize_mx(mx, dim_or_block_dims=None, resize=None):
    """Expand a matrix over the std bases of direct-sum blocks (of Hilbert
    dimensions `dim_or_block_dims`) into the std basis of the whole space,
    or contract one back: resize_std_mx with the direct sum of the blocks'
    std bases.  None leaves `mx` as it is."""
    if dim_or_block_dims is None:
        return mx
    if isinstance(dim_or_block_dims, int):
        dim_or_block_dims = (dim_or_block_dims,)
    blocks = DirectSumBasis([BuiltinBasis('std', d * d) for d in dim_or_block_dims])
    whole = BuiltinBasis('std', blocks.matrix_dim ** 2)
    if resize == 'expand':
        return resize_std_mx(mx, 'expand', blocks, whole)
    if resize == 'contract':
        return resize_std_mx(mx, 'contract', whole, blocks)
    raise ValueError("resize must be 'expand' or 'contract'")
