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


def create_basis_pair(mx_or_dim, from_basis, to_basis):
    """The two bases cast for a matrix (or superoperator dimension)."""
    dim = mx_or_dim if isinstance(mx_or_dim, int) else np.asarray(mx_or_dim).shape[0]
    return Basis.cast(from_basis, dim), Basis.cast(to_basis, dim)


def basis_matrices(name_or_basis, dim):
    """The element matrices of a basis (ndarray [size, d, d])."""
    return Basis.cast(name_or_basis, dim).elements


def basis_longname(basis):
    """The long name of a builtin basis ('pp' -> 'Pauli-Product')."""
    names = {'std': 'Matrix-unit', 'pp': 'Pauli-Product',
             'PP': 'Pauli-Product (unnormalized)', 'gm': 'Gell-Mann', 'qt': 'Qutrit'}
    name = basis if isinstance(basis, str) else basis.name
    return names.get(name, name)


def stdmx_to_ppvec(m):
    return stdmx_to_vec(m, 'pp')


def stdmx_to_gmvec(m):
    return stdmx_to_vec(m, 'gm')


def stdmx_to_stdvec(m):
    return stdmx_to_vec(m, 'std')


def ppvec_to_stdmx(v):
    return vec_to_stdmx(v, 'pp')


def gmvec_to_stdmx(v):
    return vec_to_stdmx(v, 'gm')


def stdvec_to_stdmx(v):
    return vec_to_stdmx(v, 'std')


def basis_element_labels(basis, dim):
    """The labels of the elements of `basis`."""
    return tuple(Basis.cast(basis, dim).labels)


def create_basis_for_matrix(mx, basis):
    """`basis` as a Basis sized for the superoperator `mx`."""
    return Basis.cast(basis, np.asarray(mx).shape[0])


def state_to_stdmx(state_vec):
    """A pure state's density matrix |psi><psi|."""
    v = np.asarray(state_vec).reshape(-1, 1)
    return v @ v.conj().T


def state_to_pauli_density_vec(state_vec):
    """A pure state's density matrix as a 'pp' vector."""
    return stdmx_to_vec(state_to_stdmx(state_vec), 'pp')


def flexible_change_basis(mx, start_basis, end_basis):
    """change_basis between bases that may span spaces of different
    dimension, such as a direct sum of blocks and the whole space: the
    superoperator goes through the std basis of the larger bases' matrices,
    where the smaller basis embeds through its to-elementstd transform T
    (expand: T mx T^+, contract: T^+ mx T).  The JAX package pads the std
    matrix with zeros there, which mixes the indices of matrices of two
    sizes (ROADMAP.md section 3)."""
    mx = np.asarray(mx)
    sb, eb = Basis.cast(start_basis, mx.shape[0]), Basis.cast(end_basis, mx.shape[0])
    if sb.dim == eb.dim:
        return change_basis(mx, sb, eb)
    if sb.elshape != eb.elshape:
        raise ValueError("the two bases' elements differ in size: %s and %s"
                         % (sb.elshape, eb.elshape))
    whole = BuiltinBasis('std', sb.matrix_dim ** 2)
    if sb.dim < eb.dim:
        T = sb.to_elementstd_transform_matrix()
        return change_basis(T @ mx @ np.linalg.pinv(T), whole, eb)
    T = eb.to_elementstd_transform_matrix()
    return np.linalg.pinv(T) @ change_basis(mx, sb, whole) @ T


def is_sparse_basis(name_or_basis):
    """Whether a basis uses sparse matrices: none of the port's does."""
    return bool(getattr(name_or_basis, 'sparse', False))


def is_cvxpy_expression(obj):
    """Whether `obj` is a cvxpy expression; False where cvxpy is absent."""
    try:
        import cvxpy
    except ImportError:
        return False
    return isinstance(obj, cvxpy.expressions.expression.Expression)
