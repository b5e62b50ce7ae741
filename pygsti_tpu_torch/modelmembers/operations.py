"""Operation parameterizations as pure torch functions (counterpart of
pygsti_tpu/modelmembers/operations.py).

The dense families (static ops, FullArbitraryOp, FullTPOp) carry a gauge
transform.  The unitary and Lindblad families (FullUnitaryOp, ComposedOp,
LindbladErrorgen and its coefficient blocks, ExpErrorgenOp, FullCPTPOp) do
not: as in the JAX package, transforming one raises NotImplementedError.
The members implicit models are built from -- RepeatedOp, EmbeddedOp,
DepolarizeOp, StochasticNoiseOp, IdentityPlusErrorgenOp, CPTRop -- have no
gauge transform in the JAX package either, nor do the eigenvalue-, linearly
and affinely parameterized EigenvalueParamDenseOp, LinearlyParamArbitraryOp
and AffineShiftOp.  The unitary members (static and
full unitary, and an EmbeddedOp of one) also give ``to_unitary(v)``, the
state-vector simulator's input.
Every member serializes; a Lindblad member writes its structure (basis,
block types, modes, labels) and parameter values, and its generators are
rebuilt on reading.

Members keep their constants as host numpy and serve them to ``to_dense`` as
tensors on the device and dtype of the parameter vector, cached per member.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import scipy.linalg
import torch

from pygsti_tpu_torch.baseobjs.basis import Basis
from pygsti_tpu_torch.baseobjs.errorgenlabel import (GlobalElementaryErrorgenLabel,
                                                     LocalElementaryErrorgenLabel)
from pygsti_tpu_torch.baseobjs.nicelyserializable import NicelySerializable
from pygsti_tpu_torch.modelmembers.modelmember import ModelMember
from pygsti_tpu_torch.tools import jamiolkowski as _jam
from pygsti_tpu_torch.tools import lindbladtools as _lt
from pygsti_tpu_torch.tools import optools as _ot
from pygsti_tpu_torch.tools.basistools import change_basis


def _complex_dtype(dtype):
    return torch.complex128 if dtype == torch.float64 else torch.complex64


def _matrix_exp(a):
    """exp(a) for a square real or complex tensor, as exp(a + I) / e.

    torch.linalg.matrix_exp picks its polynomial by the 1-norm of its
    argument, and the one it takes for float64 norms between 3.4e-4 and
    5e-2 is off by up to 1e-11 absolute (measured against scipy on torch
    2.13; at every other norm it agrees to 1e-15).  Error generators of a
    model near its target have exactly such norms.  exp(a + I) = e exp(a)
    holds exactly because I commutes with a, and moves the argument to norms
    of about 1, where the routine is accurate; the division costs one
    rounding."""
    eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)
    return torch.linalg.matrix_exp(a + eye) * math.exp(-1.0)


class _TensorConstants(object):
    """Serves numpy attributes as tensors, cached per (attribute, device,
    dtype).  The cache stays out of copies, pickles and serialized states."""

    def _const(self, name, device, dtype):
        cache = self.__dict__.setdefault('_tensor_cache', {})
        key = (name, str(device), dtype)
        if key not in cache:
            cache[key] = torch.as_tensor(getattr(self, name), dtype=dtype, device=device)
        return cache[key]

    def __getstate__(self):
        state = dict(self.__dict__)
        state.pop('_tensor_cache', None)
        return state


class Embedding(object):
    """Embeds matrices acting on some factors of a state space into the
    whole space, as the identity on the other factors: kron(mat, I_rest)
    with its factor axes put back in the state space's order.  Superoperator
    factors have dimension udim^2, unitary ones udim.  Works on torch
    tensors [..., a, a] (the leading dimensions batched) and on numpy."""

    def __init__(self, state_space, target_labels, unitary=False):
        labels = list(state_space.tensor_product_block_labels)
        fdims = [d if unitary else d * d for d in state_space.tensor_product_block_dims]
        tgt_pos = [labels.index(t) for t in target_labels]
        other_pos = [i for i in range(len(labels)) if i not in tgt_pos]
        src_order = tgt_pos + other_pos
        nf = len(labels)
        inv = [0] * nf
        for newpos, srcpos in enumerate(src_order):
            inv[srcpos] = newpos
        self.trivial = src_order == list(range(nf))
        self.rest_dim = int(np.prod([fdims[i] for i in other_pos], dtype=np.int64))
        self.src_dims = [fdims[i] for i in src_order]
        self.axes = inv + [p + nf for p in inv]
        self.dim = int(np.prod(fdims, dtype=np.int64))

    def __call__(self, mat):
        if self.trivial and self.rest_dim == 1:
            return mat
        if isinstance(mat, np.ndarray):
            full = np.kron(mat, np.eye(self.rest_dim))
            return np.transpose(full.reshape(self.src_dims * 2), self.axes).reshape(
                self.dim, self.dim)
        lead = mat.shape[:-2]
        a = mat.shape[-1]
        eye = torch.eye(self.rest_dim, dtype=mat.dtype, device=mat.device)
        # kron(mat, I)[i r + k, j r + l] = mat[i, j] I[k, l]
        full = mat[..., :, None, :, None] * eye.reshape(self.rest_dim, 1, self.rest_dim)
        full = full.reshape(*lead, *(self.src_dims * 2))
        nl = len(lead)
        full = full.permute(*range(nl), *(nl + p for p in self.axes))
        return full.reshape(*lead, self.dim, self.dim)


class LinearOperator(ModelMember):
    """Base class for operations; dense rep is a (dim, dim) superop matrix."""

    def __init__(self, dim, initial_paramvals=None):
        super().__init__(initial_paramvals)
        self._dim = dim


class StaticArbitraryOp(LinearOperator):
    """A fixed (0-parameter) superoperator matrix."""

    def __init__(self, mx):
        mx = np.asarray(mx, dtype=float)
        super().__init__(mx.shape[0], np.empty(0))
        self._mx = mx

    def to_dense(self, v):
        return torch.as_tensor(self._mx, dtype=v.dtype, device=v.device)

    def dense(self):
        return self._mx.copy()

    def transform_inplace(self, s, sinv):
        self._mx = sinv @ self._mx @ s

    def _to_nice_serialization(self):
        return {'mx': self._mx}

    @classmethod
    def _from_nice_serialization(cls, state):
        # the static subclasses serialize as their dense matrix
        return StaticArbitraryOp(np.asarray(state['mx']))


class StaticUnitaryOp(StaticArbitraryOp):
    """A fixed superoperator built from a unitary."""

    def __init__(self, unitary, basis='pp', superop=None):
        self.unitary = np.asarray(unitary, dtype=complex)
        super().__init__(np.real(_ot.unitary_to_superop(self.unitary, basis))
                         if superop is None else superop)

    def to_unitary(self, v):
        """The complex unitary, on v's device."""
        return torch.as_tensor(self.unitary, dtype=_complex_dtype(v.dtype), device=v.device)


class StaticStandardOp(StaticUnitaryOp):
    """A fixed superoperator for a named standard gate."""

    def __init__(self, name, basis='pp'):
        from pygsti_tpu_torch.tools.internalgates import standard_gatename_unitaries
        self.name = name
        super().__init__(standard_gatename_unitaries()[name], basis)


class FullArbitraryOp(LinearOperator):
    """Every matrix element is a parameter (row-major)."""

    def __init__(self, mx):
        mx = np.asarray(mx, dtype=float)
        super().__init__(mx.shape[0], mx.reshape(-1).copy())

    def to_dense(self, v):
        return v.reshape(self._dim, self._dim)

    def _to_nice_serialization(self):
        return {'mx': self.dense()}

    @classmethod
    def _from_nice_serialization(cls, state):
        return cls(np.asarray(state['mx']))

    def transform_inplace(self, s, sinv):
        d = self._dim
        self._paramvals = (sinv @ self._paramvals.reshape(d, d) @ s).reshape(-1)


class FullTPOp(LinearOperator):
    """Trace-preserving superop: first row fixed to [1,0,...,0]; the other
    rows are parameters (row-major)."""

    def __init__(self, mx):
        mx = np.asarray(mx, dtype=float)
        d = mx.shape[0]
        if not np.allclose(mx[0], np.eye(d)[0], atol=1e-8):
            raise ValueError("Initial matrix is not trace-preserving "
                             "(first row != e0)")
        super().__init__(d, mx[1:, :].reshape(-1).copy())

    def to_dense(self, v):
        d = self._dim
        first_row = torch.zeros((1, d), dtype=v.dtype, device=v.device)
        first_row[0, 0] = 1.0
        return torch.cat([first_row, v.reshape(d - 1, d)], dim=0)

    def _to_nice_serialization(self):
        return {'mx': self.dense()}

    @classmethod
    def _from_nice_serialization(cls, state):
        return cls(np.asarray(state['mx']))

    def transform_inplace(self, s, sinv):
        d = self._dim
        mx = sinv @ self.dense() @ s
        assert np.allclose(mx[0], np.eye(d)[0], atol=1e-6), "Gauge transform broke TP"
        mx[0] = np.eye(d)[0]  # clean numerical noise
        self._paramvals = mx[1:, :].reshape(-1)


def _real_params_to_hermitian(v, d):
    """Real vector (d*d: the diagonal, then (re, im) of the upper triangle
    row by row) -> Hermitian complex [d, d] tensor on v's device."""
    ctype = torch.complex128 if v.dtype == torch.float64 else torch.complex64
    iu = torch.triu_indices(d, d, offset=1, device=v.device)
    upper = torch.complex(v[d::2], v[d + 1::2]).to(ctype)
    h = torch.zeros((d, d), dtype=ctype, device=v.device)
    h = h.index_put((iu[0], iu[1]), upper)
    h = h + h.conj().T
    return h + torch.diag(v[:d].to(ctype))


def _hermitian_to_real_params(h):
    """Hermitian [d, d] -> real vector (d*d): the diagonal, then (re, im) of
    the upper triangle row by row; inverse of _real_params_to_hermitian."""
    d = h.shape[0]
    iu = np.triu_indices(d, 1)
    upper = np.asarray(h)[iu]
    return np.concatenate([np.real(np.diag(h)),
                           np.stack([upper.real, upper.imag], axis=1).reshape(-1)])


def _lower_tri_to_params(L):
    """Lower-triangular [n, n] -> real vector (n*n): the real diagonal, then
    (re, im) of the strict lower triangle row by row."""
    il = np.tril_indices(L.shape[0], -1)
    lower = np.asarray(L)[il]
    return np.concatenate([np.real(np.diag(L)),
                           np.stack([lower.real, lower.imag], axis=1).reshape(-1)])


def _params_to_lower_tri(v, n):
    """Inverse of _lower_tri_to_params: complex [n, n] tensor on v's device."""
    il = torch.tril_indices(n, n, offset=-1, device=v.device)
    lower = torch.complex(v[n::2], v[n + 1::2])
    L = torch.zeros((n, n), dtype=lower.dtype, device=v.device)
    L = L.index_put((il[0], il[1]), lower)
    return L + torch.diag_embed(v[:n]).to(lower.dtype)


class FullUnitaryOp(_TensorConstants, LinearOperator):
    """Superoperator constrained to be unitary: parameterized by a Hermitian
    generator H via U = expm(-iH).  The parameters are H's diagonal, then
    (re, im) of its upper triangle."""

    def __init__(self, unitary, basis='pp'):
        u = np.asarray(unitary, dtype=complex)
        self.udim = u.shape[0]
        h = 1j * scipy.linalg.logm(u)
        super().__init__(self.udim ** 2, _hermitian_to_real_params((h + h.conj().T) / 2))
        b = Basis.cast(basis, self.udim ** 2)
        self.basis = b.name
        M = b.create_transform_matrix('std')
        self._std2basis = np.linalg.inv(M)
        self._basis2std = np.asarray(M)

    def to_unitary(self, v):
        """The complex unitary expm(-iH)."""
        return _matrix_exp(-1j * _real_params_to_hermitian(v, self.udim))

    def to_dense(self, v):
        u = self.to_unitary(v)
        s_std = torch.kron(u, u.conj())
        out = self._const('_std2basis', v.device, u.dtype) @ s_std \
            @ self._const('_basis2std', v.device, u.dtype)
        return out.real

    def _to_nice_serialization(self):
        return {'udim': self.udim, 'basis': self.basis, 'paramvals': self.to_vector()}

    @classmethod
    def _from_nice_serialization(cls, state):
        op = cls(np.eye(state['udim']), state['basis'])
        op.from_vector(state['paramvals'])
        return op


class _WrapsOneMember(object):
    """A member whose parameters are those of one inner member
    (``self._inner``), which also answers the errorgen-coefficient API."""

    @property
    def num_params(self):
        return self._inner.num_params

    def to_vector(self):
        return self._inner.to_vector()

    def from_vector(self, v):
        self._inner.from_vector(v)

    def errorgen_coefficient_labels(self):
        return self._inner.errorgen_coefficient_labels()

    def errorgen_coefficients(self):
        return self._inner.errorgen_coefficients()

    def set_errorgen_coefficients(self, coeff_dict, truncate=False):
        self._inner.set_errorgen_coefficients(coeff_dict, truncate)


class ComposedOp(LinearOperator):
    """Composition of factor operations applied left to right in circuit
    order: dense = F_{n-1} @ ... @ F_1 @ F_0.  Its parameters are the
    factors' in order."""

    def __init__(self, factors):
        self.factors = list(factors)
        super().__init__(self.factors[0].dim, np.empty(0))

    @property
    def num_params(self):
        return sum(f.num_params for f in self.factors)

    def to_vector(self):
        return np.concatenate([f.to_vector() for f in self.factors])

    def from_vector(self, v):
        off = 0
        for f in self.factors:
            f.from_vector(v[off:off + f.num_params])
            off += f.num_params

    def to_dense(self, v):
        mx, off = None, 0
        for f in self.factors:
            fm = f.to_dense(v[off:off + f.num_params])
            mx = fm if mx is None else fm @ mx
            off += f.num_params
        return mx

    def error_map_form(self):
        """(the one parameterized factor, product of the static factors
        before it, product of those after it) when exactly one factor has
        parameters and is an error map."""
        live = [i for i, f in enumerate(self.factors) if f.num_params > 0]
        if len(live) != 1 or not hasattr(self.factors[live[0]], 'same_function_as'):
            return None

        def product(factors):
            mx = None
            for f in factors:
                mx = f.dense() if mx is None else f.dense() @ mx
            return mx
        i = live[0]
        return self.factors[i], product(self.factors[:i]), product(self.factors[i + 1:])

    def _errorgen_factors(self):
        return [f for f in self.factors if hasattr(f, 'errorgen_coefficient_labels')]

    def errorgen_coefficient_labels(self):
        return [l for f in self._errorgen_factors() for l in f.errorgen_coefficient_labels()]

    def errorgen_coefficients(self):
        out = {}
        for f in self._errorgen_factors():
            out.update(f.errorgen_coefficients())
        return out

    def set_errorgen_coefficients(self, coeff_dict, truncate=False):
        for f in self._errorgen_factors():
            f.set_errorgen_coefficients(coeff_dict, truncate)

    def _to_nice_serialization(self):
        return {'factors': [f.to_nice_serialization() for f in self.factors]}

    @classmethod
    def _from_nice_serialization(cls, state):
        return cls([NicelySerializable.from_nice_serialization(s) for s in state['factors']])


class LindbladCoefficientBlock(_TensorConstants):
    """One block of Lindblad coefficients with its generators.

    block_type 'ham': real coefficients of the H-type generators.
    'other_diag': diagonal S-type coefficients; param_mode 'elements' (free,
    may go negative) or 'cholesky' (coefficient = parameter squared >= 0;
    the parameter 0 is a stationary point of every objective, so a fit
    started there keeps that coefficient at 0).
    'other': the full block M_ij; 'elements' (Hermitian M: its diagonal, then
    (re, im) of the upper triangle) or 'cholesky' (M = L L^dag, positive
    semidefinite: L's real diagonal, then (re, im) of its strict lower
    triangle).

    `generators` is [n, dim, dim] for 'ham'/'other_diag' (real up to
    rounding: an imaginary part is refused here once, not dropped on every
    call) and complex [n, n, dim, dim] for 'other'."""

    def __init__(self, block_type, basis_element_labels, generators, param_mode='elements',
                 initial_coeffs=None):
        self.block_type = block_type
        self.basis_element_labels = list(basis_element_labels)
        self.param_mode = param_mode
        n = self._n = len(self.basis_element_labels)
        gens = np.asarray(generators)
        self._dim = gens.shape[-1]
        if block_type in ('ham', 'other_diag'):
            if np.iscomplexobj(gens):
                if np.max(np.abs(gens.imag), initial=0.0) > 1e-12:
                    raise ValueError("%r generators must be real in the model's basis"
                                     % block_type)
                gens = gens.real
            self._gens = np.array(gens.reshape(n, -1), dtype=float)
            coeffs = np.zeros(n) if initial_coeffs is None else np.asarray(initial_coeffs, float)
            if param_mode == 'cholesky' and block_type == 'other_diag':
                self.initial_params = np.sqrt(np.clip(coeffs, 0, None))
            else:
                self.initial_params = coeffs.copy()
        elif block_type == 'other':
            # real(sum_ij M_ij G_ij) = sum re(M) re(G) - im(M) im(G): one real
            # product with the stacked [2 n^2, dim^2] generators
            flat = gens.reshape(n * n, -1)
            self._gens = np.concatenate([flat.real, -flat.imag])
            M = np.zeros((n, n), dtype=complex) if initial_coeffs is None \
                else np.asarray(initial_coeffs, complex)
            if param_mode == 'cholesky':
                # the shift keeps L's diagonal off exact zero (1e-7 for M = 0),
                # where d(L L^dag)/dL vanishes and no fit could leave
                try:
                    L = np.linalg.cholesky(M + 1e-14 * np.eye(n))
                except np.linalg.LinAlgError:
                    raise ValueError("the initial 'other' block is not positive "
                                     "semidefinite: it has no Cholesky factor")
                self.initial_params = _lower_tri_to_params(L)
            else:
                self.initial_params = _hermitian_to_real_params(M)
        else:
            raise ValueError("Invalid block type %r" % block_type)

    @property
    def num_params(self):
        return self._n if self.block_type in ('ham', 'other_diag') else self._n * self._n

    def coefficient_matrix(self, v):
        """Coefficients as a tensor: real [n] for 'ham'/'other_diag', complex
        Hermitian [n, n] for 'other'."""
        if self.block_type == 'ham':
            return v
        if self.block_type == 'other_diag':
            return v * v if self.param_mode == 'cholesky' else v
        if self.param_mode == 'cholesky':
            L = _params_to_lower_tri(v, self._n)
            return L @ L.mH
        return _real_params_to_hermitian(v, self._n)

    def errorgen(self, v):
        """This block's part of the error generator, real [dim, dim]."""
        coeffs = self.coefficient_matrix(v)
        if self.block_type == 'other':
            coeffs = torch.cat([coeffs.real.reshape(-1), coeffs.imag.reshape(-1)])
        gens = self._const('_gens', v.device, v.dtype)
        return (coeffs.to(v.dtype) @ gens).reshape(self._dim, self._dim)

    def coefficients(self, v):
        """{('H', label) | ('S', label) | ('O', label_i, label_j): value} at
        the host parameter values `v`."""
        cm = self.coefficient_matrix(torch.as_tensor(np.asarray(v, dtype=float))).numpy()
        lbls = self.basis_element_labels
        if self.block_type in ('ham', 'other_diag'):
            typ = 'H' if self.block_type == 'ham' else 'S'
            return {(typ, l): float(c) for l, c in zip(lbls, cm)}
        return {('O', li, lj): complex(cm[i, j])
                for i, li in enumerate(lbls) for j, lj in enumerate(lbls)}


# products of single-qubit Paulis: _PAULI_PRODUCT[a, b] = (c, phase) with
# sigma_a sigma_b = phase sigma_c, indices 0..3 for I, X, Y, Z
_PAULI_PRODUCT = [[(0, 1), (1, 1), (2, 1), (3, 1)],
                  [(1, 1), (0, 1), (3, 1j), (2, -1j)],
                  [(2, 1), (3, -1j), (0, 1), (1, 1j)],
                  [(3, 1), (2, 1j), (1, -1j), (0, 1)]]


def _pauli_generators(dim, block_type, labels):
    """The 'ham' or 'other_diag' generators of Pauli-product elements in the
    'pp' basis, from the Pauli algebra instead of a change of basis (which
    costs three dense d^2 x d^2 products per generator: seconds at five
    qubits).  With B = P / sqrt(u) the normalized elements, u = 2^n, and
    P_j P_l = w P_m: H_j maps B_l to -2i w / sqrt(u) B_m where P_j and P_l
    anticommute (w = +-i), to 0 where they commute; S_j maps B_l to
    -2/u B_l where they anticommute, else to 0."""
    n = int(round(np.log(dim) / np.log(4)))
    u = 2 ** n
    letters = {'I': 0, 'X': 1, 'Y': 2, 'Z': 3}
    digits = np.array([[(l // 4 ** (n - 1 - q)) % 4 for q in range(n)] for l in range(dim)])
    prod_idx = np.array([[c for c, _ in row] for row in _PAULI_PRODUCT])
    prod_phase = np.array([[w for _, w in row] for row in _PAULI_PRODUCT])
    gens = np.zeros((len(labels), dim, dim))
    cols = np.arange(dim)
    for g, lbl in enumerate(labels):
        j = np.array([letters[ch] for ch in lbl])
        phase = np.prod(prod_phase[j[None, :], digits], axis=1)        # [dim]
        m = (prod_idx[j[None, :], digits] * 4 ** np.arange(n - 1, -1, -1)).sum(axis=1)
        anti = np.abs(phase.real) < 0.5                                # w = +-i
        if block_type == 'ham':
            gens[g, m[anti], cols[anti]] = (-2j * phase[anti] / np.sqrt(u)).real
        else:
            gens[g, cols[anti], cols[anti]] = -2.0 / u
    return gens


@functools.lru_cache(maxsize=None)
def _block_generators(basis_name, dim, block_type, labels):
    """Generators of one block over the basis elements named `labels`, in
    the model's basis; shared (read-only) by every member that asks."""
    if basis_name == 'pp' and block_type in ('ham', 'other_diag'):
        gens = _pauli_generators(dim, block_type, labels)
        gens.flags.writeable = False
        return gens
    b = Basis(basis_name, dim)
    all_labels = b.labels
    els = [b.elements[all_labels.index(l)] for l in labels]

    def in_basis(std_gen):
        return change_basis(std_gen, 'std', b)

    if block_type in ('ham', 'other_diag'):
        typ = 'H' if block_type == 'ham' else 'S'
        gens = np.stack([in_basis(_lt.create_elementary_errorgen(typ, e)) for e in els])
    else:
        n = len(els)
        gens = np.empty((n, n, dim, dim), dtype=complex)
        for a, ea in enumerate(els):
            for c, ec in enumerate(els):
                gens[a, c] = in_basis(_lt.create_lindbladian_term_errorgen('O', ea, ec))
    gens.flags.writeable = False
    return gens


class LindbladErrorgen(ModelMember):
    """Lindblad error generator: the sum of its coefficient blocks' parts
    ('ham', then 'other_diag', then 'other', each a
    LindbladCoefficientBlock).  Its parameters are the blocks' in order."""

    def __init__(self, dim, blocks, basis='pp'):
        self.blocks = list(blocks)
        self._dim = dim
        self.basis = Basis.cast(basis, dim).name
        super().__init__(np.concatenate([b.initial_params for b in self.blocks])
                         if self.blocks else np.empty(0))

    def _block_slices(self):
        off = 0
        for b in self.blocks:
            yield b, slice(off, off + b.num_params)
            off += b.num_params

    def to_dense(self, v):
        out = torch.zeros((self._dim, self._dim), dtype=v.dtype, device=v.device)
        for b, sl in self._block_slices():
            out = out + b.errorgen(v[sl])
        return out

    def coefficients(self):
        """{(type, basis label(s)): coefficient} at the current parameters."""
        out = {}
        for b, sl in self._block_slices():
            out.update(b.coefficients(self._paramvals[sl]))
        return out

    def errorgen_coefficient_labels(self):
        """LocalElementaryErrorgenLabels of the 'ham' and 'other_diag'
        blocks; an 'other' block's coefficients have no elementary label."""
        types = {'ham': 'H', 'other_diag': 'S'}
        return [LocalElementaryErrorgenLabel(types[b.block_type], (str(l),))
                for b in self.blocks if b.block_type in types
                for l in b.basis_element_labels]

    def errorgen_coefficients(self):
        return {LocalElementaryErrorgenLabel(typ, tuple(str(b) for b in bels)): val
                for (typ, *bels), val in self.coefficients().items() if typ in ('H', 'S')}

    def set_errorgen_coefficients(self, coeff_dict, truncate=False):
        """Set H and S coefficients from {label: value}; labels may be
        local, global or (type, basis label) tuples.  A 'cholesky'
        'other_diag' block stores sqrt(value): a negative value raises
        ValueError unless `truncate`, which clips it to 0."""
        n_qubits = int(round(np.log2(np.sqrt(self._dim))))
        lookup = {}
        for lbl, val in coeff_dict.items():
            if isinstance(lbl, GlobalElementaryErrorgenLabel):
                lbl = LocalElementaryErrorgenLabel.cast(lbl, tuple(range(n_qubits)))
            elif not isinstance(lbl, LocalElementaryErrorgenLabel):
                lbl = LocalElementaryErrorgenLabel(
                    lbl[0], tuple(lbl[1:]) if len(lbl) > 2 else (lbl[1],))
            lookup[(lbl.errorgen_type, lbl.basis_element_labels[0])] = val
        pv = self._paramvals.copy()
        for b, sl in self._block_slices():
            if b.block_type not in ('ham', 'other_diag'):
                continue
            typ = 'H' if b.block_type == 'ham' else 'S'
            cur = b.coefficients(pv[sl])
            new = np.array([lookup.get((typ, str(l)), cur[(typ, l)])
                            for l in b.basis_element_labels], float)
            if b.block_type == 'other_diag' and b.param_mode == 'cholesky':
                if not truncate and np.any(new < -1e-12):
                    raise ValueError("Negative S coefficient in CPTP-constrained block")
                new = np.sqrt(np.clip(new, 0, None))
            pv[sl] = new
        self.from_vector(pv)

    def _to_nice_serialization(self):
        return {'dim': self._dim, 'basis': self.basis, 'paramvals': self.to_vector(),
                'blocks': [{'block_type': b.block_type, 'param_mode': b.param_mode,
                            'basis_element_labels': list(b.basis_element_labels)}
                           for b in self.blocks]}

    @classmethod
    def _from_nice_serialization(cls, state):
        blocks = [LindbladCoefficientBlock(
            s['block_type'], s['basis_element_labels'],
            _block_generators(state['basis'], state['dim'], s['block_type'],
                              tuple(s['basis_element_labels'])), s['param_mode'])
            for s in state['blocks']]
        eg = cls(state['dim'], blocks, state['basis'])
        eg.from_vector(state['paramvals'])
        return eg


def build_lindblad_errorgen(basis, parameterization='GLND', dim=None, initial_coeffs=None,
                            max_weight=None):
    """A LindbladErrorgen over all non-identity elements of `basis`.

    parameterization: 'H' (Hamiltonian only), 'H+S' / 'H+s' (plus diagonal
    stochastic; capital S = constrained >= 0), 'S' / 's' (stochastic only),
    'GLND' (Hamiltonian plus the full Hermitian block, unconstrained),
    'CPTPLND' (Hamiltonian plus the full block as a Cholesky factor: CPTP).
    `max_weight` keeps the basis elements of Pauli weight <= max_weight.
    `initial_coeffs`: {('H' | 'S', label): value}."""
    b = basis if isinstance(basis, Basis) else Basis.cast(basis, dim)
    lbls = b.labels[1:]
    if max_weight is not None:
        lbls = [l for l in lbls if sum(ch != 'I' for ch in l) <= max_weight]
    lbls = tuple(lbls)
    init = initial_coeffs or {}
    if parameterization not in ('H', 'H+S', 'H+s', 'S', 's', 'GLND', 'CPTPLND'):
        raise ValueError("Unknown Lindblad parameterization %r" % parameterization)

    def gens(block_type):
        return _block_generators(b.name, b.dim, block_type, lbls)

    blocks = []
    if parameterization in ('H', 'H+S', 'H+s', 'GLND', 'CPTPLND'):
        blocks.append(LindbladCoefficientBlock(
            'ham', lbls, gens('ham'), 'elements',
            np.array([init.get(('H', l), 0.0) for l in lbls])))
    if parameterization in ('H+S', 'H+s', 'S', 's'):
        blocks.append(LindbladCoefficientBlock(
            'other_diag', lbls, gens('other_diag'),
            'cholesky' if 'S' in parameterization else 'elements',
            np.array([init.get(('S', l), 0.0) for l in lbls])))
    if parameterization in ('GLND', 'CPTPLND'):
        M0 = np.diag([complex(init.get(('S', l), 0.0)) for l in lbls])
        blocks.append(LindbladCoefficientBlock(
            'other', lbls, gens('other'),
            'cholesky' if parameterization == 'CPTPLND' else 'elements', M0))
    return LindbladErrorgen(b.dim, blocks, b)


class ExpErrorgenOp(_WrapsOneMember, LinearOperator):
    """exp(L) for an error generator L."""

    def __init__(self, errorgen):
        self.errorgen = self._inner = errorgen
        super().__init__(errorgen.dim, np.empty(0))

    def to_dense(self, v):
        return _matrix_exp(self.errorgen.to_dense(v))

    def error_map_form(self):
        return self, None, None

    def same_function_as(self, other):
        """Whether `other` maps a parameter vector to the same dense matrix:
        the same class, blocks, modes and generators."""
        def blocks(m):
            return [(b.block_type, b.param_mode, b._gens.shape) for b in m.errorgen.blocks]
        return type(other) is type(self) and blocks(other) == blocks(self) and all(
            np.array_equal(a._gens, b._gens)
            for a, b in zip(self.errorgen.blocks, other.errorgen.blocks))

    def _to_nice_serialization(self):
        return {'errorgen': self.errorgen.to_nice_serialization()}

    @classmethod
    def _from_nice_serialization(cls, state):
        return cls(NicelySerializable.from_nice_serialization(state['errorgen']))


class LinearTimeDriftOp(LinearOperator):
    """A time-dependent operation G(t) = exp(t L) G_base, with L the dense
    form of a drift error generator.  Its parameters are the base
    operation's, then the generator's.  ``to_dense(v)`` is G(0) = G_base;
    ``to_dense_t(v, t)`` is G(t), through _matrix_exp (the drift rates put
    t L at exactly the 1-norms where torch.linalg.matrix_exp errs)."""

    def __init__(self, base_op, drift_errorgen):
        self.base_op = base_op
        self.drift_errorgen = drift_errorgen
        super().__init__(base_op.dim, np.empty(0))

    @property
    def num_params(self):
        return self.base_op.num_params + self.drift_errorgen.num_params

    def to_vector(self):
        return np.concatenate([self.base_op.to_vector(), self.drift_errorgen.to_vector()])

    def from_vector(self, v):
        nb = self.base_op.num_params
        self.base_op.from_vector(v[:nb])
        self.drift_errorgen.from_vector(v[nb:])

    def to_dense(self, v):
        return self.base_op.to_dense(v[:self.base_op.num_params])

    def to_dense_t(self, v, t):
        nb = self.base_op.num_params
        L = self.drift_errorgen.to_dense(v[nb:])
        return _matrix_exp(t * L) @ self.base_op.to_dense(v[:nb])

    def _to_nice_serialization(self):
        return {'base_op': self.base_op.to_nice_serialization(),
                'drift_errorgen': self.drift_errorgen.to_nice_serialization()}

    @classmethod
    def _from_nice_serialization(cls, state):
        return cls(NicelySerializable.from_nice_serialization(state['base_op']),
                   NicelySerializable.from_nice_serialization(state['drift_errorgen']))


class EigenvalueParamDenseOp(_TensorConstants, LinearOperator):
    """A real operation parameterized by its eigenvalues only: the matrix is
    eigendecomposed once, its eigenvector frame B frozen, and dense =
    Re(B diag(evals) B^-1).  One parameter per real eigenvalue, (re, im)
    per complex-conjugate pair, in the order numpy's eig gives them; with
    tp_constrained_and_unital=True the unit eigenvalue whose eigenvector is
    closest to [1, 0, ...] is held fixed (its eigenvector set to that unit
    vector)."""

    def __init__(self, matrix, include_off_diags_in_degen_blocks=False,
                 tp_constrained_and_unital=False):
        mx = np.asarray(matrix)
        if np.linalg.norm(np.imag(mx)) >= 1e-7:
            raise ValueError("EigenvalueParamDenseOp needs a real matrix")
        mx = np.real(mx).astype(float)
        d = mx.shape[0]
        evals, B = np.linalg.eig(mx)
        used = np.zeros(len(evals), bool)
        real_idx, pair_idx = [], []
        for i, ev in enumerate(evals):
            if used[i]:
                continue
            if abs(ev.imag) < 1e-10:
                real_idx.append(i)
                used[i] = True
                continue
            partner = [k for k in range(i + 1, len(evals))
                       if not used[k] and abs(evals[k] - np.conj(ev)) < 1e-8]
            if not partner:
                raise ValueError("complex eigenvalue without its conjugate")
            pair_idx.append((i, partner[0]))
            used[i] = used[partner[0]] = True
        fixed_idx = None
        if tp_constrained_and_unital:
            unit_row = np.zeros(d)
            unit_row[0] = 1.0
            if not (np.allclose(mx[0, :], unit_row) and np.allclose(mx[:, 0], unit_row)):
                raise ValueError("matrix must be TP and unital")
            cands = [i for i in real_idx if abs(evals[i] - 1.0) < 1e-8]
            if not cands:
                raise ValueError("a TP-constrained matrix must have a unit eigenvalue")
            fixed_idx = max(cands, key=lambda i: abs(B[0, i]))
            B[:, fixed_idx] = unit_row
            real_idx = [i for i in real_idx if i != fixed_idx]
        params = [evals[i].real for i in real_idx]
        for i, _ in pair_idx:
            params.extend([evals[i].real, evals[i].imag])
        super().__init__(d, np.asarray(params, float))
        self._B = B.astype(complex)
        self._Binv = np.linalg.inv(B).astype(complex)
        self._real_idx = list(real_idx)
        self._pair_idx = [tuple(p) for p in pair_idx]
        self._fixed_idx = fixed_idx
        self._fixed_val = complex(evals[fixed_idx]) if fixed_idx is not None else None

    def to_dense(self, v):
        cdt = _complex_dtype(v.dtype)
        evals = [None] * self._dim
        if self._fixed_idx is not None:
            evals[self._fixed_idx] = torch.tensor(self._fixed_val, dtype=cdt, device=v.device)
        nr = len(self._real_idx)
        for k, i in enumerate(self._real_idx):
            evals[i] = v[k].to(cdt)
        for k, (i, j) in enumerate(self._pair_idx):
            lam = torch.complex(v[nr + 2 * k], v[nr + 2 * k + 1])
            evals[i], evals[j] = lam, lam.conj()
        B, Binv = self._const('_B', v.device, cdt), self._const('_Binv', v.device, cdt)
        return torch.real(B @ (torch.stack(evals)[:, None] * Binv))

    def _to_nice_serialization(self):
        return {'B': self._B, 'real_idx': self._real_idx,
                'pair_idx': [list(p) for p in self._pair_idx], 'fixed_idx': self._fixed_idx,
                'fixed_val': None if self._fixed_val is None
                else [self._fixed_val.real, self._fixed_val.imag],
                'paramvals': self._paramvals}

    @classmethod
    def _from_nice_serialization(cls, state):
        op = cls.__new__(cls)
        LinearOperator.__init__(op, len(state['B']), np.asarray(state['paramvals'], float))
        op._B = np.asarray(state['B'], complex)
        op._Binv = np.linalg.inv(op._B)
        op._real_idx = [int(i) for i in state['real_idx']]
        op._pair_idx = [tuple(int(i) for i in p) for p in state['pair_idx']]
        op._fixed_idx = state['fixed_idx']
        fv = state['fixed_val']
        op._fixed_val = None if fv is None else complex(fv[0], fv[1])
        return op


class LinearlyParamArbitraryOp(_TensorConstants, LinearOperator):
    """A matrix whose elements are linear in the parameters:
    dense = left @ (base + sum_p v[p] M_p) @ right, M_p holding ones at the
    coordinates `parameter_to_base_indices_map[p]`; the real part when
    real=True."""

    def __init__(self, base_matrix, parameter_array, parameter_to_base_indices_map,
                 left_transform=None, right_transform=None, real=True):
        base = np.asarray(base_matrix, complex)
        d = base.shape[0]
        masks = np.zeros((len(parameter_array), d, d), complex)
        for p, ij_tuples in parameter_to_base_indices_map.items():
            for (i, j) in ij_tuples:
                masks[p, i, j] = 1.0
        super().__init__(d, np.asarray(parameter_array, float))
        self._base = base
        self._masks = masks
        self._left = np.asarray(left_transform if left_transform is not None else np.eye(d),
                                complex)
        self._right = np.asarray(right_transform if right_transform is not None else np.eye(d),
                                 complex)
        self._real = bool(real)

    def to_dense(self, v):
        cdt = _complex_dtype(v.dtype)
        c = lambda name: self._const(name, v.device, cdt)  # noqa: E731
        mx = c('_base') + torch.tensordot(v.to(cdt), c('_masks'), dims=1)
        out = c('_left') @ mx @ c('_right')
        return torch.real(out) if self._real else out

    def _to_nice_serialization(self):
        index_map = {str(p): [[int(i), int(j)] for i, j in zip(*np.nonzero(self._masks[p]))]
                     for p in range(len(self._masks))}
        return {'base': self._base, 'paramvals': self._paramvals, 'index_map': index_map,
                'left': self._left, 'right': self._right, 'real': self._real}

    @classmethod
    def _from_nice_serialization(cls, state):
        index_map = {int(p): [tuple(ij) for ij in ijs] for p, ijs in state['index_map'].items()}
        return cls(np.asarray(state['base']), np.asarray(state['paramvals']), index_map,
                   np.asarray(state['left']), np.asarray(state['right']), state['real'])


class AffineShiftOp(LinearOperator):
    """The identity plus an affine shift: ones on the diagonal, the
    parameters in column 0 below the diagonal (rows 1..d-1), zeros
    elsewhere."""

    def __init__(self, m):
        mx = np.asarray(m, float)
        self._check_arrowhead(mx)
        super().__init__(mx.shape[0], mx[1:, 0].copy())

    @staticmethod
    def _check_arrowhead(mx):
        d = mx.shape[0]
        if not (np.allclose(np.diag(mx), 1) and np.allclose((mx - np.eye(d))[:, 1:], 0.0)):
            raise ValueError("AffineShiftOp requires arrowhead structure "
                             "(unit diagonal, off-diagonals only in column 0)")

    def to_dense(self, v):
        d = self._dim
        eye = torch.eye(d, dtype=v.dtype, device=v.device)
        col = torch.cat([torch.zeros(1, dtype=v.dtype, device=v.device), v])
        first = torch.zeros(d, dtype=v.dtype, device=v.device)
        first[0] = 1.0
        return eye + col[:, None] * first[None, :]

    def set_dense(self, m):
        mx = np.asarray(m, float)
        self._check_arrowhead(mx)
        self._paramvals = mx[1:, 0].copy()

    def _to_nice_serialization(self):
        return {'mx': self.dense()}

    @classmethod
    def _from_nice_serialization(cls, state):
        return cls(np.asarray(state['mx']))


class FullCPTPOp(_TensorConstants, LinearOperator):
    """Channel parameterized by the Cholesky factor of its trace-normalized
    Choi matrix: the parameters are L's real diagonal, then (re, im) of its
    strict lower triangle, and the dense superoperator is the inverse
    Jamiolkowski image of L L^dag / tr(L L^dag).  Completely positive with a
    Choi matrix of trace one at every parameter value (as in the JAX
    package, that normalizes the trace and does not enforce trace
    preservation row by row)."""

    def __init__(self, choi_mx, basis='pp', truncate=False):
        choi = np.asarray(choi_mx, complex)
        d = choi.shape[0]
        trc = np.trace(choi).real
        if not np.isclose(trc, 1.0):
            if not truncate:
                raise ValueError("choi_mx must have trace 1 (or truncate=True)")
            choi = choi - np.eye(d) / d * (trc - 1.0)
        evals, U = np.linalg.eigh((choi + choi.conj().T) / 2)
        if not (truncate or np.all(evals >= -1e-12)):
            raise ValueError("choi_mx must be positive semidefinite (or truncate=True)")
        choi = (U * evals.clip(1e-16, None)) @ U.conj().T
        super().__init__(d, _lower_tri_to_params(np.linalg.cholesky(choi)))
        b = Basis.cast(basis, d)
        self.basis_name = b.name
        # the linear map choi (flat) -> superoperator (flat)
        units = np.eye(d * d).reshape(d * d, d, d)
        self._jam_inv = np.stack([_jam.jamiolkowski_iso_inv(e, b, b).reshape(-1)
                                  for e in units], axis=1)

    @classmethod
    def from_superop_matrix(cls, superop_mx, basis='pp', truncate=False):
        b = Basis.cast(basis, np.asarray(superop_mx).shape[0])
        return cls(_jam.jamiolkowski_iso(superop_mx, b, b), b, truncate)

    def to_dense(self, v):
        d = self._dim
        L = _params_to_lower_tri(v, d)
        choi = L @ L.mH
        choi = choi / torch.trace(choi)
        out = self._const('_jam_inv', v.device, choi.dtype) @ choi.reshape(-1)
        return out.reshape(d, d).real

    @property
    def kraus_operators(self):
        """Kraus operators of the channel at the current parameters."""
        return _ot.kraus_decomposition(self.dense(), self.basis_name)

    def _to_nice_serialization(self):
        return {'dim': self._dim, 'basis': self.basis_name, 'paramvals': self.to_vector()}

    @classmethod
    def _from_nice_serialization(cls, state):
        d = state['dim']
        op = cls(np.eye(d) / d, state['basis'])
        op.from_vector(state['paramvals'])
        return op


class RepeatedOp(_WrapsOneMember, LinearOperator):
    """op^k: the dense form of `op` multiplied by itself `num_copies`
    times.  Its parameters are op's."""

    def __init__(self, op, num_copies):
        self.repeated_op = self._inner = op
        self.num_copies = int(num_copies)
        super().__init__(op.dim, np.empty(0))

    def to_dense(self, v):
        return torch.linalg.matrix_power(self.repeated_op.to_dense(v), self.num_copies)

    def _to_nice_serialization(self):
        return {'repeated_op': self.repeated_op.to_nice_serialization(),
                'num_copies': self.num_copies}

    @classmethod
    def _from_nice_serialization(cls, state):
        return cls(NicelySerializable.from_nice_serialization(state['repeated_op']),
                   state['num_copies'])


class EmbeddedOp(_WrapsOneMember, LinearOperator):
    """An operation on some factors of a state space (`target_labels`),
    embedded into the whole space as the identity on the others.  Its
    parameters are the embedded op's."""

    def __init__(self, state_space, target_labels, op_to_embed):
        from pygsti_tpu_torch.baseobjs.statespace import StateSpace
        self.state_space = StateSpace.cast(state_space)
        self.target_labels = tuple(target_labels)
        self.embedded_op = self._inner = op_to_embed
        self._embedding = Embedding(self.state_space, self.target_labels)
        super().__init__(self.state_space.dim, np.empty(0))

    def to_dense(self, v):
        return self._embedding(self.embedded_op.to_dense(v))

    def to_unitary(self, v):
        """The embedded op's unitary on the whole Hilbert space (the op must
        have one)."""
        emb = Embedding(self.state_space, self.target_labels, unitary=True)
        return emb(self.embedded_op.to_unitary(v))

    def _to_nice_serialization(self):
        ss = self.state_space
        return {'state_space_labels': list(ss.tensor_product_block_labels),
                'state_space_udims': list(ss.tensor_product_block_dims),
                'target_labels': list(self.target_labels),
                'embedded_op': self.embedded_op.to_nice_serialization()}

    @classmethod
    def _from_nice_serialization(cls, state):
        from pygsti_tpu_torch.baseobjs.statespace import QuditSpace
        ss = QuditSpace(state['state_space_labels'], state['state_space_udims'])
        return cls(ss, state['target_labels'],
                   NicelySerializable.from_nice_serialization(state['embedded_op']))


class DepolarizeOp(LinearOperator):
    """Depolarizing channel of one rate: diag(1, w, ..., w), w = 1 - rate,
    in any basis whose first element is the identity.  param_mode 'depol'
    takes the rate as the parameter squared (>= 0); any other mode takes
    the parameter itself."""

    def __init__(self, dim, initial_rate=0.0, param_mode='depol'):
        self.param_mode = param_mode
        p0 = np.sqrt(initial_rate) if param_mode == 'depol' else initial_rate
        super().__init__(dim, np.array([p0], dtype=float))

    def to_dense(self, v):
        rate = v[0] * v[0] if self.param_mode == 'depol' else v[0]
        diag = torch.cat([torch.ones(1, dtype=v.dtype, device=v.device),
                          (1.0 - rate) * torch.ones(self._dim - 1, dtype=v.dtype,
                                                    device=v.device)])
        return torch.diag(diag)

    def _to_nice_serialization(self):
        return {'dim': self._dim, 'param_mode': self.param_mode, 'paramvals': self.to_vector()}

    @classmethod
    def _from_nice_serialization(cls, state):
        op = cls(state['dim'], 0.0, state['param_mode'])
        op.from_vector(state['paramvals'])
        return op


class StochasticNoiseOp(_TensorConstants, LinearOperator):
    """Pauli-stochastic channel rho -> (1 - sum r) rho + sum_i r_i P_i rho
    P_i over the non-identity elements of `basis`; the rates are the
    parameters squared, so the channel stays CPTP for sum r <= 1."""

    def __init__(self, dim, basis='pp', initial_rates=None):
        b = Basis.cast(basis, dim)
        els = b.elements
        n = els.shape[0] - 1
        rates = np.zeros(n) if initial_rates is None else np.asarray(initial_rates, float)
        super().__init__(dim, np.sqrt(np.clip(rates, 0, None)))
        self.basis = b.name
        u = els.shape[1]
        self._unit_super = np.stack([
            np.real(change_basis(np.kron(els[i] * np.sqrt(u), (els[i] * np.sqrt(u)).conj()),
                                 'std', b)) for i in range(1, n + 1)])

    def to_dense(self, v):
        rates = v * v
        eye = torch.eye(self._dim, dtype=v.dtype, device=v.device)
        return (1.0 - rates.sum()) * eye + torch.tensordot(
            rates, self._const('_unit_super', v.device, v.dtype), dims=1)

    def _to_nice_serialization(self):
        return {'dim': self._dim, 'basis': self.basis, 'paramvals': self.to_vector()}

    @classmethod
    def _from_nice_serialization(cls, state):
        op = cls(state['dim'], state['basis'])
        op.from_vector(state['paramvals'])
        return op


class IdentityPlusErrorgenOp(_WrapsOneMember, LinearOperator):
    """I + L: the first-order expansion of exp(L), CPTP whenever L is a
    valid Lindbladian."""

    def __init__(self, errorgen):
        self.errorgen = self._inner = errorgen
        super().__init__(errorgen.dim, np.empty(0))

    def to_dense(self, v):
        return torch.eye(self._dim, dtype=v.dtype, device=v.device) + self.errorgen.to_dense(v)

    def _to_nice_serialization(self):
        return {'errorgen': self.errorgen.to_nice_serialization()}

    @classmethod
    def _from_nice_serialization(cls, state):
        return cls(NicelySerializable.from_nice_serialization(state['errorgen']))


class CPTRop(_TensorConstants, LinearOperator):
    """A completely positive, trace-reducing map (leakage, loss): the
    parameters are the Cholesky factor L of an unnormalized Choi matrix (its
    real diagonal, then (re, im) of its strict lower triangle), and the
    dense form is the inverse Jamiolkowski image of L L^dag, scaled down to
    trace 1 only where its trace exceeds 1."""

    def __init__(self, superop_mx, basis='pp', truncate=True):
        m = np.asarray(superop_mx, float)
        d = m.shape[0]
        b = Basis.cast(basis, d)
        choi = _jam.jamiolkowski_iso(m, b, b)
        evals, U = np.linalg.eigh((choi + choi.conj().T) / 2)
        if not (truncate or evals.min() > -1e-10):
            raise ValueError("superop must be completely positive (or truncate=True)")
        choi = (U * evals.clip(1e-16, None)) @ U.conj().T
        L = np.linalg.cholesky(choi + 1e-14 * np.eye(d))
        super().__init__(d, _lower_tri_to_params(L))
        self.basis_name = b.name
        units = np.eye(d * d).reshape(d * d, d, d)
        self._jam_inv = np.stack([_jam.jamiolkowski_iso_inv(e, b, b).reshape(-1)
                                  for e in units], axis=1)

    def to_dense(self, v):
        d = self._dim
        L = _params_to_lower_tri(v, d)
        choi = L @ L.mH
        tr = torch.trace(choi).real
        choi = choi * torch.where(tr > 1.0, 1.0 / tr, torch.ones_like(tr))
        out = self._const('_jam_inv', v.device, choi.dtype) @ choi.reshape(-1)
        return out.reshape(d, d).real

    def _to_nice_serialization(self):
        return {'dim': self._dim, 'basis': self.basis_name, 'paramvals': self.to_vector()}

    @classmethod
    def _from_nice_serialization(cls, state):
        op = cls(np.eye(state['dim']), state['basis'])
        op.from_vector(state['paramvals'])
        return op
